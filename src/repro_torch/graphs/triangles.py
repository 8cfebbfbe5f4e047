"""Triangle counting via wedge sampling.  Port of
:mod:`repro.graphs.triangles`.

SAMPLE() draws a uniformly random wedge u–v–w (centre v with probability ∝
d_v(d_v−1)/2, then two distinct neighbour slots) and tests whether the
closing edge {u, w} exists.  Each triangle closes 3 of the W wedges, so
T̂ = p̂·W/3.

Frame layout: ``frame.num`` — wedges sampled; ``frame.data`` — (n_pad,)
int32 closed-wedge counts by centre vertex.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.frames import StateFrame
from .csr import Graph


def wedge_weights(g: Graph) -> Tuple[np.ndarray, float]:
    """Per-vertex wedge counts d_v(d_v−1)/2 and their total W."""
    indptr = g.indptr.cpu().numpy()
    deg = (indptr[1:] - indptr[:-1]).astype(np.float64)
    w = deg * (deg - 1.0) / 2.0
    return w, float(w.sum())


def triangles_exact(g: Graph) -> float:
    """Exact triangle count via trace(A³)/6 — test oracle (small graphs)."""
    a = np.zeros((g.n, g.n), dtype=np.int64)
    a[g.src.cpu().numpy(), g.dst.cpu().numpy()] = 1
    return float(np.trace(a @ a @ a)) / 6.0


def _below(r: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """A uniform integer in [0, k) per lane from uniforms r in [0, 1)."""
    return torch.minimum((r * k).floor().long(), k - 1)


def make_wedge_sample_fn(g: Graph, batch: int, *,
                         pad_to: Optional[int] = None):
    """Build SAMPLE(): ``sample_fn(gens, carry)`` draws ``batch`` wedges for
    each of the ``len(gens)`` workers.  Worker w draws its three (batch,)
    uniform vectors (centre, first slot, second slot) from ``gens[w]``."""
    n, dev = g.n, g.device
    n_pad = pad_to or n
    w, w_total = wedge_weights(g)
    assert w_total > 0, "graph has no wedges (max degree < 2)"
    cum = torch.from_numpy(np.cumsum(w).astype(np.float32)).to(dev)

    def sample_fn(gens, carry):
        W = len(gens)
        r = torch.stack([torch.rand((3, batch), generator=gen, device=dev)
                         for gen in gens]).transpose(0, 1).reshape(3, -1)
        # centre v ∝ d_v(d_v−1)/2 by inverse CDF, drawn against the f32
        # cumsum's own total (a draw past cum[-1] would land anywhere).
        u = r[0] * cum[-1]
        v = torch.searchsorted(cum, u, right=True).clamp(max=n - 1)
        d = g.degree(v).long()
        # an unordered pair of distinct neighbour slots, uniform
        i = _below(r[1], d.clamp(min=1))
        j0 = _below(r[2], (d - 1).clamp(min=1))
        j = j0 + (j0 >= i).long()
        nbrs = g.neighbors_padded(v)
        a = nbrs.gather(1, i[:, None]).squeeze(1)
        b = nbrs.gather(1, j[:, None]).squeeze(1)
        # b ∈ N(a)?  The guards keep the sentinel slot (id n) from ever
        # reporting a closed wedge.
        a_nbrs = g.neighbors_padded(a.clamp(max=n - 1))
        closed = (b < n) & (a < n) & (a_nbrs == b[:, None]).any(dim=1)
        worker = torch.arange(W, device=dev).repeat_interleave(batch)
        counts = torch.zeros(W * n_pad, dtype=torch.int32, device=dev)
        counts.index_add_(0, worker * n_pad + v, closed.to(torch.int32))
        num = torch.full((W,), batch, dtype=torch.int32, device=dev)
        return StateFrame(num=num, data=counts.view(W, n_pad)), carry

    return sample_fn


def triangle_estimate(counts: np.ndarray, num: float, w_total: float) -> float:
    """T̂ = p̂·W/3 from accumulated closed-wedge counts."""
    p_hat = float(np.sum(counts)) / max(float(num), 1.0)
    return p_hat * w_total / 3.0
