"""Graph-diameter estimation via double-sweep BFS.  Port of
:mod:`repro.graphs.diameter`.

One sample picks a vertex v uniformly, sweeps a BFS from it for ecc(v) and
the farthest vertex u = argmax dist(v,·), then sweeps from u for ecc(u).
Each sample gives the bounds ecc(u) ≤ diam ≤ 2·ecc(v), and a gap
certificate when 2·ecc(v) − ecc(u) ≤ gap.  Both sweeps are the port's
batched ``bfs_sssp`` (one ``bfs_frontier`` launch per level for all lanes).

Frame layout: ``frame.num`` — double sweeps; ``frame.data`` — {"cert":
int32 scalar — gap certificates, "ecc_hist": (L_pad,) int32 histogram of
the observed ecc(u), L = n+1 bins}.  The estimate is the largest occupied
bin, a statistic that survives the frames' elementwise ``+``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.frames import StateFrame
from .bfs import INF, bfs_sssp
from .csr import Graph


def diameter_exact(g: Graph) -> int:
    """Exact diameter by BFS from every vertex (numpy, test oracle).
    Unreachable pairs are ignored."""
    n = g.n
    indptr = g.indptr.cpu().numpy()
    nbrs = g.indices_padded.cpu().numpy()[: int(g.m_arcs)]
    best = 0
    for s in range(n):
        dist = np.full(n, -1, np.int64)
        dist[s] = 0
        frontier = [s]
        while frontier:
            nxt = []
            for v in frontier:
                for w in nbrs[indptr[v]:indptr[v + 1]]:
                    if dist[w] < 0:
                        dist[w] = dist[v] + 1
                        nxt.append(int(w))
            frontier = nxt
        best = max(best, int(dist.max()))
    return best


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """Per row, the first index of the maximum (as ``jnp.argmax``)."""
    idx = torch.arange(x.shape[1], device=x.device)
    hit = x == x.amax(dim=1, keepdim=True)
    return torch.where(hit, idx, x.shape[1]).amin(dim=1)


def double_sweep(g: Graph, v: torch.Tensor, *, max_levels: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Double sweeps from the B vertices ``v`` → (ecc(v), ecc(u)), each
    (B,) int32, with u = the first argmax of dist(v,·)."""
    dev = g.device
    dist_v, _ = bfs_sssp(g, v, None, max_levels=max_levels, early_exit=False,
                         device=dev)
    fin_v = torch.where(dist_v == INF, -1, dist_v)
    u = _first_argmax(fin_v)
    ecc_v = fin_v.amax(dim=1).clamp(min=0)
    dist_u, _ = bfs_sssp(g, u, None, max_levels=max_levels, early_exit=False,
                         device=dev)
    ecc_u = torch.where(dist_u == INF, 0, dist_u).amax(dim=1)
    return ecc_v.to(torch.int32), ecc_u.to(torch.int32)


def make_sweep_sample_fn(g: Graph, batch: int, *, gap: int = 0,
                         pad_to: Optional[int] = None):
    """Build SAMPLE(): ``sample_fn(gens, carry)`` runs ``batch`` double
    sweeps for each of the ``len(gens)`` workers, all W·batch lanes in one
    batched BFS; worker w's start vertices come from ``gens[w]``."""
    n, dev = g.n, g.device
    bins_pad = pad_to or (n + 1)

    def sample_fn(gens, carry):
        W = len(gens)
        v = torch.cat([torch.randint(0, n, (batch,), generator=gen, device=dev)
                       for gen in gens])
        ecc_v, ecc_u = double_sweep(g, v, max_levels=n)
        cert = (2 * ecc_v - ecc_u <= gap).to(torch.int32).view(W, batch)
        worker = torch.arange(W, device=dev).repeat_interleave(batch)
        hist = torch.zeros(W * bins_pad, dtype=torch.int32, device=dev)
        hist.index_add_(0, worker * bins_pad + ecc_u.long(),
                        torch.ones_like(ecc_u))
        data = {"cert": cert.sum(dim=1, dtype=torch.int32),
                "ecc_hist": hist.view(W, bins_pad)}
        num = torch.full((W,), batch, dtype=torch.int32, device=dev)
        return StateFrame(num=num, data=data), carry

    return sample_fn


def frame_template(g: Graph, pad_to: Optional[int] = None):
    bins_pad = pad_to or (g.n + 1)
    return {"cert": torch.zeros((), dtype=torch.int32, device=g.device),
            "ecc_hist": torch.zeros((bins_pad,), dtype=torch.int32,
                                    device=g.device)}


def diameter_estimate(ecc_hist: np.ndarray) -> float:
    """Best lower bound seen: max occupied bin of the ecc(u) histogram."""
    occupied = np.nonzero(np.asarray(ecc_hist) > 0)[0]
    return float(occupied.max()) if occupied.size else 0.0
