"""Monte-Carlo s–t reachability under edge percolation.  Port of
:mod:`repro.graphs.reachability`.

Each undirected edge survives independently with probability π; one sample
draws a percolated subgraph and reports whether ``t`` is reachable from
``s``.  The reference runs one masked frontier expansion per sample under
``vmap``, each until nothing changes; here the B samples of a round expand
together as (B, n) until no lane changes (one counted host sync per
iteration), with the same cap of n iterations.  A lane that has converged
stays unchanged, so each lane ends where it would end alone.

Frame layout: ``frame.num`` — percolation samples; ``frame.data`` —
{"s1": Σx, "s2": Σx² (int32 scalars), "hits": (n_pad,) int32 per-vertex
reached counts}.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from ..core.frames import StateFrame
from ..device import to_host
from .csr import Graph


def arc_edge_ids(g: Graph) -> Tuple[np.ndarray, int]:
    """Map each directed arc to its undirected edge id: ``(ids (m_arcs,)
    int32, m_edges)``; the two arcs of an edge share one id, so one
    Bernoulli draw per edge percolates both directions."""
    src = g.src.cpu().numpy().astype(np.int64)
    dst = g.dst.cpu().numpy().astype(np.int64)
    key = np.minimum(src, dst) * g.n + np.maximum(src, dst)
    uniq, inv = np.unique(key, return_inverse=True)
    return inv.astype(np.int32), int(uniq.size)


def reached_masked(g: Graph, arc_ids: torch.Tensor, edge_alive: torch.Tensor,
                   s: int) -> torch.Tensor:
    """(B, n) bool — the vertices reachable from ``s`` over the surviving
    edges of each of the B masks ``edge_alive`` (B, m_edges) bool."""
    n, dev = g.n, edge_alive.device
    alive = edge_alive[:, arc_ids.long()]                  # (B, m_arcs)
    src, dst = g.src.long(), g.dst.long()
    reached = torch.zeros((edge_alive.shape[0], n), dtype=torch.bool,
                          device=dev)
    reached[:, s] = True
    for _ in range(n):
        contrib = (reached[:, src] & alive).to(torch.int32)
        agg = torch.zeros(reached.shape, dtype=torch.int32, device=dev)
        new = reached | (agg.index_add_(1, dst, contrib) > 0)
        changed = to_host((new != reached).any())
        reached = new
        if not changed:
            break
    return reached


def make_percolation_sample_fn(g: Graph, s: int, t: int, pi: float,
                               batch: int, *, pad_to: Optional[int] = None):
    """Build SAMPLE(): ``sample_fn(gens, carry)`` draws ``batch``
    percolations for each of the ``len(gens)`` workers; worker w's (batch,
    m_edges) edge uniforms come from ``gens[w]``."""
    n, dev = g.n, g.device
    n_pad = pad_to or n
    ids_np, m_edges = arc_edge_ids(g)
    arc_ids = torch.from_numpy(ids_np).to(dev)

    def sample_fn(gens, carry):
        W = len(gens)
        edge_alive = torch.cat([torch.rand((batch, m_edges), generator=gen,
                                           device=dev) for gen in gens]) < pi
        r = reached_masked(g, arc_ids, edge_alive, s).view(W, batch, n)
        x = r[:, :, t].to(torch.int32)
        hits = torch.nn.functional.pad(r.sum(dim=1, dtype=torch.int32),
                                       (0, n_pad - n))
        data = {"s1": x.sum(dim=1, dtype=torch.int32),
                "s2": (x * x).sum(dim=1, dtype=torch.int32),
                "hits": hits.contiguous()}
        num = torch.full((W,), batch, dtype=torch.int32, device=dev)
        return StateFrame(num=num, data=data), carry

    return sample_fn


def frame_template(g: Graph, pad_to: Optional[int] = None):
    n_pad = pad_to or g.n
    z = torch.zeros((), dtype=torch.int32, device=g.device)
    return {"s1": z, "s2": z.clone(),
            "hits": torch.zeros((n_pad,), dtype=torch.int32, device=g.device)}


def reachability_exact(g: Graph, s: int, t: int, pi: float,
                       max_edges: int = 20) -> float:
    """Exact Pr[s ⇝ t] by enumerating all 2^m edge subsets (union–find per
    subset) — test oracle for tiny graphs (m ≤ ``max_edges``)."""
    ids, m = arc_edge_ids(g)
    assert m <= max_edges, f"{m} edges is too many for exact enumeration"
    src = g.src.cpu().numpy()
    dst = g.dst.cpu().numpy()
    first_arc = np.zeros(m, dtype=np.int64)
    seen = set()
    for a, e in enumerate(ids):
        if int(e) not in seen:
            seen.add(int(e))
            first_arc[e] = a
    eu, ev = src[first_arc], dst[first_arc]

    def find(parent, x):
        while parent[x] != x:
            parent[x] = parent[parent[x]]
            x = parent[x]
        return x

    prob = 0.0
    for mask in range(1 << m):
        parent = list(range(g.n))
        k = 0
        for e in range(m):
            if mask >> e & 1:
                k += 1
                ru, rv = find(parent, int(eu[e])), find(parent, int(ev[e]))
                parent[ru] = rv
        if find(parent, s) == find(parent, t):
            prob += (pi ** k) * ((1.0 - pi) ** (m - k))
    return prob
