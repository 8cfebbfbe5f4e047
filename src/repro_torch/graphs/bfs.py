"""Level-synchronous BFS with shortest-path counting, and uniform
shortest-path sampling — SAMPLE() of Algorithm 1 for KADABRA.

Port of :mod:`repro.graphs.bfs`, batched: B BFS lanes (one per sample) run
together, one ``ops.bfs_frontier`` call per level for all of them.  The
reference runs one lane per ``vmap`` slot under a batched ``while_loop``,
which freezes a lane once its own condition fails; here a lane that is done
(its target reached, its frontier empty, or the level budget spent) is
masked out of every later level, so each lane ends in the state it would
reach alone, whichever lanes share its batch.  The host reads "is any lane
still active" once per level (one counted sync).

σ is renormalized per level and per lane against float32 overflow: scaling
a lane's new level uniformly keeps the within-level ratios that path
sampling uses.
"""

from __future__ import annotations

from typing import Sequence

import torch

from ..device import resolve_device, to_host
from ..kernels import ops
from .csr import Graph

INF = 0x3FFFFFFF
_SIGMA_CAP = 1e30


def bfs_sssp(g: Graph, s: torch.Tensor, t: torch.Tensor = None, *,
             max_levels: int, early_exit: bool = True, device=None):
    """Distances and (rescaled) shortest-path counts from the B sources ``s``.

    Returns ``dist (B, n) int32`` (INF if unreachable) and ``sigma (B, n)
    f32``.  With ``early_exit`` and targets ``t`` (B,), lane b stops once
    t[b]'s level is complete (σ(t[b]) is final then).
    """
    device = resolve_device(device)
    g = g.to(device)
    s = torch.as_tensor(s, device=device).reshape(-1).long()
    B, n = s.shape[0], g.n
    rows = torch.arange(B, device=device)
    dist = torch.full((B, n), INF, dtype=torch.int32, device=device)
    dist[rows, s] = 0
    sigma = torch.zeros((B, n), dtype=torch.float32, device=device)
    sigma[rows, s] = 1.0
    if t is not None:
        t = torch.as_tensor(t, device=device).reshape(-1).long()
    frontier = torch.ones(B, dtype=torch.int64, device=device)
    level = 0
    while level < max_levels:
        active = frontier > 0
        if early_exit and t is not None:
            active &= dist[rows, t] == INF
        if not to_host(active.any()):
            break
        agg = ops.bfs_frontier(g.indptr, g.indices_padded, g.src, g.dst,
                               sigma, dist, level)
        newly = (dist == INF) & (agg > 0.0) & active[:, None]
        dist.masked_fill_(newly, level + 1)
        mx = torch.where(newly, agg, 0.0).amax(dim=1)
        scale = torch.where(mx > _SIGMA_CAP, _SIGMA_CAP / mx, 1.0)
        sigma = torch.where(newly, agg * scale[:, None], sigma)
        frontier = newly.sum(dim=1)
        level += 1
    return dist, sigma


def eccentricity(g: Graph, s: torch.Tensor, *, max_levels: int,
                 device=None) -> torch.Tensor:
    """(B,) eccentricities of the sources ``s`` (within their components)."""
    dist, _ = bfs_sssp(g, s, None, max_levels=max_levels, early_exit=False,
                       device=device)
    return torch.where(dist == INF, 0, dist).amax(dim=1)


def connected_components(g: Graph, *, max_iters: int = 10_000,
                         device=None) -> torch.Tensor:
    """Component labels (the least vertex id of each component) via
    min-label propagation."""
    device = resolve_device(device)
    g = g.to(device)
    labels = torch.arange(g.n, dtype=torch.int32, device=device)
    src, dst = g.src.long(), g.dst.long()
    for _ in range(max_iters):
        new = labels.scatter_reduce(0, dst, labels[src], reduce="amin",
                                    include_self=True)
        changed = to_host((new != labels).any())
        labels = new
        if not changed:
            break
    return labels


def sample_path(g: Graph, gens: Sequence[torch.Generator], s: torch.Tensor,
                t: torch.Tensor, dist: torch.Tensor, sigma: torch.Tensor, *,
                max_len: int) -> torch.Tensor:
    """Uniform random shortest s–t paths for L = W·B lanes → the internal
    vertices of each path, ``(L, max_len)`` int64 with the sentinel ``n``
    in unused slots.

    Walks back from t, choosing each predecessor u (a neighbour with
    dist[u] = dist[cur] − 1) with probability σ(u)/Σσ by Gumbel-max over the
    ≤ max_degree padded neighbour slots.  Lanes ``w·B … w·B+B−1`` draw their
    noise from ``gens[w]``, one (B, Δ) block per step and always ``max_len``
    steps, so a worker's stream does not depend on the other workers.  An
    unreachable t gives an empty path (x_i = 0, the correct estimator term).
    """
    L, n, dev = s.shape[0], g.n, s.device
    W = len(gens)
    B = L // W
    rows = torch.arange(L, device=dev)
    reachable = dist[rows, t] != INF
    cur = t.clone()
    path = torch.full((L, max_len), n, dtype=torch.int64, device=dev)
    for step in range(max_len):
        done = (cur == s) | ~reachable
        nbrs = g.neighbors_padded(cur)                      # (L, Δ), sentinel n
        nb = nbrs.clamp(max=n - 1)
        pred = (nbrs < n) & (dist.gather(1, nb) == dist[rows, cur][:, None] - 1)
        w = torch.where(pred, sigma.gather(1, nb), 0.0)
        u = torch.cat([torch.rand((B, g.max_degree), generator=gen, device=dev)
                       for gen in gens]).clamp_min(1e-12)
        gum = -torch.log(-torch.log(u))
        scores = torch.where(w > 0.0, torch.log(w) + gum, -torch.inf)
        nxt = nbrs.gather(1, scores.argmax(dim=1, keepdim=True)).squeeze(1)
        cur2 = torch.where(done, cur, nxt)
        internal = ~done & (cur2 != s) & (cur2 != t)
        path[:, step] = torch.where(internal, cur2, n)
        cur = cur2
    return path
