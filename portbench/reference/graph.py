"""The reference's graph: the CSR worked out again from the edge tuples,
and on it connected components and level-synchronous BFS with
shortest-path counts, in plain PyTorch (a sparse product a level) on the
tuples' device."""

from __future__ import annotations

import warnings

import numpy as np
import torch

INF = np.iinfo(np.int32).max
SIGMA_CAP = 1e30       # a lane's new level is scaled down past this
LANE_BLOCK = 256       # lanes a BFS block runs at once


class RefGraph:
    """The undirected simple graph of (E, 2) edge tuples: self-loops and
    repeated pairs dropped, each pair two arcs, neighbours in ascending
    order.  Built on ``device`` (the tuples are moved there)."""

    def __init__(self, n: int, tuples, device):
        self.n = n
        self.device = dev = torch.device(device)
        t = torch.as_tensor(tuples).to(dev, torch.int64).reshape(-1, 2)
        t = t[t[:, 0] != t[:, 1]]
        pairs = torch.unique(torch.minimum(t[:, 0], t[:, 1]) * n
                             + torch.maximum(t[:, 0], t[:, 1]))
        del t
        arcs, _ = torch.sort(torch.cat([pairs, (pairs % n) * n + pairs // n]))
        del pairs
        self.src, self.dst = arcs // n, arcs % n
        del arcs
        deg = torch.bincount(self.src, minlength=n)
        self.m = int(self.src.numel())
        self.max_degree = max(int(deg.max()) if n else 1, 1)
        self.t_indptr = torch.cat([deg.new_zeros(1), torch.cumsum(deg, 0)])
        self.t_indices = torch.cat(
            [self.dst, self.dst.new_full((self.max_degree,), n)])
        with warnings.catch_warnings():  # "sparse CSR support is in beta"
            warnings.simplefilter("ignore", UserWarning)
            self.adj = torch.sparse_csr_tensor(
                self.t_indptr, self.dst,
                torch.ones(self.m, dtype=torch.float32, device=dev),
                size=(n, n), check_invariants=False)
        self._components = None

    def components(self) -> np.ndarray:
        """Each vertex's component, named by its least vertex id: labels
        lowered to the least label among the neighbours, then to the label's
        own label, until nothing changes."""
        if self._components is None:
            src, dst = self.src, self.dst
            labels = torch.arange(self.n, device=self.device)
            while True:
                new = labels.scatter_reduce(0, dst, labels[src], "amin",
                                            include_self=True)
                new = new[new]
                if torch.equal(new, labels):
                    break
                labels = new
            self._components = labels.cpu().numpy()
        return self._components

    def bfs(self, s: torch.Tensor, t: torch.Tensor = None, *,
            max_levels: int):
        """Distances (INF where unreached) and path counts σ from the sources
        ``s`` (L,) on the device, as (L, n) int32 and float32.

        Level by level: a vertex first reached at level k+1 gets k+1 and the
        sum of σ over its neighbours at level k.  A lane stops once its
        target ``t`` has its level (then σ of every vertex nearer than t is
        final), once its frontier is empty, or after ``max_levels`` levels.
        A lane's new level is scaled so that its largest σ is at most 1e30."""
        parts = [self._bfs_block(s[i:i + LANE_BLOCK],
                                 None if t is None else t[i:i + LANE_BLOCK],
                                 max_levels)
                 for i in range(0, s.numel(), LANE_BLOCK)]
        return (torch.cat([p[0] for p in parts]),
                torch.cat([p[1] for p in parts]))

    def _bfs_block(self, s, t, max_levels: int):
        L, n, dev = s.numel(), self.n, self.device
        rows = torch.arange(L, device=dev)
        dist = torch.full((L, n), INF, dtype=torch.int32, device=dev)
        dist[rows, s] = 0
        sigma = torch.zeros((L, n), dtype=torch.float32, device=dev)
        sigma[rows, s] = 1.0
        grew = torch.ones(L, dtype=torch.bool, device=dev)
        for level in range(max_levels):
            live = grew if t is None else grew & (dist[rows, t] == INF)
            if not bool(live.any()):
                break
            on_front = torch.where(dist == level, sigma, 0.0).t().contiguous()
            agg = torch.sparse.mm(self.adj, on_front).t()
            del on_front
            new = (dist == INF) & (agg > 0) & live[:, None]
            dist[new] = level + 1
            top = torch.where(new, agg, 0.0).amax(dim=1)
            scale = torch.where(top > SIGMA_CAP, SIGMA_CAP / top, 1.0)
            fresh = agg * scale[:, None]
            sigma = torch.where(new, fresh, sigma)
            grew = new.any(dim=1)
        return dist, sigma
