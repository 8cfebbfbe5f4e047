"""CSR graph container (undirected, unweighted), as tensors on a device.

Port of :mod:`repro.graphs.csr`.  ``from_edges`` runs the reference's numpy
logic unchanged, so both packages build bit-identical arrays from the same
edges.  The CSR view (``indptr``/``indices_padded``) serves the BFS kernel's
pull and path backtracking; the COO view (``src``/``dst``, each undirected
edge as two arcs) serves the plain BFS level and component labelling.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..device import resolve_device


@dataclasses.dataclass(frozen=True)
class Graph:
    n: int                        # number of vertices
    m_arcs: int                   # number of directed arcs (2·|E|)
    max_degree: int
    indptr: torch.Tensor          # (n+1,) int32
    indices_padded: torch.Tensor  # (m_arcs + max_degree,) int32, sentinel n
    src: torch.Tensor             # (m_arcs,) int32, sorted by src
    dst: torch.Tensor             # (m_arcs,) int32

    @property
    def device(self) -> torch.device:
        return self.indptr.device

    def to(self, device) -> "Graph":
        device = torch.device(device)
        if device == self.device:
            return self
        return dataclasses.replace(
            self, indptr=self.indptr.to(device),
            indices_padded=self.indices_padded.to(device),
            src=self.src.to(device), dst=self.dst.to(device))

    def degree(self, v: torch.Tensor) -> torch.Tensor:
        v = v.long()
        return self.indptr[v + 1] - self.indptr[v]

    def neighbors_padded(self, v: torch.Tensor) -> torch.Tensor:
        """(B,) vertices → (B, max_degree) int64 neighbour ids; slots ≥
        degree(v) hold the sentinel ``n``."""
        v = v.long()
        start = self.indptr[v].long()
        slot = torch.arange(self.max_degree, device=v.device)
        nbrs = self.indices_padded[start[:, None] + slot].long()
        return torch.where(slot < self.degree(v)[:, None], nbrs, self.n)


def csr_arrays(n: int, edges: np.ndarray):
    """The reference's ``from_edges`` in numpy: self-loops and duplicates
    removed, each edge two arcs.  Returns (indptr, indices_padded, src, dst)."""
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    e = edges[edges[:, 0] != edges[:, 1]] if edges.size else edges
    if e.size:
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        und = np.unique(lo * n + hi)
        lo, hi = und // n, und % n
    else:
        lo = hi = np.zeros(0, dtype=np.int64)
    src = np.concatenate([lo, hi]).astype(np.int32)
    dst = np.concatenate([hi, lo]).astype(np.int32)
    order = np.argsort(src, kind="stable")
    src_s, dst_s = src[order], dst[order]
    indptr = np.zeros(n + 1, dtype=np.int32)
    np.add.at(indptr, src_s + 1, 1)
    indptr = np.cumsum(indptr).astype(np.int32)
    max_degree = max(int((indptr[1:] - indptr[:-1]).max(initial=1)), 1)
    indices_padded = np.concatenate([dst_s, np.full(max_degree, n, np.int32)])
    return indptr, indices_padded, src_s, dst_s


def graph_from_arrays(n: int, indptr, indices_padded, src, dst,
                      device) -> Graph:
    m = int(len(src))

    def t(a):
        return torch.from_numpy(np.array(a, dtype=np.int32)).to(device)

    return Graph(n=n, m_arcs=m, max_degree=int(len(indices_padded)) - m,
                 indptr=t(indptr), indices_padded=t(indices_padded),
                 src=t(src), dst=t(dst))


def from_edges(n: int, edges: np.ndarray, device=None) -> Graph:
    """Build an undirected simple Graph from an (E, 2) int array of edges,
    on ``device`` (``None`` → the CUDA card)."""
    device = resolve_device(device)
    return graph_from_arrays(n, *csr_arrays(n, edges), device=device)
