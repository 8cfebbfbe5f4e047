"""Synthetic graph generators (paper App. E classes): Erdős–Rényi and
Barabási–Albert (social/hyperlink, low diameter) and 2-D grids (road, high
diameter).  Port of :mod:`repro.graphs.gens` with the same numpy calls, so
the graphs are bit-identical to the reference's."""

from __future__ import annotations

import numpy as np

from ..device import resolve_device
from .csr import Graph, csr_arrays, graph_from_arrays


def erdos_renyi(n: int, m_edges: int, seed: int = 0, device=None) -> Graph:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    e = rng.integers(0, n, size=(int(m_edges * 1.15) + 8, 2))
    return _ensure_connected_core(n, e, device)


def barabasi_albert(n: int, m_per: int = 3, seed: int = 0, device=None) -> Graph:
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    targets = list(range(m_per + 1))
    repeated: list[int] = list(targets)
    edges = []
    for v in range(m_per + 1, n):
        chosen = rng.choice(repeated, size=m_per, replace=False) \
            if len(set(repeated)) >= m_per else rng.integers(0, v, size=m_per)
        for t in np.atleast_1d(chosen):
            edges.append((v, int(t)))
            repeated.append(int(t))
        repeated.extend([v] * m_per)
    return graph_from_arrays(n, *csr_arrays(n, np.array(edges)), device=device)


def grid2d(rows: int, cols: int, device=None) -> Graph:
    """Road-network analog: high diameter, degree ≤ 4."""
    device = resolve_device(device)
    n = rows * cols
    edges = []
    for r in range(rows):
        for c in range(cols):
            v = r * cols + c
            if c + 1 < cols:
                edges.append((v, v + 1))
            if r + 1 < rows:
                edges.append((v, v + cols))
    return graph_from_arrays(n, *csr_arrays(n, np.array(edges)), device=device)


def _ensure_connected_core(n: int, e: np.ndarray, device) -> Graph:
    """Attach isolated vertices to vertex 0 so ER graphs have one big CC."""
    arrays = csr_arrays(n, e)
    indptr = arrays[0]
    isolated = np.where(indptr[1:] - indptr[:-1] == 0)[0]
    if isolated.size:
        extra = np.stack([isolated, np.zeros_like(isolated)], axis=1)
        arrays = csr_arrays(n, np.concatenate([np.asarray(e), extra], axis=0))
    return graph_from_arrays(n, *arrays, device=device)
