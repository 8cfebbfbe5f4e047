"""Exact betweenness centrality (Brandes 2001) — pure-numpy test oracle,
normalized by n(n−1) over ordered pairs.  Port of
:mod:`repro.graphs.brandes`; it reads the graph's arrays on the host."""

from __future__ import annotations

from collections import deque

import numpy as np

from .csr import Graph


def brandes_exact(g: Graph) -> np.ndarray:
    n = g.n
    indptr = g.indptr.cpu().numpy()
    indices = g.indices_padded.cpu().numpy()[: g.m_arcs]
    bc = np.zeros(n, dtype=np.float64)
    for s in range(n):
        dist = np.full(n, -1, dtype=np.int64)
        sigma = np.zeros(n, dtype=np.float64)
        dist[s] = 0
        sigma[s] = 1.0
        order = []
        q = deque([s])
        while q:
            v = q.popleft()
            order.append(v)
            for w in indices[indptr[v]:indptr[v + 1]]:
                if dist[w] < 0:
                    dist[w] = dist[v] + 1
                    q.append(w)
                if dist[w] == dist[v] + 1:
                    sigma[w] += sigma[v]
        delta = np.zeros(n, dtype=np.float64)
        for w in reversed(order):
            for u in indices[indptr[w]:indptr[w + 1]]:
                if dist[u] == dist[w] - 1 and sigma[w] > 0:
                    delta[u] += sigma[u] / sigma[w] * (1.0 + delta[w])
            if w != s:
                bc[w] += delta[w]
    return bc / (n * (n - 1))
