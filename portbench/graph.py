"""The graph a cell runs on: its edge tuples, drawn on the device from the
seed by the configuration's generator, and the CSR built from them on the
device, handed to the port as its ``repro_torch.graphs.csr.Graph``.

Self-loops and duplicate pairs are removed and every remaining pair becomes
two arcs, as GAP's builder does for an undirected graph.  A vertex's
neighbours are in ascending order.
"""

from __future__ import annotations

import torch

from .seeds import graph_seed


def edge_tuples(bench, config: dict, seed: int, device):
    """``(n, tuples)``: the configuration's (E, 2) int64 edge tuples on
    ``device``, the same for the same seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(graph_seed(seed))
    module = bench.module("gens", config["generator"])
    return module.edge_tuples(config, gen, torch.device(device))


def csr_from_tuples(n: int, tuples: torch.Tensor) -> dict:
    """The undirected simple graph of the tuples, as int32 tensors on their
    device: ``indptr`` (n+1,), ``indices_padded`` (arcs + max_degree,) with
    the sentinel n after the arcs, ``src``/``dst`` (arcs,) sorted by
    (src, dst)."""
    a, b = tuples[:, 0], tuples[:, 1]
    keep = a != b
    a, b = a[keep], b[keep]
    pairs = torch.unique(torch.minimum(a, b) * n + torch.maximum(a, b))
    lo, hi = pairs // n, pairs % n
    del pairs, a, b, keep
    arcs, _ = torch.sort(torch.cat([lo * n + hi, hi * n + lo]))
    del lo, hi
    src, dst = arcs // n, arcs % n
    del arcs
    deg = torch.bincount(src, minlength=n)
    max_degree = max(int(deg.max()) if n else 1, 1)
    indptr = torch.zeros(n + 1, dtype=torch.int64, device=tuples.device)
    indptr[1:] = torch.cumsum(deg, 0)
    pad = torch.full((max_degree,), n, dtype=torch.int64, device=tuples.device)
    return {"n": n, "m_arcs": int(src.numel()), "max_degree": max_degree,
            "indptr": indptr.int(),
            "indices_padded": torch.cat([dst, pad]).int(),
            "src": src.int(), "dst": dst.int()}


def port_graph(csr: dict):
    """The port's Graph of a CSR made by :func:`csr_from_tuples`."""
    from repro_torch.graphs.csr import Graph

    return Graph(n=csr["n"], m_arcs=csr["m_arcs"],
                 max_degree=csr["max_degree"], indptr=csr["indptr"],
                 indices_padded=csr["indices_padded"], src=csr["src"],
                 dst=csr["dst"])
