"""GAP's Kron: the Graph500 Kronecker generator, 16·2^scale edge tuples.

Each tuple picks one of the four quadrants of the adjacency matrix with
probabilities A, B, C, D = 1 − A − B − C at every one of the ``scale`` bit
levels (the Graph500 reference's two draws a level: the row bit is 1 with
probability C + D, the column bit then 1 with probability B/(A+B) or
D/(C+D)).  Vertex ids are then permuted at random, as GAP does, so that the
hubs are not the low ids; isolated vertices are kept.
"""

from __future__ import annotations

import torch


def bit_tuples(config: dict, gen: torch.Generator, device: torch.device):
    """The (E, 2) tuples before the permutation of vertex ids."""
    scale = int(config["scale"])
    count = int(config["edge_factor"]) << scale
    a, b, c = (float(config[k]) for k in ("A", "B", "C"))
    ab = a + b
    a_norm, c_norm = a / ab, c / (1.0 - ab)
    src = torch.zeros(count, dtype=torch.int64, device=device)
    dst = torch.zeros(count, dtype=torch.int64, device=device)
    for bit in range(scale):
        row = torch.rand(count, generator=gen, device=device) > ab
        col_p = torch.where(row, c_norm, a_norm)
        col = torch.rand(count, generator=gen, device=device) > col_p
        src |= row.long() << bit
        dst |= col.long() << bit
    return torch.stack([src, dst], dim=1)


def edge_tuples(config: dict, gen: torch.Generator, device: torch.device):
    n = 1 << int(config["scale"])
    tuples = bit_tuples(config, gen, device)
    perm = torch.randperm(n, generator=gen, device=device)
    return n, perm[tuples]
