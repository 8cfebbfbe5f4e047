"""GAP's Urand: 16·2^scale edge tuples, each end uniform over the 2^scale
vertices (Beamer, Asanović, Patterson, arXiv:1508.03619)."""

from __future__ import annotations

import torch


def edge_tuples(config: dict, gen: torch.Generator, device: torch.device):
    n = 1 << int(config["scale"])
    count = int(config["edge_factor"]) * n
    return n, torch.randint(0, n, (count, 2), generator=gen, device=device)
