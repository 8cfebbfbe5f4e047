"""Plain PyTorch versions of the port's kernels.

They are what a CPU tensor runs (the tests), and what ``chip_smoke.py``
holds each CUDA kernel against on the card.  Each matches the function of
the same name in :mod:`repro.kernels.ref`.
"""

from __future__ import annotations

import torch


def frame_accum_ref(frames: torch.Tensor) -> torch.Tensor:
    """(W, n) → (n,): the sum over workers, accumulated in f32 for float
    frames and in int32 for integer frames, cast back to the input type."""
    acc = torch.float32 if frames.dtype.is_floating_point else torch.int32
    return torch.sum(frames.to(acc), dim=0, dtype=acc).to(frames.dtype)


def bfs_frontier_ref(src: torch.Tensor, dst: torch.Tensor, sigma: torch.Tensor,
                     dist: torch.Tensor, level: int) -> torch.Tensor:
    """One BFS level for B lanes, COO form:
    ``agg[b, v] = Σ_{arcs u→v} σ[b, u]·[dist[b, u] == level]``.

    src, dst: (m,) arcs; sigma: (B, n) f32; dist: (B, n) int32 → (B, n) f32.
    """
    src = src.long()
    contrib = torch.where(dist[:, src] == level, sigma.float()[:, src], 0.0)
    agg = torch.zeros(sigma.shape, dtype=torch.float32, device=sigma.device)
    return agg.index_add_(1, dst.long(), contrib)
