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


def alias_draw_ref(prob: torch.Tensor, alias: torch.Tensor, u1: torch.Tensor,
                   u2: torch.Tensor) -> torch.Tensor:
    """Batched alias-table draw: keep bucket ``min(⌊u₁·n⌋, n−1)`` if
    u₂ < prob[bucket], else take alias[bucket].  The product is one f32
    multiply, truncated toward zero, as the reference's
    ``(u1 * n).astype(int32)``; the lower clamp at 0 only guards the gathers
    against uniforms outside [0, 1).

    prob (n,) f32, alias (n,) int32, u1/u2 (b,) f32 → idx (b,) int32.
    """
    n = prob.shape[0]
    bucket = (u1.float() * n).to(torch.int32).clamp(0, n - 1).long()
    return torch.where(u2 < prob[bucket], bucket, alias[bucket].long()
                       ).to(torch.int32)
