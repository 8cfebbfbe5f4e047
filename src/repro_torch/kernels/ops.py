"""Dispatch of the port's kernels by the device of the tensors.

A CPU tensor runs the plain version in :mod:`.ref`.  A CUDA tensor launches
the hand-written kernel, or the kernel's wrapper raises: there is no
fallback from the card to the plain version.
"""

from __future__ import annotations

import torch

from . import ref
from .alias_draw import alias_draw as _alias_kernel
from .bfs_frontier import bfs_frontier as _bfs_kernel
from .frame_accum import frame_accum as _accum_kernel


def frame_accum(frames: torch.Tensor) -> torch.Tensor:
    """(W, n) → (n,) sum over workers."""
    if frames.device.type == "cpu":
        return ref.frame_accum_ref(frames)
    return _accum_kernel(frames)


def bfs_frontier(indptr: torch.Tensor, indices: torch.Tensor,
                 src: torch.Tensor, dst: torch.Tensor, sigma: torch.Tensor,
                 dist: torch.Tensor, level: int) -> torch.Tensor:
    """One BFS level for B lanes → (B, n) f32.  The CUDA kernel pulls over
    the CSR (indptr/indices); the plain version pushes over the COO arcs
    (src/dst) — both views of the same undirected graph."""
    if sigma.device.type == "cpu":
        return ref.bfs_frontier_ref(src, dst, sigma, dist, level)
    return _bfs_kernel(indptr, indices, sigma, dist, level)


def alias_draw(prob: torch.Tensor, alias: torch.Tensor, u1: torch.Tensor,
               u2: torch.Tensor) -> torch.Tensor:
    """(b,) alias-table draws → (b,) int32 item indices."""
    if u1.device.type == "cpu":
        return ref.alias_draw_ref(prob, alias, u1, u2)
    return _alias_kernel(prob, alias, u1, u2)
