"""Dispatch of the port's kernels by the device of the tensors.

A CPU tensor runs the plain version in :mod:`.ref`.  A CUDA tensor launches
the hand-written kernel, or the kernel's wrapper raises: there is no
fallback from the card to the plain version.

``flash_attention``, ``rglru_scan`` and ``ssm_scan`` are differentiable:
when grad mode is on and an input requires grad they run as a
``torch.autograd.Function`` whose backward is the backward kernel on a CUDA
tensor and the plain backward (``ref.flash_attention_bwd_ref``,
``ref.scan_bwd_ref``) on a CPU tensor; the forward then also keeps what the
backward needs (q, k, v, o and the rows' logsumexp; or a and h).
Otherwise they run the forward alone, as serving does, and build no graph.
"""

from __future__ import annotations

import torch

from . import ref
from .alias_draw import alias_draw as _alias_kernel
from .bfs_frontier import bfs_frontier as _bfs_kernel
from .flash_attention import flash_attention as _flash_kernel
from .flash_attention import flash_attention_bwd as _flash_bwd_kernel
from .frame_accum import frame_accum as _accum_kernel
from .rglru_scan import rglru_scan as _rglru_kernel
from .rglru_scan import rglru_scan_bwd as _rglru_bwd_kernel
from .ssm_scan import ssm_scan as _ssm_kernel
from .ssm_scan import ssm_scan_bwd as _ssm_bwd_kernel


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


def _differentiating(*tensors: torch.Tensor) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


class _FlashAttention(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, window):
        if q.device.type == "cpu":
            o, lse = ref.flash_attention_ref(q, k, v, window=window,
                                             return_lse=True)
        else:
            o, lse = _flash_kernel(q, k, v, window=window, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window = window
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if q.device.type == "cpu":
            dq, dk, dv = ref.flash_attention_bwd_ref(q, k, v, o, lse, do,
                                                     window=ctx.window)
        else:
            dq, dk, dv = _flash_bwd_kernel(q, k, v, o, lse, do,
                                           window=ctx.window)
        return dq, dk, dv, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """Causal GQA attention, q (B, H, S, hd), k/v (B, KV, S, hd) →
    (B, H, S, hd) in q's dtype; ``window > 0`` is a sliding window."""
    if _differentiating(q, k, v):
        return _FlashAttention.apply(q, k, v, window)
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, window=window)
    return _flash_kernel(q, k, v, window=window)


class _Scan(torch.autograd.Function):
    """h_t = a_t ⊙ h_{t−1} + b_t along dim 1; ``kind`` is "rglru" (3-D) or
    "ssm" (4-D)."""

    @staticmethod
    def forward(ctx, a, b, kind):
        if a.device.type == "cpu":
            h = ref.rglru_scan_ref(a, b) if kind == "rglru" else \
                ref.ssm_scan_ref(a, b)
        else:
            h = (_rglru_kernel if kind == "rglru" else _ssm_kernel)(a, b)
        ctx.save_for_backward(a, h)
        ctx.kind = kind
        return h

    @staticmethod
    def backward(ctx, g):
        a, h = ctx.saved_tensors
        g = g.float().contiguous()
        if a.device.type == "cpu":
            da, db = ref.scan_bwd_ref(a, h, g)
        else:
            da, db = (_rglru_bwd_kernel if ctx.kind == "rglru"
                      else _ssm_bwd_kernel)(a, h, g)
        return da, db, None


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t−1} + b_t over (B, S, W) f32 → all h_t."""
    if _differentiating(a, b):
        return _Scan.apply(a, b, "rglru")
    if a.device.type == "cpu":
        return ref.rglru_scan_ref(a, b)
    return _rglru_kernel(a, b)


def ssm_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D, N) f32 → all h_t."""
    if _differentiating(a, b):
        return _Scan.apply(a, b, "ssm")
    if a.device.type == "cpu":
        return ref.ssm_scan_ref(a, b)
    return _ssm_kernel(a, b)
