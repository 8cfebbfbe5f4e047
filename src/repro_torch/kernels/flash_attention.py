"""Wrapper of the CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``): causal grouped-query attention with an
optional sliding window, streaming softmax with f32 statistics.

The dtype picks the body at the entry point (it is not a fallback: nothing
catches a failure and tries the other):

- bfloat16 → ``flash_attention_bf16``, Q·Kᵀ and P·V on the tensor cores
  (``mma.sync`` bf16 with f32 accumulation), K/V tiles loaded by
  ``cp.async`` (16, 8 or 4 bytes a copy, the widest the views' layout
  allows) into a two-stage ring; the probabilities are rounded to bf16 for
  the P·V product.
- float32 → ``flash_attention_f32``, on the CUDA cores with everything in
  f32, as the Pallas kernel computes: register-tiled Q·Kᵀ and P·V (an SGEMM
  micro-kernel a thread), K/V tiles loaded by ``cp.async`` (16 bytes a
  copy where the views allow it, else 4), each refilled while the other is
  multiplied.

Any head dim from 1 to ``MAX_HEAD_DIM`` runs: each body is built for the
padded head dims ``PADDED_HEAD_DIMS`` and takes the smallest that holds hd,
with the padding's columns zero in shared memory and not stored; the
softmax scale is 1/√hd of the true hd.

The forward writes each row's logsumexp ``lse`` (B, H, S) f32 when asked
(``return_lse``), which is what :func:`flash_attention_bwd`, the backward
kernel, rebuilds the probabilities from: D, then dK/dV a key tile and dQ a
query tile, no atomics.  Its bodies are chosen by dtype too:
``flash_attention_bwd_bf16`` runs all seven products on the tensor cores
(``mma.sync``, Q/dO or K/V tiles by ``cp.async`` through a two-stage ring,
P and dS rounded to bf16 as the products' operands; where the dK/dV grid
has too few blocks for the card, each GQA group's heads are split and
their f32 partial sums added in order, in scratch whose size
``flash_attention_bwd_bf16_scratch`` gives);
``flash_attention_bwd_f32`` runs all seven products on the tensor cores too,
as 3xTF32 (each f32 operand split into two TF32 parts, three ``mma.sync``
TF32 products a tile, f32 accumulation: f32-grade, as the gradient checks
need), with the same two-stage ``cp.async`` ring (16, 8 or 4 bytes a copy,
the widest the views allow; every f32 view allows 4), P and dS kept in f32.
It has a launch counter of its own, ``bwd_launches``.

Replaces :func:`repro.kernels.flash_attention.flash_attention`; the
reference has no Pallas backward (XLA differentiates its attention).  Its plain
version is :func:`repro_torch.kernels.ref.flash_attention_ref`; :mod:`.ops`
picks one or the other by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# Kernel launches since the last reset (a run sets them to 0 and reads
# them): the forward's and the backward's.
launches = 0
bwd_launches = 0

MAX_HEAD_DIM = 256
PADDED_HEAD_DIMS = (16, 32, 64, 128, 256)  # the bodies' instances
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}
_BWD_ENTRY = {torch.float32: "flash_attention_bwd_f32",
              torch.bfloat16: "flash_attention_bwd_bf16"}


def _check_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  window: int) -> None:
    tensors = (q, k, v)
    if any(t.device.type != "cuda" for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("flash_attention kernel needs q, k, v on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if q.dtype not in _ENTRY or k.dtype != q.dtype or v.dtype != q.dtype:
        raise ValueError("flash_attention kernel takes float32 or bfloat16 "
                         f"q, k, v of one dtype, got {q.dtype}, {k.dtype}, "
                         f"{v.dtype}")
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"flash_attention kernel shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if k.shape[0] != B or k.shape[2] != S or k.shape[3] != hd or \
            KV < 1 or H % KV or not 1 <= hd <= MAX_HEAD_DIM or \
            not (0 < S < 2 ** 31) or H > 65535 or B > 65535:
        raise ValueError(f"flash_attention kernel shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}; needs H a multiple of KV and "
                         f"1 ≤ hd ≤ {MAX_HEAD_DIM}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attention kernel needs the head dimension "
                         "contiguous (stride 1)")
    if window < 0:
        raise ValueError(f"flash_attention window must be ≥ 0, got {window}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, return_lse: bool = False):
    """q (B, H, S, hd), k and v (B, KV, S, hd), one dtype (f32 or bf16), on
    one CUDA device → (B, H, S, hd) in q's dtype.  Query head h reads kv
    head h // (H/KV).  Any strides are taken as long as the head dimension
    is contiguous, so the model's (B, S, H, hd) projections go in as
    ``.transpose(1, 2)`` views; the output has q's memory layout
    (``torch.empty_like``).  1 ≤ hd ≤ 256.  In bf16, hd and every stride
    must be even and every tensor 4-byte aligned (cp.async copies at least
    4 bytes).  With ``return_lse`` → (o, lse), lse (B, H, S) f32 the rows'
    natural logsumexp; without it the kernel writes none."""
    global launches
    _check_inputs(q, k, v, window)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    o = torch.empty_like(q)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device) \
        if return_lse else None
    if q.dtype == torch.bfloat16 and (hd % 2 or any(
            _odd_layout(t) for t in (q, k, v, o))):
        raise ValueError("flash_attention bf16 kernel copies 4 bytes at the "
                         "least: it needs an even hd and 4-byte aligned "
                         "tensors whose (b, head, position) strides are even")
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, o)
                                         for s in t.stride()[:3]])
    fn = getattr(build.load("flash_attention"), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 None if lse is None else lse.data_ptr(),
                 B, H, KV, S, hd, int(window), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return (o, lse) if return_lse else o


def _odd_layout(t: torch.Tensor) -> bool:
    """Whether a bf16 tensor's layout forbids 4-byte copies: a pointer not
    4-byte aligned or an odd (b, head, position) stride."""
    return t.data_ptr() % 4 != 0 or any(s % 2 for s in t.stride()[:3])


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        o: torch.Tensor, lse: torch.Tensor, do: torch.Tensor,
                        *, window: int = 0):
    """The backward kernel → (dq, dk, dv), each in its input's dtype and
    memory layout (``torch.empty_like``).  q, k, v as the forward takes
    them (the same checks); o the forward's output (q's shape and dtype,
    head dimension contiguous); lse its (B, H, S) f32 logsumexp; do the
    output's gradient, taken with its own strides when the body can copy
    it as it lies.  That is a choice by layout, not a fallback: ``do`` is
    made contiguous when its head dimension is not contiguous, and, in
    bf16, when its pointer is not 4-byte aligned or a (b, head, position)
    stride is odd (the bf16 body copies 4 bytes at the least).  In bf16, q,
    k and v must allow 4-byte copies as in the forward (an even hd, even
    strides, 4-byte aligned), since dq, dk and dv take their layout; the
    f32 body copies 16, 8 or 4 bytes, the widest that q, k, v and do allow,
    and every f32 view allows 4, so it takes any layout with a contiguous
    head dimension."""
    global bwd_launches
    _check_inputs(q, k, v, window)
    B, H, S, hd = q.shape
    KV = k.shape[1]
    if o.shape != q.shape or do.shape != q.shape or o.dtype != q.dtype or \
            do.dtype != q.dtype or o.device != q.device or \
            do.device != q.device or o.stride(-1) != 1:
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} {o.dtype} "
                         f"and do {tuple(do.shape)} {do.dtype} must match q "
                         f"{tuple(q.shape)} {q.dtype} on its device, o's head "
                         f"dimension contiguous")
    if lse.shape != (B, H, S) or lse.dtype != torch.float32 or \
            lse.device != q.device or not lse.is_contiguous():
        raise ValueError(f"flash_attention_bwd: lse must be a contiguous "
                         f"(B, H, S) float32 tensor, got {tuple(lse.shape)} "
                         f"{lse.dtype}")
    bf16 = q.dtype == torch.bfloat16
    if bf16 and (hd % 2 or any(_odd_layout(t) for t in (q, k, v))):
        raise ValueError("flash_attention_bwd bf16 kernel copies 4 bytes at "
                         "the least: it needs an even hd and 4-byte aligned "
                         "q, k, v whose (b, head, position) strides are even")
    if do.stride(-1) != 1 or (bf16 and _odd_layout(do)):
        do = do.clone(memory_format=torch.contiguous_format)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    strides = (ctypes.c_longlong * 24)(*[s for t in (q, k, v, o, do, dq, dk, dv)
                                         for s in t.stride()[:3]])
    lib = build.load("flash_attention")
    fn = getattr(lib, _BWD_ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        floats = ctypes.c_longlong(B * H * S)
        if bf16:  # D, and the dK/dV partial sums where the body splits its grid
            err = lib.flash_attention_bwd_bf16_scratch(B, H, KV, S, hd, int(window),
                                                       ctypes.byref(floats))
            if err != 0:
                raise RuntimeError(f"flash_attention_bwd scratch query failed: "
                                   f"cudaError {err}")
        D = torch.empty(floats.value, dtype=torch.float32, device=q.device)
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 lse.data_ptr(), do.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                 dv.data_ptr(), D.data_ptr(), B, H, KV, S, hd, int(window),
                 strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: "
                           f"cudaError {err}")
    bwd_launches += 1
    return dq, dk, dv
