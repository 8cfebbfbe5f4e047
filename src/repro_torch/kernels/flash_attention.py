"""Wrapper of the CUDA ``flash_attention`` kernel
(``csrc/flash_attention.cu``): causal grouped-query attention with an
optional sliding window, streaming softmax with f32 statistics.

The dtype picks the body at the entry point (it is not a fallback: nothing
catches a failure and tries the other):

- bfloat16 → ``flash_attention_bf16``, Q·Kᵀ and P·V on the tensor cores
  (``mma.sync`` bf16 with f32 accumulation), K/V tiles loaded by
  ``cp.async`` into a two-stage ring; the probabilities are rounded to bf16
  for the P·V product.
- float32 → ``flash_attention_f32``, the scalar body on the CUDA cores with
  everything in f32, as the Pallas kernel computes.

Replaces :func:`repro.kernels.flash_attention.flash_attention`.  Its plain
version is :func:`repro_torch.kernels.ref.flash_attention_ref`; :mod:`.ops`
picks one or the other by the tensor's device.
"""

from __future__ import annotations

import ctypes

import torch

from . import build

# Kernel launches since the last reset (a run sets it to 0 and reads it).
launches = 0

HEAD_DIMS = (32, 64, 128, 256)
_ENTRY = {torch.float32: "flash_attention_f32",
          torch.bfloat16: "flash_attention_bf16"}


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """q (B, H, S, hd), k and v (B, KV, S, hd), one dtype (f32 or bf16), on
    one CUDA device → (B, H, S, hd) in q's dtype.  Query head h reads kv
    head h // (H/KV).  Any strides are taken as long as the head dimension
    is contiguous, so the model's (B, S, H, hd) projections go in as
    ``.transpose(1, 2)`` views; the output has q's memory layout
    (``torch.empty_like``).  In bf16 every stride but the last must be a
    multiple of 8 and every tensor 16-byte aligned."""
    global launches
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
            KV < 1 or H % KV or hd not in HEAD_DIMS or \
            not (0 < S < 2 ** 31) or H > 65535 or B > 65535:
        raise ValueError(f"flash_attention kernel shapes: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}; needs H a multiple of KV and "
                         f"hd in {HEAD_DIMS}")
    if any(t.stride(-1) != 1 for t in tensors):
        raise ValueError("flash_attention kernel needs the head dimension "
                         "contiguous (stride 1)")
    if window < 0:
        raise ValueError(f"flash_attention window must be ≥ 0, got {window}")
    o = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and any(
            t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])
            for t in (q, k, v, o)):
        raise ValueError("flash_attention bf16 kernel copies 16 bytes at a "
                         "time: it needs 16-byte aligned tensors whose "
                         "(b, head, position) strides are multiples of 8")
    strides = (ctypes.c_longlong * 12)(*[s for t in (q, k, v, o)
                                         for s in t.stride()[:3]])
    fn = getattr(build.load("flash_attention"), _ENTRY[q.dtype])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                 B, H, KV, S, hd, int(window), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: "
                           f"cudaError {err}")
    launches += 1
    return o
