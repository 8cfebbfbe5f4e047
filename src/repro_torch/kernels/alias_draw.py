"""Wrapper of the CUDA ``alias_draw`` kernel (``csrc/alias_draw.cu``):
batched alias-table draws,

    bucket = min(⌊u₁·n⌋, n−1);  idx = bucket if u₂ < prob[bucket]
                                else alias[bucket].

Replaces :func:`repro.kernels.alias_draw.alias_draw`.  Its plain version is
:func:`repro_torch.kernels.ref.alias_draw_ref`; :mod:`.ops` picks one or the
other by the tensor's device.
"""

from __future__ import annotations

import torch

from . import build

# Kernel launches since the last reset (a run sets it to 0 and reads it).
launches = 0


def alias_draw(prob: torch.Tensor, alias: torch.Tensor, u1: torch.Tensor,
               u2: torch.Tensor) -> torch.Tensor:
    """prob (n,) f32, alias (n,) int32 and uniforms u1, u2 (b,) f32 in
    [0, 1), all contiguous on one CUDA device → idx (b,) int32."""
    global launches
    tensors = (prob, alias, u1, u2)
    if any(t.device.type != "cuda" for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("alias_draw kernel needs all tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if prob.dtype != torch.float32 or alias.dtype != torch.int32 or \
            u1.dtype != torch.float32 or u2.dtype != torch.float32:
        raise ValueError("alias_draw kernel takes float32 prob, u1, u2 and "
                         "int32 alias")
    n = prob.shape[0] if prob.dim() == 1 else 0
    if not (1 <= n < 2 ** 31) or alias.shape != prob.shape or \
            u1.dim() != 1 or u2.shape != u1.shape:
        raise ValueError(f"alias_draw kernel shapes: prob {tuple(prob.shape)}, "
                         f"alias {tuple(alias.shape)}, u1 {tuple(u1.shape)}, "
                         f"u2 {tuple(u2.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("alias_draw kernel needs contiguous tensors")
    b = u1.shape[0]
    idx = torch.empty(b, dtype=torch.int32, device=u1.device)
    if b == 0:
        return idx
    fn = build.load("alias_draw").alias_draw_f32
    with torch.cuda.device(u1.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(prob.data_ptr(), alias.data_ptr(), u1.data_ptr(),
                 u2.data_ptr(), idx.data_ptr(), n, b, stream)
    if err != 0:
        raise RuntimeError(f"alias_draw kernel launch failed: cudaError {err}")
    launches += 1
    return idx
