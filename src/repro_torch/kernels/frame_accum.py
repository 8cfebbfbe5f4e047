"""Wrapper of the CUDA ``frame_accum`` kernel (``csrc/frame_accum.cu``):
(W, n) → (n,), the sum of W worker frames.

Replaces :func:`repro.kernels.frame_accum.frame_accum`.  Its plain version
is :func:`repro_torch.kernels.ref.frame_accum_ref`; :mod:`.ops` picks one
or the other by the tensor's device.
"""

from __future__ import annotations

import torch

from . import build

# Kernel launches since the last reset (a run sets it to 0 and reads it).
launches = 0

_ENTRY = {torch.int32: "frame_accum_i32", torch.float32: "frame_accum_f32",
          torch.bfloat16: "frame_accum_bf16"}


def frame_accum(frames: torch.Tensor) -> torch.Tensor:
    """Launch the kernel on a contiguous (W, n) CUDA tensor of int32, f32
    or bf16; returns a new (n,) tensor of the same type."""
    global launches
    if frames.device.type != "cuda":
        raise ValueError(f"frame_accum kernel needs a CUDA tensor, got "
                         f"{frames.device}")
    if frames.dtype not in _ENTRY:
        raise ValueError(f"frame_accum kernel takes int32, float32 or "
                         f"bfloat16, got {frames.dtype}")
    if frames.dim() != 2 or not frames.is_contiguous():
        raise ValueError(f"frame_accum kernel needs a contiguous (W, n) "
                         f"tensor, got shape {tuple(frames.shape)}")
    w, n = frames.shape
    out = torch.empty(n, dtype=frames.dtype, device=frames.device)
    fn = getattr(build.load("frame_accum"), _ENTRY[frames.dtype])
    with torch.cuda.device(frames.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(frames.data_ptr(), out.data_ptr(), w, n, stream)
    if err != 0:
        raise RuntimeError(f"frame_accum kernel launch failed: cudaError {err}")
    launches += 1
    return out
