"""Wrapper of the CUDA ``ssm_scan`` kernel (``csrc/ssm_scan.cu``): the Mamba
selective-scan recurrence h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D, N) f32,
h_{−1} = 0.

Replaces :func:`repro.kernels.ssm_scan.ssm_scan`.  Its plain version is
:func:`repro_torch.kernels.ref.ssm_scan_ref`; :mod:`.ops` picks one or the
other by the tensor's device.
"""

from __future__ import annotations

import torch

from . import build

# Kernel launches since the last reset (a run sets it to 0 and reads it).
launches = 0


def ssm_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: contiguous (B, S, D, N) float32 on one CUDA device → all h_t
    (B, S, D, N) float32, bit-equal to the sequential recurrence."""
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("ssm_scan kernel needs a and b on one CUDA device, "
                         f"got {a.device}, {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"ssm_scan kernel takes float32, got {a.dtype}, "
                         f"{b.dtype}")
    if a.dim() != 4 or b.shape != a.shape or not all(n > 0 for n in a.shape) \
            or a.shape[0] > 65535 or a.shape[1] >= 2 ** 31 \
            or a.shape[2] * a.shape[3] >= 2 ** 31:
        raise ValueError(f"ssm_scan kernel shapes: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}; needs (B, S, D, N)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("ssm_scan kernel needs contiguous tensors")
    B, S, D, N = a.shape
    h = torch.empty_like(a)
    fn = build.load("ssm_scan").ssm_scan_f32
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, D * N, stream)
    if err != 0:
        raise RuntimeError(f"ssm_scan kernel launch failed: cudaError {err}")
    launches += 1
    return h
