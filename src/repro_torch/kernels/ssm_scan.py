"""Wrapper of the CUDA ``ssm_scan`` kernel (``csrc/ssm_scan.cu``): the Mamba
selective-scan recurrence h_t = a_t ⊙ h_{t−1} + b_t over (B, S, D, N) f32,
h_{−1} = 0.

Replaces :func:`repro.kernels.ssm_scan.ssm_scan`.  Its plain version is
:func:`repro_torch.kernels.ref.ssm_scan_ref`; :mod:`.ops` picks one or the
other by the tensor's device.  ``ssm_scan_bwd`` is the backward kernel
(``scan_bwd_f32``, shared with ``rglru_scan_bwd``): the reference has no Pallas backward (XLA
differentiates its associative scan); its plain version is
:func:`repro_torch.kernels.ref.scan_bwd_ref`.
"""

from __future__ import annotations

import math

import torch

from . import build

# Kernel launches since the last reset (a run sets them to 0 and reads
# them): the forward's and the backward's.
launches = 0
bwd_launches = 0


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


def scan_bwd(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor, name: str):
    """Launch ``scan_bwd_f32``, the backward kernel of both scans, over the
    lanes flattened: a, h (the forward's output) and g contiguous
    (B, S, ...) float32 on one CUDA device → (da, db) float32, walking S
    from the end, bit-equal to :func:`repro_torch.kernels.ref.scan_bwd_ref`.
    ``name`` is the calling wrapper's, for its errors; the wrapper checks
    the rank and counts the launch."""
    tensors = (a, h, g)
    if a.device.type != "cuda" or any(t.device != a.device for t in tensors):
        raise ValueError(f"{name} kernel needs a, h, g on one CUDA device, "
                         f"got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.float32 for t in tensors):
        raise ValueError(f"{name} kernel takes float32, got "
                         f"{[t.dtype for t in tensors]}")
    if h.shape != a.shape or g.shape != a.shape or \
            not all(n > 0 for n in a.shape) or a.shape[0] > 65535 or \
            a.shape[1] >= 2 ** 31 or math.prod(a.shape[2:]) >= 2 ** 31:
        raise ValueError(f"{name} kernel shapes: a {tuple(a.shape)}, "
                         f"h {tuple(h.shape)}, g {tuple(g.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError(f"{name} kernel needs contiguous tensors")
    B, S = a.shape[:2]
    da, db = torch.empty_like(a), torch.empty_like(a)
    fn = build.load("ssm_scan").scan_bwd_f32
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), h.data_ptr(), g.data_ptr(), da.data_ptr(),
                 db.data_ptr(), B, S, math.prod(a.shape[2:]), stream)
    if err != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError {err}")
    return da, db


def ssm_scan_bwd(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """The recurrence's gradients given g = ∂L/∂h: a, h and g contiguous
    (B, S, D, N) float32 on one CUDA device → (da, db), through
    :func:`scan_bwd`."""
    global bwd_launches
    if a.dim() != 4:
        raise ValueError(f"ssm_scan_bwd kernel shapes: a {tuple(a.shape)}; "
                         "needs (B, S, D, N)")
    da, db = scan_bwd(a, h, g, "ssm_scan_bwd")
    bwd_launches += 1
    return da, db
