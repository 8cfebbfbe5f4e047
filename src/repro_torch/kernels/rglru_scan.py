"""Wrapper of the CUDA ``rglru_scan`` kernel (``csrc/rglru_scan.cu``): the
RG-LRU recurrence h_t = a_t ⊙ h_{t−1} + b_t over (B, S, W) f32, h_{−1} = 0.

Replaces :func:`repro.kernels.rglru_scan.rglru_scan`.  Its plain version is
:func:`repro_torch.kernels.ref.rglru_scan_ref`; :mod:`.ops` picks one or
the other by the tensor's device.  ``rglru_scan_bwd`` is the backward kernel
(``scan_bwd_f32`` in ``csrc/ssm_scan.cu``, shared with ``ssm_scan_bwd``
over the lanes flattened): the reference has no Pallas backward (XLA
differentiates its associative scan); its plain version is
:func:`repro_torch.kernels.ref.scan_bwd_ref`.
"""

from __future__ import annotations

import torch

from . import build
from .ssm_scan import scan_bwd

# Kernel launches since the last reset (a run sets them to 0 and reads
# them): the forward's and the backward's.
launches = 0
bwd_launches = 0


def rglru_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a, b: contiguous (B, S, W) float32 on one CUDA device → all h_t
    (B, S, W) float32, bit-equal to the sequential recurrence."""
    global launches
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError("rglru_scan kernel needs a and b on one CUDA device, "
                         f"got {a.device}, {b.device}")
    if a.dtype != torch.float32 or b.dtype != torch.float32:
        raise ValueError(f"rglru_scan kernel takes float32, got {a.dtype}, "
                         f"{b.dtype}")
    if a.dim() != 3 or b.shape != a.shape or \
            not all(0 < n < 2 ** 31 for n in a.shape) or a.shape[0] > 65535:
        raise ValueError(f"rglru_scan kernel shapes: a {tuple(a.shape)}, "
                         f"b {tuple(b.shape)}; needs (B, S, W)")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError("rglru_scan kernel needs contiguous tensors")
    B, S, W = a.shape
    h = torch.empty_like(a)
    fn = build.load("rglru_scan").rglru_scan_f32
    with torch.cuda.device(a.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(a.data_ptr(), b.data_ptr(), h.data_ptr(), B, S, W, stream)
    if err != 0:
        raise RuntimeError(f"rglru_scan kernel launch failed: cudaError {err}")
    launches += 1
    return h


def rglru_scan_bwd(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor):
    """The recurrence's gradients given g = ∂L/∂h: a, h and g contiguous
    (B, S, W) float32 on one CUDA device → (da, db), through
    :func:`repro_torch.kernels.ssm_scan.scan_bwd`."""
    global bwd_launches
    if a.dim() != 3:
        raise ValueError(f"rglru_scan_bwd kernel shapes: a {tuple(a.shape)}; "
                         "needs (B, S, W)")
    da, db = scan_bwd(a, h, g, "rglru_scan_bwd")
    bwd_launches += 1
    return da, db
