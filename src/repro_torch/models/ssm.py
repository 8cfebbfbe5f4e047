"""Linear-recurrence helpers shared by the recurrent blocks.

Port of the helpers of :mod:`repro.models.ssm`.  The reference runs the
recurrence as an associative scan (the oracle of its Pallas scans); here a
3-D (B, S, W) scan goes through the hand-written ``rglru_scan`` kernel
(``kernels.ops.rglru_scan``), which computes the same recurrence in
sequential order.  The Mamba block and its 4-D scan wait for the next slice.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..kernels import ops


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None, axis: int = 1) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t−1} + b_t along ``axis`` (1), all h_t; ``h0`` is
    folded into the first b: h_1 = a_1·h0 + b_1, as the reference does."""
    if axis != 1:
        raise NotImplementedError(f"linear_scan runs along axis 1, got {axis}")
    if a.dim() != 3:
        raise NotImplementedError(
            f"linear_scan over {a.dim()}-D (B, S, D, N) tensors is the Mamba "
            "scan, ssm_scan: still to port (ROADMAP queue 2 item 5)")
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    return ops.rglru_scan(a.float().contiguous(), b.float().contiguous())


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (K, C), b (C,), as K shifted
    adds in f32; ``tail`` (B, K−1, C) is the context before x."""
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                 # (B, S+K−1, C)
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xp[:, i:i + S, :].float() * w[i].float()
    return (y + b.float()).to(x.dtype)
