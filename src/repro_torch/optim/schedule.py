"""LR schedules (pure functions of the step counter).  Port of
:mod:`repro.optim.schedule`."""

from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, peak: float, warmup: int, total: int,
                    floor: float = 0.1):
    """Linear warm-up to ``peak`` over ``warmup`` steps, then a cosine
    decay to ``floor · peak`` at ``total``.  A tensor step gives an f32
    tensor, an int or float step a float."""
    if isinstance(step, torch.Tensor):
        s = step.float()
        warm = peak * s / max(warmup, 1)
        t = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = floor * peak + (1 - floor) * peak * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(s < warmup, warm, cos)
    s = float(step)
    if s < warmup:
        return peak * s / max(warmup, 1)
    t = min(max((s - warmup) / max(total - warmup, 1), 0.0), 1.0)
    return floor * peak + (1 - floor) * peak * 0.5 * (1 + math.cos(math.pi * t))
