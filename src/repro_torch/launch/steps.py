"""Step functions: prefill and one serving (decode) step.

Port of :mod:`repro.launch.steps` for serving; the train step
(``make_train_step``, with AdamW and gradient accumulation) is still to
port (ROADMAP queue 1 item 10.3).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..models import Model


def make_prefill_step(model: Model) -> Callable:
    """prefill_step(batch) → (B, V_padded) last-position logits."""

    def prefill_step(batch):
        return model.prefill(batch)

    return prefill_step


def make_serve_step(model: Model) -> Callable:
    """serve_step(cache, batch) → (cache, next tokens): greedy decode, the
    first of equal logits winning, as ``jnp.argmax`` does."""

    def serve_step(cache, batch):
        cache, logits = model.decode_step(cache, batch)
        return cache, torch.argmax(logits, dim=-1).to(torch.int32)

    return serve_step
