"""Step functions: train (gradient accumulation + AdamW), prefill, and one
serving (decode) step.  Port of :mod:`repro.launch.steps`.

The train step updates the model's parameters and the optimizer's moments
in place (the reference returns new trees): ``train_step(opt_state,
batch)`` → ``(opt_state, metrics)``.  The model must have opted into
gradients (``model.requires_grad_(True)``).
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from ..models import Model
from ..optim.adamw import AdamWConfig, AdamWState, adamw_update


def loss_and_grads(model: Model, params: Dict[str, torch.Tensor], batch):
    """``model.train_loss(batch)`` and its gradients by parameter name, in
    the parameters' dtypes (``torch.autograd.grad``; no ``.grad`` is
    set)."""
    loss = model.train_loss(batch)
    grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None
                    ) -> Callable:
    """train_step(opt_state, batch) → (opt_state, metrics).

    ``batch`` leaves are (B, …) or (n_micro, mb, …); micro-batches run in
    order with f32 gradient accumulation, and the summed loss and gradients
    are divided by n_micro (``optim.adaptive_accumulate`` is the adaptive
    variant the training loop uses with ``--adaptive``).  Then one AdamW
    step.  metrics: ``loss``, ``grad_norm`` (pre-clip) and ``step``, as
    0-d tensors on the model's device."""
    opt_cfg = opt_cfg or AdamWConfig()
    params = dict(model.named_parameters())

    def train_step(opt_state: AdamWState, batch):
        tokens = batch["tokens"]
        if tokens.dim() == 3:  # (n_micro, mb, S): accumulate in f32
            n_micro = tokens.shape[0]
            grads = {k: torch.zeros(p.shape, dtype=torch.float32,
                                    device=p.device) for k, p in params.items()}
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n_micro):
                lo, g = loss_and_grads(model, params,
                                       {k: v[i] for k, v in batch.items()})
                for k, x in g.items():
                    grads[k].add_(x.float())
                del g
                loss = loss + lo
            for x in grads.values():
                x.div_(n_micro)
            loss = loss / n_micro
        else:
            loss, grads = loss_and_grads(model, params, batch)
        _, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        del grads
        return opt_state, {"loss": loss, "grad_norm": gnorm,
                           "step": opt_state.step}

    return train_step


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
        return cache, torch.argmax(_whole_vocab(logits), dim=-1).to(torch.int32)

    return serve_step


def _whole_vocab(logits: torch.Tensor) -> torch.Tensor:
    """Logits (B, V) with the vocab whole on every rank where they are a
    vocab-sharded DTensor (one small all-gather), so that the argmax is a
    local one; a plain tensor as it is."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(logits, DTensor):
        return logits
    pl = tuple(Replicate() if p == Shard(logits.dim() - 1) else p
               for p in logits.placements)
    return logits.redistribute(logits.device_mesh, pl)


def step_for(model: Model, kind: str) -> Callable:
    """The step of one kind: "train", "prefill", else the serving step."""
    if kind == "train":
        return make_train_step(model)
    if kind == "prefill":
        return make_prefill_step(model)
    return make_serve_step(model)
