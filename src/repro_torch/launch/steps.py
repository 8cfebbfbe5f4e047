"""Step functions: train (gradient accumulation + AdamW), prefill, and one
serving (decode) step.  Port of :mod:`repro.launch.steps`.

The train step updates the model's parameters and the optimizer's moments
in place (the reference returns new trees): ``train_step(opt_state,
batch)`` → ``(opt_state, metrics)``.  The model must have opted into
gradients (``model.requires_grad_(True)``).
"""

from __future__ import annotations

import contextlib
from typing import Callable, Dict, Optional

import torch

from ..models import Model
from ..optim.adamw import AdamWConfig, AdamWState, adamw_update


def loss_and_grads(model: Model, params: Dict[str, torch.Tensor], batch,
                   phase: Optional[Callable] = None):
    """``model.train_loss(batch)`` and its gradients by parameter name, in
    the parameters' dtypes (``torch.autograd.grad``; no ``.grad`` is
    set).  ``phase(name)``, a context manager, marks the forward and the
    backward (``analysis.comms.Phases``)."""
    phase = phase or _no_phase
    with phase("forward"):
        loss = model.train_loss(batch)
    with phase("backward"):
        grads = torch.autograd.grad(loss, list(params.values()))
    return loss.detach(), dict(zip(params, grads))


def _no_phase(name: str):
    return contextlib.nullcontext()


def _f32_zeros(x: torch.Tensor) -> torch.Tensor:
    """f32 zeros of ``x``'s shape in its layout: a DTensor's placements,
    partial sums included (each rank allocating its local tensor alone)."""
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    return DTensor.from_local(
        torch.zeros(x.to_local().shape, dtype=torch.float32, device=x.device),
        x.device_mesh, x.placements, run_check=False, shape=x.shape,
        stride=x.stride())


def _local(x: torch.Tensor) -> torch.Tensor:
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x


def _as_layout(x: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``x`` in ``like``'s placements, where both are DTensors (a later
    micro-batch's gradient in the accumulator's layout; a no-op when they
    agree, as they do for the same step)."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor) and tuple(x.placements) != tuple(like.placements):
        return x.redistribute(x.device_mesh, like.placements)
    return x


def make_train_step(model: Model, opt_cfg: Optional[AdamWConfig] = None,
                    phase: Optional[Callable] = None) -> Callable:
    """train_step(opt_state, batch) → (opt_state, metrics).

    ``batch`` leaves are (B, …) or (n_micro, mb, …); micro-batches run in
    order with f32 gradient accumulation, and the summed loss and gradients
    are divided by n_micro (``optim.adaptive_accumulate`` is the adaptive
    variant the training loop uses with ``--adaptive``).  Then one AdamW
    step.  metrics: ``loss``, ``grad_norm`` (pre-clip) and ``step``, as
    0-d tensors on the model's device.

    On a mesh (parameters and moments DTensors, ``launch.sharded``) the
    same step runs on each rank's shards: a gradient comes in the layout
    DTensor's backward gives it (partial sums over the data axes for a
    weight the data ranks replicate), the f32 accumulators keep that
    layout (no communication a micro-batch), and ``adamw_update`` moves
    each to its moment's layout once a step.  The metrics are replicated:
    plain tensors, equal on every rank.  ``phase(name)`` marks the
    forward, the backward and the optimizer (``analysis.comms.Phases``);
    the loss, a replicated DTensor, is returned as its local value.
    ``train_step.stats["grad_bytes"]`` is the bytes of this process's
    gradients (the f32 accumulators) in the last step."""
    opt_cfg = opt_cfg or AdamWConfig()
    stats = {"grad_bytes": 0}
    params = dict(model.named_parameters())
    phase = phase or _no_phase

    def train_step(opt_state: AdamWState, batch):
        tokens = batch["tokens"]
        if tokens.dim() == 3:  # (n_micro, mb, S): accumulate in f32
            n_micro = tokens.shape[0]
            grads = None
            loss = torch.zeros((), dtype=torch.float32, device=tokens.device)
            for i in range(n_micro):
                lo, g = loss_and_grads(model, params,
                                       {k: v[i] for k, v in batch.items()},
                                       phase)
                if grads is None:   # in the gradients' layout
                    grads = {k: _f32_zeros(x) for k, x in g.items()}
                for k, x in g.items():
                    _local(grads[k]).add_(_local(_as_layout(x, grads[k]))
                                          .float())
                del g
                loss = loss + lo
            for x in grads.values():
                _local(x).div_(n_micro)
            loss = loss / n_micro
        else:
            loss, grads = loss_and_grads(model, params, batch, phase)
        stats["grad_bytes"] = sum(_local(x).numel() * x.element_size()
                                  for x in grads.values())
        with phase("optimizer"):
            _, opt_state, gnorm = adamw_update(grads, opt_state, params,
                                               opt_cfg)
        del grads
        return opt_state, {"loss": _local(loss), "grad_norm": gnorm,
                           "step": opt_state.step}

    train_step.stats = stats
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
