"""Adaptive gradient accumulation — the paper's ADS engine applied to
training.  Port of :mod:`repro.optim.adaptive`.

SAMPLE() = one micro-batch gradient; the frame holds (Σ‖g‖, Σ‖g‖², num);
CHECKFORSTOP = :class:`repro_torch.core.stopping.GradVarianceCondition`
(stop once the relative standard error of the gradient-norm estimate is
below target).  The accumulated Σg/num is the gradient the optimizer
consumes.  The reference's device-level ``lax.while_loop`` is a host loop
here, which reads the verdict once a micro-batch (one counted
``device.to_host``).

Also the instance pieces (the ``gradvar`` workload): estimate the mean
per-example gradient norm of a FIXED linear-regression iterate over a
fixed example population.  Norms are integer-quantized so frames reduce
exactly under every strategy; the oracle is the population mean, O(n).
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Tuple

import numpy as np
import torch

from ..core.frames import StateFrame, combine
from ..core.stopping import GradVarianceCondition
from ..device import resolve_device, to_host
from .adamw import global_norm


def quantized_grad_norms(n_examples: int, dim: int, seed: int,
                         value_scale: int):
    """Per-example gradient norms of a linear-regression iterate, quantized
    to ``1 … value_scale−1``.  Returns (gq int32 (n,) numpy, exact mean of
    gq/scale).  The same numpy calls as the reference, so the same array."""
    rng = np.random.default_rng(seed)
    X = rng.normal(size=(n_examples, dim))
    w_true = rng.normal(size=(dim,))
    y = X @ w_true + 0.1 * rng.normal(size=n_examples)
    w = w_true + 0.5 * rng.normal(size=(dim,))     # a mid-training iterate
    g = (X @ w - y)[:, None] * X                   # ∇ of ½(x·w − y)² per row
    norms = np.linalg.norm(g, axis=1)
    norms = norms / norms.max()
    gq = np.maximum(1, np.round(norms * (value_scale - 1))).astype(np.int32)
    return gq, float(gq.mean()) / value_scale


def gradnorm_frame_template(n_examples: int, pad_to: int, device=None):
    device = resolve_device(device)
    z = torch.zeros((), dtype=torch.int32, device=device)
    return {"s1": z, "s2": z.clone(),
            "hits": torch.zeros((pad_to,), dtype=torch.int32, device=device)}


def make_gradnorm_sample_fn(gq: torch.Tensor, batch: int, pad_to: int):
    """SAMPLE(): each of the ``len(gens)`` workers draws ``batch`` example
    indices uniformly from ``gens[w]`` and accumulates Σgq, Σgq² and
    per-example hit counts.  ``gq`` lies on the generators' device."""
    gq = gq.to(torch.int32)
    n, dev = gq.shape[0], gq.device

    def sample_fn(gens, carry):
        W = len(gens)
        idx = torch.stack([torch.randint(0, n, (batch,), generator=gen,
                                         device=dev) for gen in gens])
        v = gq[idx]                                          # (W, batch)
        rows = torch.arange(W, device=dev)[:, None] * pad_to
        hits = torch.zeros(W * pad_to, dtype=torch.int32, device=dev)
        hits.index_add_(0, (rows + idx).reshape(-1),
                        torch.ones(W * batch, dtype=torch.int32, device=dev))
        data = {"s1": v.sum(dim=1, dtype=torch.int32),
                "s2": (v * v).sum(dim=1, dtype=torch.int32),
                "hits": hits.view(W, pad_to)}
        num = torch.full((W,), batch, dtype=torch.int32, device=dev)
        return StateFrame(num=num, data=data), carry

    return sample_fn


@dataclasses.dataclass(frozen=True)
class AdaptiveAccumConfig:
    rtol: float = 0.25
    min_micro: int = 2
    max_micro: int = 16


def adaptive_accumulate(
        grad_fn: Callable[[Mapping, Dict], Tuple[torch.Tensor, Dict[str, torch.Tensor]]],
        params: Mapping[str, torch.Tensor], micro_batches: Dict[str, torch.Tensor],
        cfg: AdaptiveAccumConfig
) -> Tuple[Dict[str, torch.Tensor], torch.Tensor, int, torch.Tensor]:
    """micro_batches: leaves with a leading dim of at least ``max_micro``;
    ``grad_fn(params, batch)`` → (loss, grads by name).  Draws micro-batches
    in order until the condition holds (after ``min_micro``) or
    ``max_micro`` were drawn.

    Returns (mean f32 grads, mean loss, micro-batches used, rel_sem)."""
    cond = GradVarianceCondition(rtol=cfg.rtol, min_samples=cfg.min_micro,
                                 max_samples=cfg.max_micro)
    dev = next(iter(params.values())).device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    frame = StateFrame(num=torch.zeros((), dtype=torch.int32, device=dev),
                       data={"s1": zero, "s2": zero})
    one = torch.ones((), dtype=torch.int32, device=dev)
    gsum: Dict[str, torch.Tensor] = {}
    loss_sum = zero
    i = 0
    while i < cfg.max_micro:
        loss, g = grad_fn(params, {k: v[i] for k, v in micro_batches.items()})
        gn = global_norm(g)
        frame = combine(frame, StateFrame(num=one, data={"s1": gn,
                                                         "s2": torch.square(gn)}))
        for name, x in g.items():
            if name in gsum:
                gsum[name].add_(x.float())
            else:
                gsum[name] = x.float().clone()
        del g
        loss_sum = loss_sum + loss.float()
        stop, _ = cond(frame)
        i += 1
        if to_host(stop):
            break
    n = float(max(i, 1))
    grads = {k: v.div_(n) for k, v in gsum.items()}
    _, aux = cond(frame)
    return grads, loss_sum / n, i, aux["rel_sem"]
