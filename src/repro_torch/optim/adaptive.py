"""Adaptive gradient accumulation as an ADS instance (the ``gradvar``
workload).  Port of the instance pieces of :mod:`repro.optim.adaptive`:
estimate the mean per-example gradient norm of a FIXED linear-regression
iterate over a fixed example population.  Norms are integer-quantized so
frames reduce exactly under every strategy; the oracle is the population
mean, O(n).
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.frames import StateFrame
from ..device import resolve_device


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
