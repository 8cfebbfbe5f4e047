"""Alias tables (Walker/Vose) and the weighted-mean ADS workload.

Port of :mod:`repro.sampling.alias`.  An alias table turns n positive
weights into O(1) draws: bucket ``i = ⌊u₁·n⌋`` is kept with probability
``prob[i]`` and redirected to ``alias[i]`` otherwise.  The table is built on
the host by the same two-stack Vose loop as the reference, in float64, so
both packages give bit-identical ``prob``/``alias`` for the same weights.

Frame layout (all integer, so every strategy reduces exactly):

    frame.num  — number of draws
    frame.data — {"s1": Σ xq (int32 scalar), "s2": Σ xq² (int32 scalar),
                  "hist": (n_pad,) int32 per-item draw counts}

with values quantized as x = xq / value_scale.  The int32 moment sums stay
exact while ``num · (value_scale−1)² < 2³¹``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from ..core.frames import StateFrame
from ..device import resolve_device
from ..kernels import ops

VALUE_SCALE = 32


@dataclasses.dataclass(frozen=True)
class AliasTable:
    """Walker alias table: draw ⌊u₁·n⌋, keep w.p. ``prob``, else ``alias``."""

    n: int
    prob: torch.Tensor    # (n,) float32 — acceptance threshold per bucket
    alias: torch.Tensor   # (n,) int32   — redirect target per bucket

    def to(self, device) -> "AliasTable":
        return AliasTable(n=self.n, prob=self.prob.to(device),
                          alias=self.alias.to(device))


def build_alias_table(weights: np.ndarray, device=None) -> AliasTable:
    """Vose's O(n) two-stack construction, in float64 on the host, then
    cast and put on ``device`` (``None`` → the CUDA card).

    The loop is the reference's, step for step, on Python floats (IEEE
    doubles, as numpy's float64 scalars) so that it runs faster.
    """
    w = np.asarray(weights, np.float64).reshape(-1)
    if w.size == 0:
        raise ValueError("alias table needs at least one weight")
    if not np.all(np.isfinite(w)) or np.any(w < 0.0):
        raise ValueError("weights must be finite and non-negative")
    total = float(w.sum())
    if total <= 0.0:
        raise ValueError("weights must not all be zero")
    n = w.size
    scaled_np = w / total * n
    scaled = scaled_np.tolist()
    prob = [1.0] * n
    alias = list(range(n))
    small = np.flatnonzero(scaled_np < 1.0).tolist()
    large = np.flatnonzero(scaled_np >= 1.0).tolist()
    while small and large:
        s = small.pop()
        g = large.pop()
        prob[s] = scaled[s]
        alias[s] = g
        scaled[g] = (scaled[g] + scaled[s]) - 1.0
        (small if scaled[g] < 1.0 else large).append(g)
    # leftovers are ≈1 up to rounding: keep with probability 1
    for i in small + large:
        prob[i] = 1.0
        alias[i] = i
    return AliasTable(
        n=n, prob=torch.from_numpy(np.asarray(prob, np.float64).astype(np.float32)),
        alias=torch.from_numpy(np.asarray(alias, np.int64).astype(np.int32))
    ).to(resolve_device(device))


def alias_draw_probabilities(table: AliasTable) -> np.ndarray:
    """Exact per-item draw probability implied by the table:
    P(i) = (prob[i] + Σ_{j: alias[j]=i} (1 − prob[j])) / n."""
    prob = table.prob.cpu().numpy().astype(np.float64)
    alias = table.alias.cpu().numpy()
    p = prob.copy()
    np.add.at(p, alias, 1.0 - prob)
    return p / table.n


def weighted_mean_exact(weights: np.ndarray, values_q: np.ndarray,
                        value_scale: int = VALUE_SCALE) -> float:
    """Exact estimand μ = Σᵢ pᵢ·(xqᵢ/scale) — the workload oracle (O(n))."""
    w = np.asarray(weights, np.float64)
    x = np.asarray(values_q, np.float64) / float(value_scale)
    return float((w * x).sum() / w.sum())


def make_weighted_sample_fn(table: AliasTable, values_q: torch.Tensor,
                            batch: int, *, pad_to: Optional[int] = None):
    """Build SAMPLE(): ``sample_fn(gens, carry)`` makes ``batch`` alias
    draws for each of the ``len(gens)`` workers.

    Worker w draws its uniforms u1 then u2, (batch,) each, from ``gens[w]``
    only; the W·batch draws of a round are ONE ``ops.alias_draw`` launch.
    The table and ``values_q`` must lie on the device of the generators.
    """
    n = table.n
    n_pad = pad_to or n
    values_q = values_q.to(torch.int32)
    dev = values_q.device

    def sample_fn(gens, carry):
        W = len(gens)
        u = torch.stack([torch.rand((2, batch), generator=gen, device=dev)
                         for gen in gens])                    # (W, 2, batch)
        u1 = u[:, 0].reshape(-1)
        u2 = u[:, 1].reshape(-1)
        idx = ops.alias_draw(table.prob, table.alias, u1, u2).long()
        xq = values_q[idx].view(W, batch)
        flat = (torch.arange(W, device=dev).repeat_interleave(batch) * n_pad
                + idx)
        hist = torch.zeros(W * n_pad, dtype=torch.int32, device=dev)
        hist.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
        data = {"s1": xq.sum(dim=1, dtype=torch.int32),
                "s2": (xq * xq).sum(dim=1, dtype=torch.int32),
                "hist": hist.view(W, n_pad)}
        num = torch.full((W,), batch, dtype=torch.int32, device=dev)
        return StateFrame(num=num, data=data), carry

    return sample_fn


def weighted_frame_template(n: int, pad_to: Optional[int] = None,
                            device=None):
    n_pad = pad_to or n
    device = resolve_device(device)
    z = torch.zeros((), dtype=torch.int32, device=device)
    return {"s1": z, "s2": z.clone(),
            "hist": torch.zeros((n_pad,), dtype=torch.int32, device=device)}
