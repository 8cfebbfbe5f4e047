"""Stopping conditions (CHECKFORSTOP of Algorithm 1), in float32.

Port of :mod:`repro.core.stopping`: all eight conditions.  A condition is a
function ``check(frame) -> (stop: bool 0-d tensor, aux: dict)`` evaluated
on a consistent reduced state.  The conditions of the instance layer read
only ``num`` and scalar frame leaves, which every strategy (SHARED_FRAME
shards included) holds fully reduced, so they are shard-safe.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .frames import StateFrame, tree_map

_F32 = torch.float32


def _log_safe(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=1e-30))


def hoeffding_tau_needed(eps: float, delta: float,
                         value_range: float = 1.0, device=None) -> torch.Tensor:
    """Hoeffding (ε,δ) sample bound: τ ≥ (range²/(2ε²))·log(2/δ)."""
    return (value_range ** 2) / (2.0 * eps ** 2) * torch.log(
        torch.tensor(2.0 / delta, dtype=_F32, device=device))


def empirical_bernstein_half_width(s1: torch.Tensor, s2: torch.Tensor,
                                   tau: torch.Tensor, delta: float,
                                   value_range: float = 1.0):
    """Maurer–Pontil EB half-width from the running moments Σx, Σx²:
    (mean, sqrt(2 V̂ log(3/δ)/τ) + 3 R log(3/δ)/τ)."""
    mean = s1 / tau
    var = torch.clamp(s2 / tau - mean ** 2, min=0.0)
    log3d = torch.log(torch.tensor(3.0 / delta, dtype=_F32, device=s1.device))
    half = torch.sqrt(2.0 * var * log3d / tau) + 3.0 * value_range * log3d / tau
    return mean, half


@dataclasses.dataclass(frozen=True)
class KadabraCondition:
    """KADABRA stopping condition (paper App. B): stop when the per-vertex
    bounds f ≤ ε and g ≤ ε for every vertex, or when τ ≥ ω.  δ_L = δ_U =
    δ/(2n) (uniform allocation)."""

    eps: float
    delta: float
    omega: float
    n_vertices: int

    def per_vertex_bounds(self, btilde: torch.Tensor, tau: torch.Tensor
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
        dl = self.delta / (2.0 * self.n_vertices)
        L = -_log_safe(torch.tensor(dl, dtype=_F32, device=btilde.device))
        tau = torch.clamp(tau.to(_F32), min=1.0)
        r = self.omega / tau
        b = btilde.to(_F32)
        f = (L / tau) * ((1.0 / 3.0 - r) +
                         torch.sqrt((1.0 / 3.0 - r) ** 2 + 2.0 * b * self.omega / L))
        g = (L / tau) * ((1.0 / 3.0 + r) +
                         torch.sqrt((1.0 / 3.0 + r) ** 2 + 2.0 * b * self.omega / L))
        return f, g

    def __call__(self, frame: StateFrame):
        tau = frame.num.to(_F32)
        btilde = frame.data.to(_F32) / torch.clamp(tau, min=1.0)
        f, g = self.per_vertex_bounds(btilde, tau)
        max_f, max_g = torch.max(f), torch.max(g)
        bounds_ok = (max_f <= self.eps) & (max_g <= self.eps)
        omega_hit = tau >= self.omega
        stop = (tau > 0) & (bounds_ok | omega_hit)
        aux = {"btilde": btilde, "max_f": max_f, "max_g": max_g, "tau": tau}
        return stop, aux


@dataclasses.dataclass(frozen=True)
class HoeffdingCondition:
    """Stop when the Hoeffding (ε,δ) bound for a bounded mean holds:
    τ ≥ (range²/(2ε²))·log(2/δ).  frame.data = Σ x_i (a tensor or a dict)."""

    eps: float
    delta: float
    value_range: float = 1.0

    def __call__(self, frame: StateFrame):
        tau = frame.num.to(_F32)
        need = hoeffding_tau_needed(self.eps, self.delta, self.value_range,
                                    device=tau.device)
        mean = tree_map(lambda s: s.to(_F32) / torch.clamp(tau, min=1.0),
                        frame.data)
        return tau >= need, {"mean": mean, "tau": tau, "tau_needed": need}


def _moments(frame: StateFrame, scale: float = 1.0):
    """τ (at least 2) and the f32 moments s1/scale, s2/scale² of a frame."""
    tau = torch.clamp(frame.num.to(_F32), min=2.0)
    s1 = frame.data["s1"].to(_F32) / scale
    s2 = frame.data["s2"].to(_F32) / scale ** 2
    return tau, s1, s2


@dataclasses.dataclass(frozen=True)
class EmpiricalBernsteinCondition:
    """Empirical-Bernstein stopping (Maurer & Pontil) for mean estimation;
    frame.data = {"s1": Σx, "s2": Σx²}: stop once the half-width ≤ ε."""

    eps: float
    delta: float
    value_range: float = 1.0

    def __call__(self, frame: StateFrame):
        tau, s1, s2 = _moments(frame)
        mean, half = empirical_bernstein_half_width(s1, s2, tau, self.delta,
                                                    self.value_range)
        stop = (frame.num >= 2) & (torch.max(half) <= self.eps)
        return stop, {"mean": mean, "half_width": half, "tau": frame.num}


@dataclasses.dataclass(frozen=True)
class WedgeClosureCondition:
    """Triangle counting via wedge sampling: Hoeffding on the closure
    probability p = 3T/W, stop once τ ≥ (1/(2ε²))·log(2/δ).  The verdict
    reads only ``num``."""

    eps: float                 # absolute error on the closure probability
    delta: float
    total_wedges: float = 1.0  # W — for the count-scale tolerance in aux

    def __call__(self, frame: StateFrame):
        tau = frame.num.to(_F32)
        need = hoeffding_tau_needed(self.eps, self.delta, device=tau.device)
        aux = {"tau": tau, "tau_needed": need,
               "eps_count": torch.tensor(self.eps * self.total_wedges / 3.0,
                                         dtype=_F32, device=tau.device)}
        return tau >= need, aux


@dataclasses.dataclass(frozen=True)
class PercolationCondition:
    """Monte-Carlo s–t reachability: empirical Bernstein on the indicator,
    stop once the half-width ≤ ε, or at the static cap ``max_samples``."""

    eps: float
    delta: float
    max_samples: int = 1 << 20

    def __call__(self, frame: StateFrame):
        tau, s1, s2 = _moments(frame)
        mean, half = empirical_bernstein_half_width(s1, s2, tau, self.delta)
        eb_ok = (frame.num >= 2) & (half <= self.eps)
        stop = eb_ok | (frame.num >= self.max_samples)
        return stop, {"p_hat": mean, "half_width": half, "tau": frame.num}


@dataclasses.dataclass(frozen=True)
class RelativeErrorCondition:
    """Relative-error stopping for weighted-mean estimation (the wrs
    workload): stop once the empirical-Bernstein half-width ≤ rtol·μ̂, or at
    the static cap ``max_samples``.  Frames carry s1 = Σ xq, s2 = Σ xq² of
    values quantized as x = xq/``scale``."""

    rtol: float
    delta: float
    scale: float = 1.0
    value_range: float = 1.0
    min_samples: int = 2
    max_samples: int = 1 << 20

    def __call__(self, frame: StateFrame):
        tau, s1, s2 = _moments(frame, self.scale)
        mean, half = empirical_bernstein_half_width(s1, s2, tau, self.delta,
                                                    self.value_range)
        rel_ok = half <= self.rtol * torch.clamp(mean, min=1e-12)
        stop = ((frame.num >= self.min_samples) & rel_ok) | \
            (frame.num >= self.max_samples)
        return stop, {"mean": mean, "half_width": half, "tau": frame.num}


@dataclasses.dataclass(frozen=True)
class EccentricityGapCondition:
    """Double-sweep diameter estimation: stop once ``min_certs`` gap
    certificates have accumulated, or at the static cap ``max_samples``."""

    gap: int = 0
    min_certs: int = 1
    max_samples: int = 1 << 16

    def __call__(self, frame: StateFrame):
        certs = frame.data["cert"]
        stop = (certs >= self.min_certs) | (frame.num >= self.max_samples)
        return stop, {"certs": certs, "tau": frame.num,
                      "gap": torch.tensor(self.gap, dtype=torch.int32,
                                          device=certs.device)}


@dataclasses.dataclass(frozen=True)
class GradVarianceCondition:
    """Adaptive gradient accumulation: stop once the relative standard
    error of the mean gradient norm (frame.data = {"s1": Σ‖g‖, "s2":
    Σ‖g‖²}) is ≤ ``rtol``, or at the static cap ``max_samples``."""

    rtol: float
    min_samples: int = 2
    max_samples: int = 4096

    def __call__(self, frame: StateFrame):
        tau = torch.clamp(frame.num.to(_F32), min=1.0)
        s1 = frame.data["s1"].to(_F32)
        s2 = frame.data["s2"].to(_F32)
        mean = s1 / tau
        var = torch.clamp(s2 / tau - mean ** 2, min=0.0)
        rel = torch.sqrt(var / tau) / torch.clamp(mean, min=1e-12)
        stop = ((frame.num >= self.min_samples) & (rel <= self.rtol)) | \
            (frame.num >= self.max_samples)
        return stop, {"rel_sem": rel, "mean_norm": mean, "tau": frame.num}


def kadabra_omega(eps: float, delta: float, vd_upper: int, c: float = 0.5) -> float:
    """Static maximal sample count ω = (c/ε²)·(⌊log₂(VD−2)⌋ + 1 + log(1/δ))."""
    vd = max(int(vd_upper), 4)
    return (c / eps ** 2) * (math.floor(math.log2(vd - 2)) + 1 + math.log(1.0 / delta))
