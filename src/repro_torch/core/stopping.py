"""Stopping conditions (CHECKFORSTOP of Algorithm 1), in float32.

Port of the parts of :mod:`repro.core.stopping` that KADABRA uses; the
other conditions come with their workloads.  A condition is a function
``check(frame) -> (stop: bool 0-d tensor, aux: dict)`` evaluated on a
consistent reduced state.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch

from .frames import StateFrame

_F32 = torch.float32


def _log_safe(x: torch.Tensor) -> torch.Tensor:
    return torch.log(torch.clamp(x, min=1e-30))


def hoeffding_tau_needed(eps: float, delta: float,
                         value_range: float = 1.0) -> torch.Tensor:
    """Hoeffding (ε,δ) sample bound: τ ≥ (range²/(2ε²))·log(2/δ)."""
    return (value_range ** 2) / (2.0 * eps ** 2) * torch.log(
        torch.tensor(2.0 / delta, dtype=_F32))


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


def kadabra_omega(eps: float, delta: float, vd_upper: int, c: float = 0.5) -> float:
    """Static maximal sample count ω = (c/ε²)·(⌊log₂(VD−2)⌋ + 1 + log(1/δ))."""
    vd = max(int(vd_upper), 4)
    return (c / eps ** 2) * (math.floor(math.log2(vd - 2)) + 1 + math.log(1.0 / delta))
