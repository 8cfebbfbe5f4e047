"""Parameter definitions, initialisation and the shared numerics.

Port of :mod:`repro.models.layers` without its sharding rules (those are
mesh-specific, ROADMAP queue 1 item 11).  A :class:`ParamDef` gives a
parameter's shape, dtype and init kind; :class:`Params` holds one block's
parameters as an ``nn.Module`` whose names are the reference tree's keys,
and reads like the reference's dict (``p["w_in"]``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn


@dataclasses.dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"                   # normal | zeros | ones | scaled
    scale: float = 1.0
    fan_in: int = 0                        # contraction size for "scaled"
                                           # (0 → shape[-2], or shape[-1]
                                           # for a vector)


def _trunc_normal(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard normal truncated to [−2, 2], f32, by the inverse CDF."""
    lo, hi = (0.5 * (1.0 + math.erf(x / math.sqrt(2.0))) for x in (-2.0, 2.0))
    u = torch.rand(shape, generator=generator, device=generator.device)
    x = torch.erfinv(2.0 * (lo + u * (hi - lo)) - 1.0) * math.sqrt(2.0)
    return x.clamp_(-2.0, 2.0)


def init_leaf(d: ParamDef, generator: torch.Generator) -> torch.Tensor:
    """One parameter's initial value on the generator's device, with the
    reference's init kinds: truncated normal (±2)·scale/√fan_in for
    ``scaled``, normal·scale·0.02 for ``normal``, zeros and ones."""
    dev = generator.device
    if d.init == "zeros":
        return torch.zeros(d.shape, dtype=d.dtype, device=dev)
    if d.init == "ones":
        return torch.ones(d.shape, dtype=d.dtype, device=dev)
    if d.init == "scaled":
        fan_in = d.fan_in or (d.shape[-2] if len(d.shape) >= 2 else d.shape[-1])
        std = d.scale / math.sqrt(max(fan_in, 1))
        return (_trunc_normal(d.shape, generator) * std).to(d.dtype)
    return (torch.randn(d.shape, generator=generator, device=dev)
            * (d.scale * 0.02)).to(d.dtype)


def register_params(module: nn.Module, defs: Dict[str, ParamDef],
                    device: torch.device) -> None:
    """Give ``module`` one uninitialised parameter per def, under the def's
    name, and keep the defs as ``module.defs``."""
    module.defs = defs
    for name, d in defs.items():
        module.register_parameter(name, nn.Parameter(
            torch.empty(d.shape, dtype=d.dtype, device=device),
            requires_grad=False))


class Params(nn.Module):
    """The parameters of one block, named as in the reference's tree and
    allocated uninitialised; ``Model.init`` or ``load_state_dict`` fills
    them.  Serving needs no gradients, so none are tracked: a trainer opts
    in with ``model.requires_grad_(True)`` (``launch/steps.py``,
    ``launch/train.py``)."""

    def __init__(self, defs: Dict[str, ParamDef], device: torch.device):
        super().__init__()
        register_params(self, defs, device)

    def __getitem__(self, name: str) -> torch.Tensor:
        return getattr(self, name)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------

def rms_norm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """x · rsqrt(mean(x²) + eps), the factor cast to x's dtype, then · w."""
    var = torch.mean(torch.square(x.float()), dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps).to(x.dtype)) * w


def rotary(q: torch.Tensor, k: torch.Tensor, positions: torch.Tensor,
           theta: float = 10_000.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """RoPE, half-split (not interleaved), on (..., S, H, hd) q/k given
    (..., S) positions."""
    hd = q.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=q.device) / half)
    ang = positions[..., None].float() * freqs                # (..., S, half)
    cos = torch.cos(ang)[..., None, :]                        # (..., S, 1, half)
    sin = torch.sin(ang)[..., None, :]

    def rot(x):
        x1, x2 = x[..., :half], x[..., half:]
        return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                         dim=-1).to(x.dtype)

    return rot(q), rot(k)


def swiglu(x: torch.Tensor, w1: torch.Tensor, w3: torch.Tensor,
           w2: torch.Tensor) -> torch.Tensor:
    return (F.silu(x @ w1) * (x @ w3)) @ w2


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                          vocab: int) -> torch.Tensor:
    """Token-mean CE on (…, V_padded) logits, in f32; the padded vocab tail
    is masked and labels outside [0, vocab) count for nothing."""
    lf = logits.float()
    if lf.shape[-1] > vocab:
        mask = torch.arange(lf.shape[-1], device=lf.device) < vocab
        lf = torch.where(mask, lf, -1e30)
    lse = torch.logsumexp(lf, dim=-1)
    labels = labels.long()
    picked = torch.gather(lf, -1, labels.clamp(0, lf.shape[-1] - 1)[..., None])[..., 0]
    valid = (labels >= 0) & (labels < vocab)
    ce = torch.where(valid, lse - picked, 0.0)
    return torch.sum(ce) / torch.clamp(torch.sum(valid), min=1)
