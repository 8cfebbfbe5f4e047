"""AdamW.  Port of :mod:`repro.optim.adamw`, term for term: the clip scale
from the pre-clip global norm, bias corrections from the new step, weight
decay decoupled and applied to the f32 parameter, the result cast back to
the parameter's dtype.

The parameters and the state are mappings from the model's parameter
names (``dict(model.named_parameters())``) to tensors; the moments are f32
and mirror the parameters.  Where the reference returns new arrays, the
port updates the parameters and the moments in place, under
``torch.no_grad()``, one leaf at a time: at h2o-danube-3-4b's size the f32
moments alone are 31.7 GB, and a second copy would not fit beside them.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, NamedTuple, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    """A named tuple, so that ``checkpoint/manager.py`` stores it by field."""
    step: torch.Tensor            # () int32
    mu: Dict[str, torch.Tensor]   # f32, by parameter name
    nu: Dict[str, torch.Tensor]


def adamw_init(params: Mapping[str, torch.Tensor]) -> AdamWState:
    """Zero moments in f32 beside each parameter, step 0."""
    dev = next(iter(params.values())).device
    return AdamWState(
        step=torch.zeros((), dtype=torch.int32, device=dev),
        mu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()},
        nu={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
            for k, p in params.items()})


def global_norm(tree: Mapping[str, torch.Tensor]) -> torch.Tensor:
    """√(Σ x²) over every leaf, in f32, as a 0-d tensor (no host sync)."""
    total = None
    for x in tree.values():
        sq = torch.sum(torch.square(x.float()))
        total = sq if total is None else total + sq
    return torch.sqrt(total)


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                 lr=None) -> Tuple[Mapping[str, torch.Tensor], AdamWState,
                                   torch.Tensor]:
    """One AdamW step → (params, new state, pre-clip grad norm); the
    parameters and moments are updated in place and returned."""
    lr = cfg.lr if lr is None else lr
    gnorm = global_norm(grads)
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for name, p in params.items():
        g = grads[name].float() * scale
        m, v = state.mu[name], state.nu[name]
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
        del g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        pf = p.float()
        delta.add_(cfg.weight_decay * pf)
        p.copy_(pf.sub_(lr * delta))
        del delta, pf
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
