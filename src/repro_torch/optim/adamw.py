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

On a mesh the parameters, gradients and moments are DTensors (the
moments in ``launch.specs.opt_rules``' layout, ``launch.sharded.
shard_opt_state``): the counterpart of what GSPMD derives from the
reference's ``opt_state`` shardings.  Each gradient moves to its
moment's layout (from partial sums over the data axes: a reduce-scatter
under ZeRO-1, an all-reduce where the moment is not split), the global
norm is one all-reduce of each rank's sum of squares (each replicated
shard counted once), each moment's shard is updated in place, and the
new parameter is computed on the moment's shard and moved to the
weight's layout (an all-gather under ZeRO-1 without FSDP).  The
arithmetic of each element is the plain path's.
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


def _is_sharded(state: AdamWState) -> bool:
    from torch.distributed.tensor import DTensor
    return any(isinstance(m, DTensor) for m in state.mu.values())


@torch.no_grad()
def adamw_update(grads: Mapping[str, torch.Tensor], state: AdamWState,
                 params: Mapping[str, torch.Tensor], cfg: AdamWConfig,
                 lr=None) -> Tuple[Mapping[str, torch.Tensor], AdamWState,
                                   torch.Tensor]:
    """One AdamW step → (params, new state, pre-clip grad norm); the
    parameters and moments are updated in place and returned."""
    lr = cfg.lr if lr is None else lr
    if _is_sharded(state):
        return _sharded_update(grads, state, params, cfg, lr)
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


def _owns(x, mesh) -> bool:
    """Whether this rank counts the DTensor ``x``'s local shard in a sum
    over the mesh: the first rank of each mesh dim that replicates it."""
    coord = mesh.get_coordinate()
    return all(c == 0 for c, p in zip(coord, x.placements) if p.is_replicate())


def _mesh_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of the plain tensor ``x`` over every rank of ``mesh`` (one
    all-reduce over the mesh's ranks, which are the world's)."""
    import torch.distributed as dist
    import torch.distributed._functional_collectives as funcol
    if mesh.size() != dist.get_world_size():
        raise ValueError(f"adamw_update: a mesh of {mesh.size()} ranks in a "
                         f"world of {dist.get_world_size()}")
    return funcol.all_reduce(x, "sum", dist.group.WORLD)


def _sharded_update(grads, state: AdamWState, params, cfg: AdamWConfig, lr):
    """:func:`adamw_update` on DTensors (see the module docstring)."""
    from torch.distributed.tensor import DTensor
    mesh = next(iter(state.mu.values())).device_mesh
    # each gradient in its moment's layout: the partial sums reduced
    gm = {name: grads[name].redistribute(mesh, m.placements)
          for name, m in state.mu.items()}
    total = torch.zeros((), dtype=torch.float32, device=state.step.device)
    for g in gm.values():
        if _owns(g, mesh):
            total = total + torch.sum(torch.square(g.to_local().float()))
    gnorm = torch.sqrt(_mesh_sum(total, mesh))
    scale = torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12), max=1.0) \
        if cfg.grad_clip > 0 else 1.0
    step = state.step + 1
    b1c = 1.0 - cfg.b1 ** step.float()
    b2c = 1.0 - cfg.b2 ** step.float()
    for name, p in params.items():
        pl = state.mu[name].placements
        g = gm.pop(name).to_local().float() * scale
        m, v = state.mu[name].to_local(), state.nu[name].to_local()
        m.mul_(cfg.b1).add_((1.0 - cfg.b1) * g)
        v.mul_(cfg.b2).add_((1.0 - cfg.b2) * torch.square(g))
        del g
        delta = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
        # the parameter's shard in the moment's layout: a slice of its own
        pf = p.redistribute(mesh, pl).to_local().float()
        delta.add_(cfg.weight_decay * pf)
        new = DTensor.from_local(pf.sub_(lr * delta).to(p.dtype), mesh, pl,
                                 run_check=False)
        p.to_local().copy_(new.redistribute(mesh, p.placements).to_local())
        del delta, pf, new
    return params, AdamWState(step=step, mu=state.mu, nu=state.nu), gnorm
