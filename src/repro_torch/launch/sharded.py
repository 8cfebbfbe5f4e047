"""Sharded serving on a mesh of ranks: the model's parameters, the cache
and the batch as DTensors laid out by the sharding rules, and the serving
steps run on them.  The counterpart of the reference running the step that
its dry run lowers with ``in_shardings`` (``launch/dryrun.py``).

    mesh = device_mesh(make_mesh((2, 2), ("data", "model")))   # 4 ranks
    rules = build_rules(cfg, mesh)
    model = shard_model(Model(cfg, device="meta"), rules, mesh, seed=0)
    logits = sharded_step(model, "prefill")(place_batch(model, mesh, batch,
                                                        "prefill"))

- :func:`shard_model` places every parameter as a DTensor.  Each rank
  draws one whole leaf at a time from the seed (``Model.init``'s draws, in
  its order, on the rank's device) and keeps its shard, so no rank holds
  the whole model and the shards are ``Model.init``'s values bit for bit.
- The steps run with DTensor propagation: Megatron column-then-row
  products (an all-reduce after ``wo`` and after ``w2``), the
  vocab-sharded embedding gathered, the activations redistributed at the
  reference's constraint sites (``models.layers.constrain``).
  ``flash_attention`` runs on each rank's local heads through ``local_map``
  (``models.attention``), so the hand-written kernel sees plain local
  tensors.  A decode step writes the new slot into each rank's local shard
  of the cache, which is sharded over batch (data axes) and slots
  (``model``, flash-decoding); its attention over the slots reduces with
  all-reduces.
- Every family of the zoo: moe routes each rank's dispatch groups through
  ``local_map`` (a group that straddles the data ranks whole) and runs the
  expert products on each rank's shards, EP or TP-MoE as the rules lay
  out the experts (``models.moe``); the ssm and hybrid scans run on each
  rank's batch rows and channels (``models.ssm.linear_scan``); vlm's
  patches and encdec's frames are batch entries placed as
  ``launch.specs`` says, and the encoder's and the cross attention run on
  each rank's heads.

:func:`serve_rank` is one rank of a sharded serving run (spawned by
``launch.spawn.spawn_workers`` or a ``RankPool``): build, prefill, decode,
and report.
"""

from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..models import Model, resolve_config
from ..models.layers import ShardingRules, init_leaf, local_chunk, placements
from ..models.transformer import FAMILIES
from .specs import _cache_logical, batch_shardings, batch_struct

SHARDED_FAMILIES = FAMILIES


def distribute(full: torch.Tensor, mesh, pl: Sequence) -> torch.Tensor:
    """A DTensor of ``full`` (which every rank holds whole) laid out by
    ``pl``: each rank keeps a copy of its shard; no communication."""
    from torch.distributed.tensor import DTensor
    local = local_chunk(full, mesh, pl).clone()
    return DTensor.from_local(local, mesh, tuple(pl), run_check=False)


def _device(mesh) -> torch.device:
    return torch.device(mesh.device_type, torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)


def _hold(model: Model, name: str, value: torch.Tensor) -> None:
    mod_name, _, leaf = name.rpartition(".")
    mod = model.get_submodule(mod_name) if mod_name else model
    mod._parameters[leaf] = nn.Parameter(value, requires_grad=False)


@torch.no_grad()
def draw_params(model: Model, seed: int, device,
                place: Callable[[str, torch.Tensor], Optional[torch.Tensor]]
                ) -> Model:
    """``Model.init``'s values from a generator seeded with ``seed`` on
    ``device``, drawn one whole leaf at a time in ``Model.init``'s order
    (the model may live on ``meta``): ``place(name, full)`` gives what the
    parameter holds (a shard of ``full``, ``full`` itself), or None to
    leave it as it is."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    defs = model.param_defs()
    for name, p in list(model.named_parameters()):
        held = place(name, init_leaf(defs[name], gen).to(p.dtype))
        if held is not None:
            _hold(model, name, held)
    return model


@torch.no_grad()
def shard_model(model: Model, rules: ShardingRules, mesh,
                seed: Optional[int] = None) -> Model:
    """Place every parameter of ``model`` as a DTensor laid out by
    ``rules`` on ``mesh``; the model takes the rules.  With ``seed``, the
    values are ``Model.init``'s from it on the mesh's device: each rank
    draws every whole leaf (:func:`draw_params`) and keeps its shard.
    Without, each rank keeps its shard of the values the model holds (the
    same on every rank)."""
    defs = model.param_defs()

    def shard(name, full):
        return distribute(full, mesh, placements(rules.spec_for(defs[name]), mesh))

    if seed is not None:
        draw_params(model, seed, _device(mesh), shard)
    else:
        for name, p in list(model.named_parameters()):
            _hold(model, name, shard(name, p.detach().to(_device(mesh))))
    model.rules = rules
    return model


def place_batch(model: Model, mesh, batch: Dict[str, torch.Tensor],
                kind: str) -> Dict[str, torch.Tensor]:
    """A batch (every rank holding the whole of it) as DTensors, laid out
    as ``launch.specs`` lays out the step's batch."""
    from ..models.config import ShapeConfig
    B = batch["tokens"].shape[0]
    S = 1 if kind == "decode" else batch["tokens"].shape[-1] + (
        model.cfg.n_patches if model.cfg.family == "vlm" else 0)
    shape = ShapeConfig("run", S, B, kind)
    lay = batch_shardings(model.cfg, shape, mesh, model.rules,
                          batch_struct(model.cfg, shape))
    return {k: distribute(v, mesh, lay[k].placements) for k, v in batch.items()}


def make_cache(model: Model, mesh, batch_size: int, capacity: int) -> dict:
    """``model.init_cache``'s cache as DTensors laid out by the rules
    (``launch.specs``' cache layout): each rank allocates its shard
    alone."""
    from torch.distributed.tensor import DTensor
    shapes = Model(model.cfg, device="meta").init_cache(batch_size, capacity)
    dev = _device(mesh)
    out = {}
    for k, v in shapes.items():
        spec = model.rules.spec_for_shape(v.shape, _cache_logical(model.cfg, k))
        pl = placements(spec, mesh)
        full = torch.empty(v.shape, dtype=model.dtype if v.dtype == torch.bfloat16
                           else v.dtype, device="meta")
        local = torch.full(local_chunk(full, mesh, pl).shape,
                           -1 if k == "kpos" else 0, dtype=full.dtype,
                           device=dev)
        out[k] = DTensor.from_local(local, mesh, pl, run_check=False)
    return out


def on_mesh(fn: Callable) -> Callable:
    """``fn`` run on DTensors: no autograd, plain tensors made inside it
    (positions, masks) taken as replicated, and, for gloo ranks sharing a
    card, the collectives gloo refuses on CUDA tensors staged through the
    host (``core.distributed.staged_collectives``)."""
    import contextlib

    import torch.distributed as dist
    from torch.distributed.tensor.experimental import implicit_replication

    from ..core.distributed import staged_collectives

    def run(*args, **kwargs):
        staged = staged_collectives() if torch.cuda.is_available() and \
            dist.get_backend() == "gloo" else contextlib.nullcontext()
        with torch.no_grad(), implicit_replication(), staged:
            return fn(*args, **kwargs)
    return run


def sharded_step(model: Model, kind: str) -> Callable:
    """``launch.steps.step_for(model, kind)`` ("prefill" or "decode") on a
    model placed by :func:`shard_model`, for DTensor inputs placed by
    :func:`place_batch` and :func:`make_cache`."""
    from .steps import step_for
    if kind not in ("prefill", "decode"):
        raise ValueError(f"sharded_step serves 'prefill' or 'decode', not {kind!r}")
    return on_mesh(step_for(model, kind))


def _full(x) -> np.ndarray:
    """A DTensor gathered whole, in f32, on the host."""
    return on_mesh(lambda: x.float().full_tensor())().cpu().numpy()


def serve_rank(group, arch: str, mesh_shape, axes, flags=None, seed=0,
               tree=None, dtype=None, prompts=None, decode_tokens=None,
               capacity: int = 0, warm: bool = False, start: int = 0,
               overrides: Optional[dict] = None) -> dict:
    """One rank of a sharded serving run over the current process group:
    ``arch`` (a registered or ``-reduced`` config, with the fields of
    ``overrides`` replaced: a depth cut, a dispatch, an expert count) on
    the mesh ``mesh_shape``/``axes`` with the policy ``flags`` (default:
    the config's, so pass them where a cut would change
    ``default_flags``), weights from ``seed`` (or the reference tree
    ``tree`` of numpy arrays, every rank holding all of it), cast to
    ``dtype``; one prefill of ``prompts`` (tokens (B, S), or a
    ``data.family_batch`` dict of numpy arrays: tokens with vlm's patches or
    encdec's frames) and one decode step per column of ``decode_tokens``
    (B, T) at positions ``start`` … ``start`` + T − 1 on an empty cache of
    ``capacity`` slots.  With ``warm``, the prefill runs once untimed
    first.  → rank 0: the last logits of the prefill and every decode
    step's logits (numpy, f32); every rank: its wall per step, weight
    bytes, peak memory (on the card), collectives by kind a step, and the
    messages it staged through the host."""
    from ..analysis.comms import collective_bytes
    from ..convert import model_params_from_numpy
    from ..core import distributed
    from .mesh import device_mesh, make_mesh
    from .sharding import PolicyFlags, build_rules

    cfg = resolve_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    # DTensor logs a warning at every redistribution of a value partial over
    # both mesh dims (FSDP's contractions), one line a call on every rank
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    dev = group.device
    mesh = device_mesh(make_mesh(mesh_shape, axes), device=dev)
    rules = build_rules(cfg, mesh, PolicyFlags(**flags) if flags else None)
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    model = Model(cfg, device="meta")
    if tree is not None:
        model.load_state_dict(model_params_from_numpy(cfg, tree, "cpu"),
                              assign=True)
    if dtype is not None:
        model = model.to(getattr(torch, dtype))
    shard_model(model, rules, mesh, seed=None if tree is not None else seed)
    weight_bytes = sum(p.to_local().numel() * p.element_size()
                       for p in model.parameters())
    out = {"rank": group.rank, "weight_bytes": weight_bytes,
           "mesh": list(mesh_shape), "flags": flags or "default"}
    staged = distributed.host_staged

    def timed(fn):
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        res, coll = collective_bytes(fn)
        if cuda:
            torch.cuda.synchronize()
        return res, coll, time.perf_counter() - t0

    if prompts is not None:
        if not isinstance(prompts, dict):
            prompts = {"tokens": prompts}
        batch = place_batch(model, mesh, {
            k: torch.as_tensor(v).to(dev) for k, v in prompts.items()}, "prefill")
        prefill = sharded_step(model, "prefill")
        if warm:
            prefill(batch)
        logits, coll, wall = timed(lambda: prefill(batch))
        out["prefill"] = {"wall_s": wall, "collectives": coll,
                          "local_logits": list(logits.to_local().shape)}
        full = _full(logits)
        if group.rank == 0:
            out["prefill_logits"] = full
    if decode_tokens is not None:
        decode_tokens = torch.as_tensor(decode_tokens).to(dev)
        B, T = decode_tokens.shape
        cache = make_cache(model, mesh, B, capacity or start + T)
        step = on_mesh(model.decode_step)
        serve = sharded_step(model, "decode")
        logits_t, walls, colls = [], [], []
        for t in range(T):
            pos = torch.full((B,), start + t, dtype=torch.int32, device=dev)
            b = place_batch(model, mesh, {"tokens": decode_tokens[:, t],
                                          "pos": pos}, "decode")
            (cache, lg), coll, wall = timed(lambda: step(cache, b))
            walls.append(wall)
            colls.append(coll)
            full = _full(lg)
            if group.rank == 0:
                logits_t.append(full)
        # the serving step itself (greedy next tokens) at the next position
        pos = torch.full((B,), start + T, dtype=torch.int32, device=dev)
        b = place_batch(model, mesh, {"tokens": decode_tokens[:, -1],
                                      "pos": pos}, "decode")
        _, nxt = serve(cache, b)
        out["decode"] = {"wall_s": walls, "collectives": colls,
                         "next_tokens": on_mesh(nxt.full_tensor)().cpu().numpy()}
        if group.rank == 0:
            out["decode_logits"] = np.stack(logits_t)
    out["host_staged_messages"] = distributed.host_staged - staged
    if cuda:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


def gathered_params_rank(group, arch: str, mesh_shape, axes, seed: int) -> dict:
    """A rank entry: ``arch``'s model placed by :func:`shard_model` from
    ``seed`` on the mesh, every parameter gathered back whole → rank 0:
    {name: numpy}, the other ranks {}."""
    from .mesh import device_mesh, make_mesh
    from .sharding import build_rules
    cfg = resolve_config(arch)
    mesh = device_mesh(make_mesh(mesh_shape, axes), device=group.device)
    model = shard_model(Model(cfg, device="meta"), build_rules(cfg, mesh),
                        mesh, seed=seed)
    full = {k: _full(p) for k, p in model.named_parameters()}
    return full if group.rank == 0 else {}


def routing_rank(group, logits, k: int, capacity: int, mesh_shape, axes,
                 dim: int) -> dict:
    """A rank entry: f32 router logits (G, g, E), every rank holding them
    whole, split over the mesh's data axes along ``dim`` (0: each rank its
    groups; 1: each group over its tokens, as a decode step's), routed on
    the mesh by ``models.moe.route_topk`` and ``route_sorted`` → rank 0:
    the dispatch, combine and sorted slots gathered whole (numpy) and both
    aux losses; the other ranks {}."""
    from torch.distributed.tensor import Replicate, Shard

    from ..models import moe
    from .mesh import device_mesh, make_mesh
    mesh = device_mesh(make_mesh(mesh_shape, axes), device=group.device)
    pl = tuple(Replicate() if a == "model" else Shard(dim) for a in axes)
    lg = distribute(torch.as_tensor(logits).to(group.device), mesh, pl)

    def route():
        dispatch, combine, aux = moe.route_topk(lg, k, capacity)
        slots, aux_sorted = moe.route_sorted(lg, k, capacity)
        return ({"dispatch": dispatch, "combine": combine,
                 **slots._asdict()}, {"aux": aux, "aux_sorted": aux_sorted})

    tensors, auxes = on_mesh(route)()
    out = {name: on_mesh(t.full_tensor)().cpu().numpy()
           for name, t in tensors.items()}
    out.update({name: float(a) for name, a in auxes.items()})
    return out if group.rank == 0 else {}
