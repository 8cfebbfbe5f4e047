"""Sharded serving and training on a mesh of ranks: the model's
parameters, the cache, the AdamW moments and the batch as DTensors laid
out by the sharding rules, and the steps run on them.  The counterpart of
the reference running the step that its dry run lowers with
``in_shardings`` (``launch/dryrun.py``).

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

- Training, every family: the model opts into gradients
  (``model.requires_grad_(True)``), :func:`shard_opt_state` lays the f32
  moments out by ``launch.specs.opt_rules`` (ZeRO-1: ``embed`` over the
  data axes), :func:`place_batch` splits each micro-batch over the data
  axes, and ``sharded_step(model, "train")`` runs ``make_train_step``
  with autograd on (:func:`on_mesh` with ``grad``): the backward's
  collectives are DTensor's, the gradients stay in the layout the
  backward gives them (partial sums over the data axes) until
  ``optim.adamw`` moves each to its moment's layout.  Where a
  ``local_map`` reads an input whole beside rank-local rows, groups or
  channels (moe's router, expert weights and combine weights, the
  causal convolution's weights, the ssm readout's C, narrowed k/v), it
  declares that input's gradient a partial sum
  (``in_grad_placements``), so that the backward reduces it.

:func:`serve_rank` is one rank of a sharded serving run and
:func:`train_rank` one of a sharded training run (spawned by
``launch.spawn.spawn_workers`` or a ``RankPool``): build, run the steps,
report; :func:`train_rank` also checkpoints the sharded train state and
restores it onto its mesh's layouts.
"""

from __future__ import annotations

import dataclasses
import functools
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
    as ``launch.specs`` lays out the step's batch; a train batch of
    (n_micro, mb, …) leaves keeps n_micro replicated and splits mb."""
    from ..models.config import ShapeConfig
    tokens = batch["tokens"]
    micro = kind == "train" and tokens.dim() == 3
    S = 1 if kind == "decode" else tokens.shape[-1] + (
        model.cfg.n_patches if model.cfg.family == "vlm" else 0)
    # one micro-batch's (mb, …) structs, each led by n_micro (1 too)
    shape = ShapeConfig("run", S, tokens.shape[1 if micro else 0], kind)
    structs = batch_struct(model.cfg, shape, 1)
    if micro:
        structs = {k: v.expand((tokens.shape[0],) + tuple(v.shape))
                   for k, v in structs.items()}
    lay = batch_shardings(model.cfg, shape, mesh, model.rules, structs)
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


def on_mesh(fn: Callable, grad: bool = False) -> Callable:
    """``fn`` run on DTensors: no autograd (with ``grad``, autograd on: a
    train step), plain tensors made inside it (positions, masks) taken as
    replicated, and, for gloo ranks sharing a card, the collectives gloo
    refuses on CUDA tensors staged through the host
    (``core.distributed.staged_collectives``).  The staging is a dispatch
    mode, which the autograd engine carries into the backward it runs on
    the card's own thread, so the backward's collectives are staged too."""
    from torch.distributed.tensor.experimental import implicit_replication

    from ..core.distributed import staged_if_shared

    @functools.wraps(fn)
    def run(*args, **kwargs):
        with torch.set_grad_enabled(grad), implicit_replication(), \
                staged_if_shared():
            return fn(*args, **kwargs)
    return run


def shard_opt_state(model: Model, rules: ShardingRules, mesh, flags=None):
    """Zero AdamW moments (f32) for the parameters of a model placed by
    :func:`shard_model`, as DTensors in ``launch.specs.opt_rules``'
    layout (ZeRO-1 with ``flags.zero1``: the ``embed`` dim over the data
    axes even where the weights do not split it); each rank allocates its
    shard alone.  The step is a plain int32 0 on every rank."""
    from torch.distributed.tensor import DTensor

    from ..optim.adamw import AdamWState
    from .sharding import default_flags
    from .specs import opt_rules
    orules = opt_rules(rules, mesh, flags or default_flags(model.cfg))
    defs = model.param_defs()
    dev = _device(mesh)

    def zeros():
        out = {}
        for name, p in model.named_parameters():
            pl = placements(orules.spec_for(defs[name]), mesh)
            full = torch.empty(p.shape, dtype=torch.float32, device="meta")
            local = torch.zeros(local_chunk(full, mesh, pl).shape,
                                dtype=torch.float32, device=dev)
            out[name] = DTensor.from_local(local, mesh, pl, run_check=False)
        return out

    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=dev),
                      mu=zeros(), nu=zeros())


def sharded_step(model: Model, kind: str,
                 phase: Optional[Callable] = None) -> Callable:
    """``launch.steps.step_for(model, kind)`` on a model placed by
    :func:`shard_model`: "prefill" or "decode" for DTensor inputs placed
    by :func:`place_batch` and :func:`make_cache`, or "train"
    (``make_train_step(model, phase=phase)``, the model opted into
    gradients) for a train batch placed by :func:`place_batch` and the
    moments of :func:`shard_opt_state`."""
    from .steps import make_train_step, step_for
    if kind == "train":
        return on_mesh(make_train_step(model, phase=phase), grad=True)
    if kind not in ("prefill", "decode"):
        raise ValueError(f"sharded_step runs 'train', 'prefill' or 'decode', "
                         f"not {kind!r}")
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
    from ..core import distributed

    dev = group.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    cfg, mesh, _, _, model = _build(group, arch, mesh_shape, axes, flags,
                                    seed, tree, dtype, overrides)
    out = {"rank": group.rank, "weight_bytes": _local_bytes(model.parameters()),
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


def _build(group, arch, mesh_shape, axes, flags, seed, tree, dtype,
           overrides):
    """(cfg, mesh, rules, policy flags, model placed by :func:`shard_model`)
    for a rank entry: ``arch`` with ``overrides``, weights from ``seed``
    or the reference tree ``tree``, cast to ``dtype``."""
    from ..convert import model_params_from_numpy
    from .mesh import device_mesh, make_mesh
    from .sharding import PolicyFlags, build_rules, default_flags

    cfg = resolve_config(arch)
    if overrides:
        cfg = dataclasses.replace(cfg, **overrides)
    # DTensor logs a warning at every redistribution of a value partial over
    # both mesh dims (FSDP's contractions), one line a call on every rank
    logging.getLogger("torch.distributed.tensor._redistribute").setLevel(
        logging.ERROR)
    mesh = device_mesh(make_mesh(mesh_shape, axes), device=group.device)
    policy = PolicyFlags(**flags) if flags else default_flags(cfg)
    rules = build_rules(cfg, mesh, policy)
    model = Model(cfg, device="meta")
    if tree is not None:
        model.load_state_dict(model_params_from_numpy(cfg, tree, "cpu"),
                              assign=True)
    if dtype is not None:
        model = model.to(getattr(torch, dtype))
    shard_model(model, rules, mesh, seed=None if tree is not None else seed)
    return cfg, mesh, rules, policy, model


def _local_bytes(tensors) -> int:
    from torch.distributed.tensor import DTensor
    return sum((t.to_local() if isinstance(t, DTensor) else t).numel()
               * t.element_size() for t in tensors)


def _train_layouts(model: Model, opt_state) -> dict:
    """The placements of a sharded train state ``{"params", "opt"}`` (the
    tree :func:`train_rank` checkpoints), for ``checkpoint.load_checkpoint``
    and ``serve.elastic.elastic_restore`` onto the state's mesh."""
    from ..optim.adamw import AdamWState
    return {"params": {k: tuple(p.placements)
                       for k, p in model.named_parameters()},
            "opt": AdamWState(step=None,
                              mu={k: tuple(m.placements)
                                  for k, m in opt_state.mu.items()},
                              nu={k: tuple(v.placements)
                                  for k, v in opt_state.nu.items()})}


def train_rank(group, arch: str, mesh_shape, axes, batches, flags=None,
               seed: int = 0, tree=None, dtype=None,
               overrides: Optional[dict] = None, gather: Sequence[str] = (),
               save_dir=None, restore_dir=None,
               check_restore: bool = False,
               inspect: Optional[Callable] = None) -> dict:
    """One rank of a sharded training run over the current process group:
    ``arch`` (with ``overrides``) on the mesh ``mesh_shape``/``axes`` under
    the policy ``flags`` (default: the config's), weights from ``seed`` (or
    the reference tree ``tree``, every rank holding all of it) cast to
    ``dtype``, opted into gradients; AdamW moments by
    :func:`shard_opt_state` (ZeRO-1 with ``flags``' ``zero1``); one train
    step (``sharded_step(model, "train")``, AdamW's defaults) per entry of
    ``batches`` (dicts of numpy arrays with labels, (n_micro, mb, …) or
    (B, …), every rank holding all of it), placed by :func:`place_batch`.

    With ``restore_dir`` the train state is first restored from its
    latest checkpoint onto this mesh's layouts (``elastic_restore``); with
    ``save_dir`` it is saved there after the first step (a checkpoint of
    ``{"params": {name: …}, "opt": AdamWState}``, meta ``{"step"}``);
    with ``check_restore`` every rank then restores that checkpoint onto
    one process (its host memory, no mesh) and holds its block of every
    leaf ``torch.equal`` to the restored one (:func:`_check_restore`).  ``inspect(params,
    opt_state)``, when given, runs on every rank after the last step, on
    its DTensors; its result is the rank's ``inspected``.

    → rank 0: each step's loss, grad norm and step count, the parameters
    and moments of ``gather`` ("params", "mu", "nu") gathered whole (numpy,
    f32) after the last step, the restore check's result; every rank: its
    build, save and restore-check seconds, its wall per step, its bytes of
    weights, f32 gradient accumulators and optimizer state (mu, nu and the
    step, as ``launch.specs.argument_bytes`` counts ``opt_state``), its
    peak memory (on the card),
    its collectives by kind a step, split into forward, backward and
    optimizer, and the messages it staged through the host."""
    from ..analysis.comms import Phases, collective_bytes
    from ..checkpoint import CheckpointManager
    from ..core import distributed
    from ..serve.elastic import elastic_restore

    dev = group.device
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    cfg, mesh, rules, policy, model = _build(group, arch, mesh_shape, axes,
                                             flags, seed, tree, dtype,
                                             overrides)
    model.requires_grad_(True)
    state = shard_opt_state(model, rules, mesh, policy)
    params = dict(model.named_parameters())
    if restore_dir is not None:
        got = elastic_restore(CheckpointManager(restore_dir),
                              {"params": params, "opt": state},
                              mesh=mesh, placements=_train_layouts(
                                  model, state))
        if got is None:
            raise FileNotFoundError(f"no checkpoint in {restore_dir}")
        _, restored, _ = got
        with torch.no_grad():
            for k, p in params.items():
                p.to_local().copy_(restored["params"][k].to_local())
        state = restored["opt"]
    phases = Phases()
    step = sharded_step(model, "train", phases)
    out = {"rank": group.rank, "mesh": list(mesh_shape),
           "flags": dataclasses.asdict(policy),
           "build_s": time.perf_counter() - t0,
           "weight_bytes": _local_bytes(params.values()),
           "opt_state_bytes": _local_bytes([state.step, *state.mu.values(),
                                            *state.nu.values()]),
           "steps": []}
    staged = distributed.host_staged
    for i, b in enumerate(batches):
        batch = place_batch(model, mesh, {
            k: torch.as_tensor(v).to(dev) for k, v in b.items()}, "train")
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        (state, m), coll = collective_bytes(lambda: step(state, batch), phases)
        if cuda:
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        out["steps"].append({"wall_s": wall, "loss": float(m["loss"]),
                             "grad_norm": float(m["grad_norm"]),
                             "step": int(m["step"]), "collectives": coll})
        out["grad_bytes"] = step.stats["grad_bytes"]
        if save_dir is not None and i == 0:
            train = {"params": params, "opt": state}
            t0 = time.perf_counter()
            CheckpointManager(save_dir, async_write=False).save(
                train, int(m["step"]), meta={"step": int(m["step"])})
            out["save_s"] = time.perf_counter() - t0
            if check_restore:
                t0 = time.perf_counter()
                out["restore_equal"] = _check_restore(group, save_dir, train)
                out["restore_check_s"] = time.perf_counter() - t0
    if inspect is not None:
        out["inspected"] = inspect(params, state)
    for name in gather:
        leaves = params if name == "params" else getattr(state, name)
        full = {k: _full(x) for k, x in leaves.items()}
        if group.rank == 0:
            out[name] = full
    out["host_staged_messages"] = distributed.host_staged - staged
    if cuda:
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated()
    return out


def _check_restore(group, directory, train) -> Optional[dict]:
    """The latest checkpoint in ``directory`` restored onto one process on
    every rank (its host memory, no mesh; the chunks' CRCs checked on the
    first rank), each rank's block of every ``train`` leaf (its shard of
    a DTensor, a plain leaf whole) held ``torch.equal`` to the same block
    of the restored leaf: the ranks' blocks cover every element, and no
    leaf is gathered.  Each rank holds the whole restored state in its
    host memory at once: the world times the checkpoint's size on the
    host.  → on the first rank, {"equal": all leaves ``torch.equal``,
    "leaves": n, "differ": names}; None on the others."""
    import torch.distributed as dist
    from torch.distributed.tensor import DTensor

    from ..checkpoint.manager import (_flatten_with_paths, latest_step,
                                      load_checkpoint)
    first = group.rank == 0
    restored, _ = load_checkpoint(train, directory, latest_step(directory),
                                  device="cpu", verify_crc=first)
    restored = dict(_flatten_with_paths(restored))
    differ, n = [], 0
    for name, leaf in _flatten_with_paths(train):
        n += 1
        full = restored.pop(name)
        if isinstance(leaf, DTensor):
            full = local_chunk(full, leaf.device_mesh, leaf.placements)
            leaf = leaf.to_local()
        if not torch.equal(full, leaf.detach().cpu()):
            differ.append(name)
        del full
    every = [None] * group.world if first else None
    dist.gather_object(differ, every, dst=0)
    if not first:
        return None
    differ = sorted({name for d in every for name in d})
    return {"equal": not differ, "leaves": n, "differ": differ}


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
