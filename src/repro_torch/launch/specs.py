"""Shapes, dtypes and layouts of every step input.  Port of
:mod:`repro.launch.specs`.

``input_specs(arch, shape, mesh)`` returns the inputs of the step that
``shape.kind`` runs, as ``meta`` tensors (nothing is allocated), each
beside its :class:`Layout` (spec and DTensor placements), in the
reference's pytree keys and order: ``params``, ``opt_state``, ``batch``
(train), ``params``, ``batch`` (prefill) or ``params``, ``cache``,
``batch`` (decode).  The port's steps take the model's parameters from the
model and the rest in that order (``launch/steps.py``).  ``params`` is the
reference's tree of stacked layers (``layers.attn.wq`` of (L, d, H, hd),
``Model.stacked_param_defs``); the model holds one tensor per layer, laid
out by the same spec without the leading ``layers`` dim, which no rule
shards.
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from ..models import Model, ModelConfig, ShapeConfig
from ..models.layers import ShardingRules, local_shape, mesh_axes, placements
from .sharding import PolicyFlags, build_rules, default_flags

META = torch.device("meta")

# logical axes of each batch entry
_BATCH_LOGICAL = {
    "tokens": ("batch", None),
    "labels": ("batch", None),
    "patches": ("batch", None, None),
    "frames": ("batch", None, None),
}
_DECODE_LOGICAL = {"tokens": ("batch",), "pos": ("batch",)}

# logical axes of the cache entries
_CACHE_LOGICAL = {
    "k": (None, "batch", "seq_kv", None, None),
    "v": (None, "batch", "seq_kv", None, None),
    "cross_k": (None, "batch", "seq_kv", None, None),
    "cross_v": (None, "batch", "seq_kv", None, None),
    "kpos": ("batch", "seq_kv"),
    "h_ssm": (None, "batch", "inner", None),
    "conv_ssm": (None, "batch", None, "inner"),
    "h_hyb": (None, None, "batch", "lru"),
    "conv_hyb": (None, None, "batch", None, "lru"),
    "tail_h": (None, "batch", "lru"),
    "tail_conv": (None, "batch", None, "lru"),
}


class Layout(NamedTuple):
    """One input's spec (per dim: None, an axis name or a tuple of them)
    and its DTensor placements over the mesh."""
    spec: Tuple
    placements: Tuple


def _cache_logical(cfg: ModelConfig, key: str) -> Tuple:
    if key in ("h", "conv"):
        suffix = "_ssm" if cfg.family == "ssm" else "_hyb"
        return _CACHE_LOGICAL[key + suffix]
    return _CACHE_LOGICAL[key]


def microbatched(shape: ShapeConfig, accum: int) -> Tuple[int, int]:
    """(n_micro, per-micro batch) for train shapes."""
    a = max(1, accum)
    while shape.global_batch % a != 0:
        a -= 1
    return a, shape.global_batch // a


def batch_struct(cfg: ModelConfig, shape: ShapeConfig,
                 micro: Optional[int] = None) -> Dict[str, torch.Tensor]:
    """One batch of ``shape`` as meta tensors.  Train shapes with
    grad_accum > 1 lead with (n_micro, micro_batch, …): the step runs the
    micro-batches in turn."""
    B, S = shape.global_batch, shape.seq_len

    def t(shape_, dtype):
        return torch.empty(shape_, dtype=dtype, device=META)

    if shape.kind == "decode":
        return {"tokens": t((B,), torch.int32), "pos": t((B,), torch.int32)}
    if shape.kind == "train" and (micro or cfg.grad_accum) > 1:
        lead = microbatched(shape, micro or cfg.grad_accum)
    else:
        lead = (B,)
    out: Dict[str, torch.Tensor] = {}
    text_len = S
    if cfg.family == "vlm":
        text_len = S - cfg.n_patches
        out["patches"] = t(lead + (cfg.n_patches, cfg.d_model), torch.bfloat16)
    if cfg.family == "encdec":
        out["frames"] = t(lead + (S // cfg.frame_ratio, cfg.d_model),
                          torch.bfloat16)
    out["tokens"] = t(lead + (text_len,), torch.int32)
    if shape.kind == "train":
        out["labels"] = t(lead + (text_len,), torch.int32)
    return out


def _layout(rules: ShardingRules, mesh, shape_t, logical) -> Layout:
    spec = rules.spec_for_shape(shape_t, logical)
    return Layout(spec, placements(spec, mesh))


def batch_shardings(cfg: ModelConfig, shape: ShapeConfig, mesh,
                    rules: ShardingRules,
                    structs: Dict[str, torch.Tensor]) -> Dict[str, Layout]:
    """Each batch entry's layout: the batch dim over the data axes.  A
    micro-batched train batch, (n_micro, mb, …) as ``batch_struct`` makes
    it, keeps n_micro replicated and splits mb; the train step runs on
    these layouts (``launch.sharded.place_batch``)."""
    logical_map = _DECODE_LOGICAL if shape.kind == "decode" else _BATCH_LOGICAL
    micro = shape.kind == "train" and structs["tokens"].dim() == 3
    return {k: _layout(rules, mesh, v.shape,
                       ((None,) if micro else ()) + logical_map[k])
            for k, v in structs.items()}


def opt_rules(rules: ShardingRules, mesh, flags: PolicyFlags) -> ShardingRules:
    """ZeRO-1: the optimizer state shards its 'embed' dim over the data
    axes even when the weights do not (``flags.zero1``)."""
    if not flags.zero1:
        return rules
    dp = tuple(a for a in mesh_axes(mesh)[0] if a != "model")
    r = dict(rules.rules)
    if not r.get("embed"):
        r["embed"] = dp
    return ShardingRules(rules=r, mesh_shape=rules.mesh_shape)


def input_specs(arch, shape: ShapeConfig, mesh,
                flags: Optional[PolicyFlags] = None):
    """→ (kwargs: the step's inputs as meta tensors, shardings: their
    layouts in the same keys, rules, model (on meta, with the rules))."""
    from ..models import get_config
    from ..optim.adamw import AdamWState
    cfg = arch if isinstance(arch, ModelConfig) else get_config(arch)
    flags = flags or default_flags(cfg)
    rules = build_rules(cfg, mesh, flags)
    model = Model(cfg, device=META, rules=rules)
    defs = model.stacked_param_defs()
    params = {k: torch.empty(d.shape, dtype=d.dtype, device=META)
              for k, d in defs.items()}
    pspecs = {k: _layout(rules, mesh, d.shape, d.logical)
              for k, d in defs.items()}

    bstruct = batch_struct(cfg, shape)
    bshard = batch_shardings(cfg, shape, mesh, rules, bstruct)

    if shape.kind == "train":
        orules = opt_rules(rules, mesh, flags)
        ospecs = {k: _layout(orules, mesh, d.shape, d.logical)
                  for k, d in defs.items()}

        def f32():
            return {k: torch.empty(p.shape, dtype=torch.float32, device=META)
                    for k, p in params.items()}
        opt_state = AdamWState(step=torch.empty((), dtype=torch.int32,
                                                device=META),
                               mu=f32(), nu=f32())
        opt_shard = AdamWState(step=Layout((), placements((), mesh)),
                               mu=ospecs, nu=dict(ospecs))
        kwargs = {"params": params, "opt_state": opt_state, "batch": bstruct}
        shardings = {"params": pspecs, "opt_state": opt_shard,
                     "batch": bshard}
    elif shape.kind == "prefill":
        kwargs = {"params": params, "batch": bstruct}
        shardings = {"params": pspecs, "batch": bshard}
    else:  # decode
        cache = Model(cfg, device=META).init_cache(shape.global_batch,
                                                   shape.seq_len)
        cshard = {k: _layout(rules, mesh, v.shape, _cache_logical(cfg, k))
                  for k, v in cache.items()}
        kwargs = {"params": params, "cache": cache, "batch": bstruct}
        shardings = {"params": pspecs, "cache": cshard, "batch": bshard}
    return kwargs, shardings, rules, model


def _leaves(tree, prefix=""):
    """(dotted key, leaf) of a tree of dicts and named tuples."""
    if isinstance(tree, Layout) or isinstance(tree, torch.Tensor):
        yield prefix, tree
        return
    items = tree._asdict().items() if hasattr(tree, "_asdict") else tree.items()
    for k, v in items:
        yield from _leaves(v, f"{prefix}.{k}" if prefix else k)


def flat_specs(kwargs, shardings) -> Dict[str, Tuple[torch.Tensor, Layout]]:
    """Every input leaf by dotted key (``params.layers.attn.wq``,
    ``opt_state.mu.embed``, ``cache.k``, ``batch.tokens``) with its
    layout."""
    lay = dict(_leaves(shardings))
    return {k: (t, lay[k]) for k, t in _leaves(kwargs)}


def argument_bytes(kwargs, shardings, mesh) -> Dict[str, int]:
    """Bytes one device holds of each top-level input (params, opt_state,
    cache, batch), every leaf at its local shape."""
    out: Dict[str, int] = {}
    for key, (t, lay) in flat_specs(kwargs, shardings).items():
        n = math.prod(local_shape(t.shape, lay.spec, mesh)) * t.element_size()
        top = key.split(".")[0]
        out[top] = out.get(top, 0) + n
    return out
