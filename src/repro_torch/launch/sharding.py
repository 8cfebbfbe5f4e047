"""Sharding policy: logical axes → mesh axes, per architecture.  Port of
:mod:`repro.launch.sharding`.

The policy is one small table; the divisibility fallback lives in
:class:`repro_torch.models.layers.ShardingRules`, so one table serves all
ten architectures.

* DP   — batch over ``pod``×``data``
* TP   — heads / kv / ffn / experts / vocab / d_inner / lru over ``model``
* SP   — the residual stream's sequence over ``model`` between layers
         (opt-in)
* EP   — experts over ``model`` when the count divides (else TP-MoE)
* FSDP — the weights' ``embed`` dim also over the data axes (opt-in, on by
         default above 12 GB of bf16 weights); the optimizer state shards
         likewise (ZeRO-1, ``launch.specs.opt_rules``)

``mesh`` is a ``DeviceMesh`` or a description (``launch.mesh.MeshDesc``):
only its axis names and shape are read.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from ..models.config import ModelConfig
from ..models.layers import ShardingRules, mesh_axes


@dataclasses.dataclass(frozen=True)
class PolicyFlags:
    fsdp: bool = False             # shard weights' "embed" dim over data axes
    seq_parallel: bool = False     # shard residual seq over model axis
    zero1: bool = True             # optimizer state sharded like FSDP even
                                   # when the weights are not
    dp_over_model: bool = False    # small archs: replicate weights and use
                                   # the model axis as more DP (the batch over
                                   # every axis), where heads do not divide it


def default_flags(cfg: ModelConfig) -> PolicyFlags:
    """Megatron TP + DP, and FSDP and SP above 12 GB of bf16 weights;
    ``dp_over_model`` is the dry run's ``--opt`` flag, never a default."""
    big = cfg.param_count() * 2 > 12e9
    return PolicyFlags(fsdp=big, seq_parallel=big)


def build_rules(cfg: ModelConfig, mesh,
                flags: Optional[PolicyFlags] = None) -> ShardingRules:
    flags = flags or default_flags(cfg)
    names, shape = mesh_axes(mesh)
    dp: Tuple[str, ...] = tuple(a for a in names if a != "model")
    tp = ("model",) if "model" in names else ()
    if flags.dp_over_model:
        dp = names                    # the model axis becomes more DP
        tp = ()                       # weights fully replicated

    rules: Dict[str, Tuple[str, ...]] = {
        # ---- weights
        "vocab": tp,
        "heads": tp,
        "kv": tp,
        "ffn": tp,
        "experts": tp,     # EP when divisible; the fallback replicates → TP
        "inner": tp,       # mamba d_inner
        "inner2": tp,      # mamba in_proj's fused 2·d_inner
        "lru": tp,
        "lru_in": (),      # second dim of the square lru gate weights
        "embed": dp if flags.fsdp else (),
        "layers": (),
        # ---- activations
        "batch": dp,
        "heads_act": tp,
        "ffn_act": tp,
        "experts_act": tp,
        "seq_sp": tp if flags.seq_parallel else (),
        # decode KV caches are always sequence-sharded over the model axis
        # (flash-decoding: GQA kv-head counts rarely divide it)
        "seq_kv": tp,
    }
    return ShardingRules(rules=rules, mesh_shape=dict(zip(names, shape)))


def batch_specs(cfg: ModelConfig, mesh, kind: str):
    """Specs of the input batch's entries (see ``launch/specs.py``)."""
    dp = tuple(a for a in mesh_axes(mesh)[0] if a != "model")
    dps = dp if len(dp) > 1 else (dp[0] if dp else None)
    if kind == "decode":
        return {"tokens": (dps,), "pos": (dps,)}
    specs = {"tokens": (dps, None), "labels": (dps, None)}
    if cfg.family == "vlm":
        specs["patches"] = (dps, None, None)
    if cfg.family == "encdec":
        specs["frames"] = (dps, None, None)
    if kind == "prefill":
        specs.pop("labels")
    return specs
