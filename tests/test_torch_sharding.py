"""The port's sharding rules, step-input specs and cost models against the
reference's, with no ranks.

- Every param, optimizer-state, batch and cache leaf's spec, and the bytes
  one device holds of each input, for all ten configs × their applicable
  ``SHAPES`` × the meshes (16, 16) ("data", "model"), (2, 16, 16)
  ("pod", "data", "model") and (2, 2) ("data", "model"), under the default
  flags, fsdp + seq_parallel, and dp_over_model.  The reference side uses
  ``build_rules``, ``Model(cfg, rules).param_defs()``,
  ``ShardingRules.spec_for``, ``batch_struct``, ``_cache_logical`` and
  ``jax.eval_shape`` of ``init_cache`` with a mesh stand-in (axis names and
  ``devices.shape``), so no fake devices are needed; a reference spec is a
  ``PartitionSpec``, the port's a tuple, and they must be equal.
- ``model_flops``, ``analytic_bytes`` (at an explicit bandwidth) and
  ``combine_layer_diff``: equal as floats.
- The reference's own cases of the divisibility fallback and of the
  axis-used-once rule (``tests/test_sharding_analysis.py``).
"""

import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax
import numpy as np

from repro.analysis import analytic as jax_analytic
from repro.analysis import roofline as jax_roofline
from repro.launch import sharding as jax_sharding
from repro.launch import specs as jax_specs
from repro.models import Model as JaxModel
from repro.models import SHAPES as JAX_SHAPES
from repro.models import get_config as jax_get_config
from repro.models.layers import ParamDef as JaxParamDef
from repro.models.layers import ShardingRules as JaxRules
from repro_torch.analysis import analytic, roofline
from repro_torch.launch import sharding, specs
from repro_torch.launch.mesh import MeshDesc, dp_axes, make_mesh
from repro_torch.models import SHAPES, all_configs, cell_is_applicable, get_config
from repro_torch.models.layers import ShardingRules, placements

MESHES = {"16x16": ((16, 16), ("data", "model")),
          "2x16x16": ((2, 16, 16), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
FLAGS = {"default": None,
         "fsdp+sp": dict(fsdp=True, seq_parallel=True),
         "dp_over_model": dict(dp_over_model=True)}
ARCHS = sorted(all_configs())
CELLS = [(a, s) for a in ARCHS for s in SHAPES
         if cell_is_applicable(get_config(a), SHAPES[s])[0]]


class _Devices:
    def __init__(self, shape):
        self.shape = shape
        self.size = math.prod(shape)


class _JaxMesh:
    """What the reference's sharding code reads of a mesh."""

    def __init__(self, shape, names):
        self.axis_names = names
        self.devices = _Devices(shape)


def _flags(mod, cfg, name):
    f = mod.default_flags(cfg)
    return f if FLAGS[name] is None else dataclasses.replace(f, **FLAGS[name])


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _flatten(v, f"{prefix}.{k}" if prefix else k)
    else:
        yield prefix, tree


def _local_bytes(shape, spec, dtype_bytes, mesh_shape):
    n = 1
    for size, entry in zip(shape, spec):
        axes = () if entry is None else ((entry,) if isinstance(entry, str)
                                         else tuple(entry))
        n *= size // math.prod(mesh_shape[a] for a in axes)
    return n * dtype_bytes


@functools.lru_cache(maxsize=None)
def _jax_cache(arch, shape_name):
    cfg = jax_get_config(arch)
    shape = JAX_SHAPES[shape_name]
    return jax.eval_shape(lambda: JaxModel(cfg, None).init_cache(
        shape.global_batch, shape.seq_len))


def _reference(arch, shape_name, mesh_name, flags_name):
    """{dotted leaf key: (spec as a tuple, shape, bytes a device holds)}"""
    cfg = jax_get_config(arch)
    shape = JAX_SHAPES[shape_name]
    mesh = _JaxMesh(*MESHES[mesh_name])
    mesh_shape = dict(zip(*reversed(MESHES[mesh_name])))
    flags = _flags(jax_sharding, cfg, flags_name)
    rules = jax_sharding.build_rules(cfg, mesh, flags)
    defs = dict(_flatten(JaxModel(cfg, rules).param_defs()))
    out = {}

    def put(key, spec, shp, dtype):
        spec = tuple(spec)
        out[key] = (spec, tuple(shp), _local_bytes(
            shp, spec, np.dtype(dtype).itemsize, mesh_shape))

    for k, d in defs.items():
        put(f"params.{k}", rules.spec_for(d), d.shape, d.dtype)
    if shape.kind == "train":
        orules = jax_specs.opt_rules(rules, mesh, flags)
        for k, d in defs.items():
            for m in ("mu", "nu"):
                put(f"opt_state.{m}.{k}", orules.spec_for(d), d.shape,
                    np.float32)
        put("opt_state.step", (), (), np.int32)
    bstruct = jax_specs.batch_struct(cfg, shape)
    logical = jax_specs._DECODE_LOGICAL if shape.kind == "decode" \
        else jax_specs._BATCH_LOGICAL
    micro = shape.kind == "train" and cfg.grad_accum > 1
    for k, v in bstruct.items():
        put(f"batch.{k}", jax_specs._spec_with_micro(rules, v.shape,
                                                     logical[k], micro),
            v.shape, v.dtype)
    if shape.kind == "decode":
        for k, v in _jax_cache(arch, shape_name).items():
            put(f"cache.{k}", rules.spec_for_shape(
                v.shape, jax_specs._cache_logical(cfg, k)), v.shape, v.dtype)
    return out


@pytest.mark.parametrize("flags_name", list(FLAGS))
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_input_specs_match_reference(arch, shape_name, mesh_name, flags_name):
    ref = _reference(arch, shape_name, mesh_name, flags_name)
    cfg = get_config(arch)
    mesh = make_mesh(*MESHES[mesh_name])
    flags = _flags(sharding, cfg, flags_name)
    kwargs, shardings, rules, model = specs.input_specs(arch, SHAPES[shape_name],
                                                        mesh, flags)
    got = specs.flat_specs(kwargs, shardings)
    assert sorted(got) == sorted(ref)
    per_top = {}
    for key, (t, lay) in got.items():
        spec, shp, nbytes = ref[key]
        assert lay.spec == spec, key
        assert tuple(t.shape) == shp, key
        assert t.device.type == "meta"
        assert lay.placements == placements(spec, mesh), key
        top = key.split(".")[0]
        per_top[top] = per_top.get(top, 0) + nbytes
    assert specs.argument_bytes(kwargs, shardings, mesh) == per_top
    # every rule the same, the mesh's sizes the same
    jrules = jax_sharding.build_rules(cfg, _JaxMesh(*MESHES[mesh_name]),
                                      _flags(jax_sharding, cfg, flags_name))
    assert rules.rules == jrules.rules
    assert rules.mesh_shape == jrules.mesh_shape


@pytest.mark.parametrize("arch", ARCHS)
def test_param_defs_carry_reference_logical_names(arch):
    """Every stacked def: the reference's shape, logical names, dtype, init,
    scale and fan_in."""
    cfg = get_config(arch)
    jdefs = dict(_flatten(JaxModel(jax_get_config(arch)).param_defs()))
    defs = specs.Model(cfg, device="meta").stacked_param_defs()
    assert sorted(defs) == sorted(jdefs)
    for k, d in defs.items():
        j = jdefs[k]
        assert (d.shape, d.logical, d.init, d.scale) == \
            (tuple(j.shape), tuple(j.logical), j.init, j.scale), k
        assert str(d.dtype).split(".")[-1] == np.dtype(j.dtype).name, k
        assert d.fan_in == j.fan_in, k


@pytest.mark.parametrize("multi_pod", [False, True])
def test_meshes_and_batch_specs(multi_pod):
    from repro_torch.launch.mesh import make_production_mesh
    mesh = make_production_mesh(multi_pod=multi_pod)
    shape = (2, 16, 16) if multi_pod else (16, 16)
    assert mesh == MeshDesc(shape, MESHES["x".join(map(str, shape))][1])
    assert dp_axes(mesh) == tuple(a for a in mesh.axis_names if a != "model")
    jmesh = _JaxMesh(shape, mesh.axis_names)
    for arch in ARCHS:
        cfg = get_config(arch)
        for kind in ("train", "prefill", "decode"):
            got = sharding.batch_specs(cfg, mesh, kind)
            exp = jax_sharding.batch_specs(jax_get_config(arch), jmesh, kind)
            assert {k: tuple(v) for k, v in exp.items()} == got


@pytest.mark.parametrize("arch,shape_name", CELLS)
def test_cost_models_match_reference(arch, shape_name):
    cfg, jcfg = get_config(arch), jax_get_config(arch)
    shape, jshape = SHAPES[shape_name], JAX_SHAPES[shape_name]
    assert cfg.active_param_count() == jcfg.active_param_count()
    assert roofline.model_flops(cfg, shape) == jax_roofline.model_flops(jcfg, jshape)
    for chips, m in ((256, 16), (512, 16), (4, 2)):
        assert analytic.analytic_bytes(cfg, shape, chips, model_axis=m) == \
            jax_analytic.analytic_bytes(jcfg, jshape, chips, model_axis=m)
    bw = 1.234e12      # kernel_memory_s takes the model axis of 16
    for chips in (256, 512):
        assert analytic.kernel_memory_s(cfg, shape, chips, hbm_bw=bw) == \
            jax_analytic.kernel_memory_s(jcfg, jshape, chips, hbm_bw=bw)


def test_combine_layer_diff_and_roofline_terms():
    base = {"flops": 100.0, "bytes": 10.0, "coll": 3.0}
    two = {"flops": 160.0, "bytes": 14.0, "coll": 2.0}
    for n in (1, 11, 88):
        assert roofline.combine_layer_diff(base, two, n) == \
            jax_roofline.combine_layer_diff(base, two, n)
    h = roofline.H100
    assert (h.peak_flops, h.hbm_bw, h.link_bw) == (989e12, 3.35e12, 450e9)
    t = roofline.roofline_terms(flops_per_dev=989e12, bytes_per_dev=1e9,
                                coll_bytes_per_dev=1e9, chips=256)
    assert t.compute_s == pytest.approx(1.0) and t.dominant == "compute"
    t = roofline.roofline_terms(flops_per_dev=1e12, bytes_per_dev=3.35e12 * 2,
                                coll_bytes_per_dev=1e9, chips=256)
    assert t.dominant == "memory" and t.memory_s == pytest.approx(2.0)
    t = roofline.roofline_terms(flops_per_dev=1.0, bytes_per_dev=1.0,
                                coll_bytes_per_dev=450e9 * 3, chips=4)
    assert t.dominant == "collective" and t.collective_s == pytest.approx(3.0)


def _rules_16():
    return dict(rules={"vocab": ("model",), "heads": ("model",),
                       "ffn": ("model",), "embed": ("data",),
                       "batch": ("data",)},
                mesh_shape={"data": 16, "model": 16})


@pytest.mark.parametrize("shape,logical", [
    ((960, 15, 64), ("embed", "heads", None)),     # 15 heads: replicated
    ((960, 2560), ("embed", "ffn")),
    ((6144, 48, 128), ("embed", "heads", None)),
])
def test_divisibility_fallback(shape, logical):
    got = ShardingRules(**_rules_16()).spec_for_shape(shape, logical)
    assert got == tuple(JaxRules(**_rules_16()).spec_for_shape(shape, logical))
    assert got == {(960, 15, 64): ("data", None, None),
                   (960, 2560): ("data", "model"),
                   (6144, 48, 128): ("data", "model", None)}[shape]


def test_axis_used_once_and_multi_axis_dim():
    kw = dict(rules={"a": ("model",), "b": ("model",)}, mesh_shape={"model": 4})
    got = ShardingRules(**kw).spec_for_shape((8, 8), ("a", "b"))
    assert got == tuple(JaxRules(**kw).spec_for_shape((8, 8), ("a", "b")))
    assert got in (("model", None), (None, "model"))
    kw = dict(rules={"embed": ("pod", "data")},
              mesh_shape={"pod": 2, "data": 16})
    r = ShardingRules(**kw)
    assert r.spec_for_shape((64,), ("embed",)) == (("pod", "data"),)
    assert r.spec_for_shape((33,), ("embed",)) == (None,)
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_mesh((2, 16), ("pod", "data"))
    assert placements((("pod", "data"),), mesh) == (Shard(0), Shard(0))
    assert placements((None, "data"), mesh) == (Replicate(), Shard(1))


def test_constrain_off_mesh_is_identity():
    """Off a mesh (no DTensor, or no rules) nothing changes; a ParamDef
    without logical names has one None a dim, as before."""
    from repro_torch.models.layers import ParamDef, constrain
    x = torch.ones(2, 3)
    r = ShardingRules(**_rules_16())
    assert constrain(x, ("batch", None), r) is x
    assert constrain(x, ("batch", None), None) is x
    assert ParamDef((4, 5)).logical == (None, None)
    with pytest.raises(ValueError):
        ParamDef((4, 5), logical=("embed",))
    assert JaxParamDef((4,), ("embed",)).logical == ("embed",)


@pytest.mark.parametrize("arch,mesh,blocks", [
    # kv sharded with the heads: each rank's 4 q heads read its own 2 kv heads
    ("h2o-danube-3-4b", (2, 2), [(0, 4), (4, 4)]),
    # 2 kv heads replicated on a 4-way axis: one kv head per rank, two ranks each
    ("h2o-danube-3-4b-reduced", (1, 4), [(0, 1), (0, 1), (1, 1), (1, 1)]),
    # qwen3-moe's 4 kv heads on 16 ways: ranks 4c … 4c + 3 read kv head c
    ("qwen3-moe-235b-a22b", (1, 16), [(r // 4, 1) for r in range(16)]),
    # internlm2-20b's 8 heads a rank straddle its groups of 6: raises
    ("internlm2-20b", (1, 6), None),
])
def test_local_flash_kv_heads(arch, mesh, blocks):
    """The kv heads each rank's local q heads read under the default rules
    (``attention._kv_block``): kv replicated where the fallback leaves it
    so, and a split of the heads that straddles GQA groups refused."""
    from repro_torch.models import resolve_config
    from repro_torch.models.attention import _kv_block
    cfg = resolve_config(arch)
    rules = sharding.build_rules(cfg, make_mesh(mesh, ("data", "model")))
    H, KV, ways = cfg.n_heads, cfg.n_kv, mesh[1]
    assert rules.spec_for_shape((H,), ("heads",)) == ("model",)
    kv_sharded = rules.spec_for_shape((KV,), ("kv",)) == ("model",)
    n = H // ways
    if blocks is None:
        assert not kv_sharded
        with pytest.raises(ValueError, match="straddle"):
            _kv_block(H, KV, n, n)
        return
    assert kv_sharded == (len(set(blocks)) == ways)
    assert [_kv_block(H, KV, r * n, n) for r in range(ways)] == blocks
