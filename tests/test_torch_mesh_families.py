"""The moe, hybrid, ssm, vlm and encdec families on a mesh of 4 gloo CPU
ranks (one ``RankPool`` for the module), against the unsharded port and
the reference, in f32.

- Sharded prefill and 2 decode steps of every case below: logits within
  1e-5 of their largest magnitude of the unsharded port's on the same
  weights (the reference's, which the ranks load), the prefill within the
  same tolerance of the reference's (encdec's within 2e-3, as
  ``tests/test_torch_families.py`` holds it: both packages round the frames
  to bf16 and XLA keeps some of the first layer's intermediates in f32),
  and the serving step's greedy tokens equal to the unsharded port's.  The
  decode steps write into two model ranks' shards of the KV slots (40
  slots: positions 19 and 20; recurrentgemma's 32 ring slots: 15 and 16).
  The cases: mixtral-8x22b-reduced as EP (4 experts over the model axis)
  on (2, 2) and (1, 4) and as TP-MoE (3 experts, each one's ffn split) on
  (2, 2), its one dispatch group of 80 tokens straddling the data ranks;
  qwen3-moe-235b-a22b-reduced with the sorted dispatch and groups of 8 on
  (2, 2), each rank routing its own groups; recurrentgemma-2b-reduced and
  falcon-mamba-7b-reduced under the default flags and fsdp + sp on (2, 2)
  and the default on (1, 4); internvl2-76b-reduced (8 patches) and
  seamless-m4t-large-v2-reduced (10 frames) on (2, 2).
- Routing on the mesh: ``route_topk`` and ``route_sorted`` fed the same
  f32 logits give the unsharded dispatch, combine and sorted slots bit for
  bit, for groups inside a rank (groups of 8), one group split over the
  data ranks (the reduced configs' default, 80 tokens) and a decode step's
  group (B tokens), with and without dropped tokens; the aux loss within
  1e-6 of the unsharded value.
- ``launch.dryrun.execute`` of a vlm prefill cell with a depth cut
  (``overrides``) on 2 spawned CPU ranks.
The reference side is computed once per module."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch.train import _resolve_config as jax_resolve_config
from repro.models import Model as JaxModel
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch.sharded import routing_rank, serve_rank
from repro_torch.launch.spawn import RankPool
from repro_torch.models import Model, moe, resolve_config

CPU = torch.device("cpu")
AXES = ("data", "model")
B, S, DECODE = 2, 40, 2
START = {"hybrid": 15}       # the first decode position (else 19): its two
                             # slots lie on two model ranks' shards
TOL = 1e-5                   # of the largest magnitude (test_torch_mesh)
REF_TOL = {"encdec": 2e-3}   # the prefill against the reference
FSDP_SP = {"fsdp": True, "seq_parallel": True}
# (id, arch, config overrides, mesh, policy flags)
CASES = (
    ("mixtral-ep", "mixtral-8x22b-reduced", None, (2, 2), None),
    ("mixtral-ep-1x4", "mixtral-8x22b-reduced", None, (1, 4), None),
    ("mixtral-tp-moe", "mixtral-8x22b-reduced", {"n_experts": 3}, (2, 2), None),
    ("qwen3-sort", "qwen3-moe-235b-a22b-reduced",
     {"moe_dispatch": "sort", "moe_group": 8}, (2, 2), None),
    ("rg", "recurrentgemma-2b-reduced", None, (2, 2), None),
    ("rg-fsdp-sp", "recurrentgemma-2b-reduced", None, (2, 2), FSDP_SP),
    ("rg-1x4", "recurrentgemma-2b-reduced", None, (1, 4), None),
    ("mamba", "falcon-mamba-7b-reduced", None, (2, 2), None),
    ("mamba-fsdp-sp", "falcon-mamba-7b-reduced", None, (2, 2), FSDP_SP),
    ("mamba-1x4", "falcon-mamba-7b-reduced", None, (1, 4), None),
    ("internvl2", "internvl2-76b-reduced", None, (2, 2), None),
    ("seamless", "seamless-m4t-large-v2-reduced", None, (2, 2), None),
)


def _key(arch, overrides):
    return arch + repr(sorted((overrides or {}).items()))


def _inputs(cfg, rng):
    """numpy prefill inputs in the family's layout (f32 patches; f32 frames
    of bf16 values) and the decode tokens."""
    text = S - cfg.n_patches if cfg.family == "vlm" else S
    out = {"tokens": rng.integers(0, cfg.vocab, (B, text)).astype(np.int32)}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)
                                             ).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = torch.randn(
            (B, S // cfg.frame_ratio, cfg.d_model),
            generator=torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        ).to(torch.bfloat16).float().numpy()
    return out, rng.integers(0, cfg.vocab, (B, DECODE)).astype(np.int32)


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, backend="gloo", device="cpu", timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def ref_out():
    """Per (arch, overrides): the reference's f32 weights, inputs and
    prefill logits, and the unsharded port's prefill and decode logits and
    greedy tokens on them."""
    out = {}
    for i, (_, arch, over, _, _) in enumerate(CASES):
        key = _key(arch, over)
        if key in out:
            continue
        cfg = dataclasses.replace(jax_resolve_config(arch), **(over or {}))
        if cfg.family == "encdec":
            # as tests/test_torch_families.py: the encoder's scan refuses a
            # carry whose dtype changes (bf16 frames into f32 layers)
            cfg = dataclasses.replace(cfg, scan_layers=False)
        model = JaxModel(cfg)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              model.init(jax.random.key(i)))
        batch, dec = _inputs(cfg, np.random.default_rng(i))
        tree = jax.tree.map(np.asarray, params)
        pcfg = dataclasses.replace(resolve_config(arch), **(over or {}))
        port = Model(pcfg, device=CPU)
        port.load_state_dict(model_params_from_numpy(pcfg, tree, CPU),
                             assign=True)
        start = START.get(pcfg.family, 19)
        with torch.no_grad():
            prefill = port.prefill({k: torch.as_tensor(v)
                                    for k, v in batch.items()}).numpy()
            cache = port.init_cache(B, S)
            logits = []
            for t in range(DECODE + 1):
                cache, lg = port.decode_step(cache, {
                    "tokens": torch.as_tensor(dec[:, min(t, DECODE - 1)]),
                    "pos": torch.full((B,), start + t, dtype=torch.int32)})
                logits.append(lg.numpy())
        out[key] = {
            "tree": tree, "batch": batch, "dec": dec, "start": start,
            "family": pcfg.family,
            "ref_prefill": np.asarray(jax.jit(model.prefill)(
                params, {k: jnp.asarray(v) for k, v in batch.items()})[1]),
            "prefill": prefill, "decode": np.stack(logits[:DECODE]),
            "next": logits[DECODE].argmax(-1)}
    return out


def _close(got, exp, tol=TOL):
    err = float(np.abs(got - exp).max())
    assert err <= tol * float(np.abs(exp).max()), err


@pytest.mark.parametrize("arch,over,mesh,flags",
                         [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_family_on_a_mesh_matches_unsharded_and_reference(pool, ref_out, arch,
                                                          over, mesh, flags):
    r = ref_out[_key(arch, over)]
    ranks = pool.call(serve_rank, arch, mesh, AXES, flags, 0, r["tree"], None,
                      r["batch"], r["dec"], S, False, r["start"], over)
    got = ranks[0]
    assert got["prefill_logits"].shape == r["prefill"].shape
    _close(got["prefill_logits"], r["prefill"])
    _close(got["prefill_logits"], r["ref_prefill"],
           REF_TOL.get(r["family"], TOL))
    _close(got["decode_logits"], r["decode"])
    for rank in ranks:
        np.testing.assert_array_equal(rank["decode"]["next_tokens"], r["next"])
    # the weights are split: no rank holds them all
    total = sum(v.size * 4 for v in jax.tree.leaves(r["tree"]))
    assert all(rank["weight_bytes"] < total for rank in ranks)
    assert got["prefill"]["collectives"]["count"] > 0


# (G, g, E) logits split over the data ranks along dim: groups of 8 inside
# a rank; one group of 80 tokens over its tokens; a decode step's group of
# B = 4 tokens.  At capacity factor 0.25 the group of 80 drops tokens (a
# group of g ≤ 8 cannot: an expert takes at most one choice a token, and
# has at least 8 slots)
ROUTING = (("groups", (10, 8, 8), 0), ("one group", (1, 80, 8), 1),
           ("decode", (1, 4, 8), 1))


@pytest.mark.parametrize("capacity_factor", [1.25, 0.25])
@pytest.mark.parametrize("name,shape,dim", ROUTING, ids=[r[0] for r in ROUTING])
def test_routing_on_a_mesh_is_unsharded_bit_for_bit(pool, name, shape, dim,
                                                    capacity_factor):
    cfg = dataclasses.replace(resolve_config("qwen3-moe-235b-a22b-reduced"),
                              capacity_factor=capacity_factor)
    k, (G, g, E) = cfg.top_k, shape
    capacity = moe.moe_capacity(cfg, g)
    logits = np.random.default_rng(g).standard_normal(shape).astype(np.float32)
    got = pool.call(routing_rank, logits, k, capacity, (2, 2), AXES, dim)[0]
    lg = torch.from_numpy(logits)
    dispatch, combine, aux = moe.route_topk(lg, k, capacity)
    slots, aux_sorted = moe.route_sorted(lg, k, capacity)
    assert np.array_equal(got["dispatch"], dispatch.numpy())
    assert np.array_equal(got["combine"], combine.numpy())
    for field, exp in slots._asdict().items():
        assert np.array_equal(got[field], exp.numpy()), field
    assert abs(got["aux"] - float(aux)) <= 1e-6
    assert abs(got["aux_sorted"] - float(aux_sorted)) <= 1e-6
    dropped = G * g * k - int(dispatch.sum())
    assert dropped == int((~slots.keep).sum())
    if capacity_factor < 1 and name == "one group":
        assert dropped > 0          # 8 slots an expert for 160 choices


def test_dryrun_execute_runs_a_vlm_cell_with_a_depth_cut(monkeypatch):
    """``--execute``'s cell runner on internvl2-76b-reduced cut to 1 layer:
    a prefill cell of (2, 24) (8 patches from ``data.family_batch`` and 16
    tokens) on the (1, 2) mesh of 2 CPU ranks, under the registered
    config's policy."""
    from repro_torch.launch.dryrun import execute
    from repro_torch.launch.sharding import default_flags
    from repro_torch.models import SHAPES, ShapeConfig
    monkeypatch.setitem(SHAPES, "tiny", ShapeConfig("tiny", 24, 2, "prefill"))
    arch = "internvl2-76b-reduced"
    rec = execute(arch, "tiny", "1x2", "cpu", overrides={"n_layers": 1})
    assert (rec["world"], rec["device"]) == (2, "cpu")
    flags = dataclasses.asdict(default_flags(resolve_config(arch)))
    cut = Model(dataclasses.replace(resolve_config(arch), n_layers=1),
                device="meta")
    total = sum(p.numel() * p.element_size() for p in cut.parameters())
    for r in rec["ranks"]:
        assert r["flags"] == flags
        assert r["prefill"]["wall_s"] > 0 and r["prefill"]["collectives"]["count"] > 0
        assert r["prefill"]["local_logits"][0] == 2
        assert 0 < r["weight_bytes"] < total
