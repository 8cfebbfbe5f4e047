"""The model zoo on a mesh of 4 gloo CPU ranks (one ``RankPool`` for the
module), against the unsharded port and the reference.

- Sharded prefill and 2 decode steps of h2o-danube-3-4b-reduced and
  smollm-360m-reduced in f32 on the (2, 2) and (1, 4) ("data", "model")
  meshes (and fsdp + seq_parallel on (2, 2)), the decode steps at
  positions 19 and 20 of a 40-slot cache, so that they write into two
  model ranks' shards of the slots and the second attends over both:
  logits within 1e-5 of their
  largest magnitude of the unsharded port's on the same weights, and the
  prefill within the same tolerance of the reference's
  (``tests/test_torch_families.py``'s), whose weights the ranks load; the
  serving step's greedy tokens equal the unsharded port's.
- ``pipeline_forward`` at S = 2 and 4 stages (4 micro-batches, a 4-layer
  danube-reduced stack): ``torch.equal`` to the same layers applied in a
  loop, and within 1e-6 of the reference's layers in a loop on the same
  numpy inputs.
- ``shard_model`` from a seed: each shard equal to ``Model.init``'s.
- ``python -m repro_torch.launch.dryrun --execute`` of a small prefill and
  a small decode cell on 2 spawned CPU ranks.
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
from repro_torch.launch.pipeline import DecoderLayer, gpipe_ticks, pipeline_rank
from repro_torch.launch.sharded import serve_rank
from repro_torch.launch.spawn import RankPool
from repro_torch.models import Model, resolve_config

CPU = torch.device("cpu")
ARCHS = ("h2o-danube-3-4b-reduced", "smollm-360m-reduced")
AXES = ("data", "model")
B, S, DECODE = 2, 40, 2      # S > danube-reduced's window of 32
START = 19                   # the first decode position: slots 19 and 20 lie
                             # on two model ranks on (2, 2) and on (1, 4)
TOL = 1e-5                   # of the largest magnitude (test_torch_families)
PIPE_LAYERS, PIPE_M, PIPE_S = 4, 4, 40


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, backend="gloo", device="cpu", timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def ref_out():
    """The reference's f32 weights, prefill logits and inputs per arch, and
    the unsharded port's prefill and decode logits and greedy tokens on
    them."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = jax_resolve_config(arch)
        model = JaxModel(cfg)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              model.init(jax.random.key(i)))
        rng = np.random.default_rng(i)
        toks = rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)
        dec = rng.integers(0, cfg.vocab, (B, DECODE)).astype(np.int32)
        tree = jax.tree.map(np.asarray, params)
        pcfg = resolve_config(arch)
        port = Model(pcfg, device=CPU)
        port.load_state_dict(model_params_from_numpy(pcfg, tree, CPU),
                             assign=True)
        with torch.no_grad():
            prefill = port.prefill({"tokens": torch.as_tensor(toks)}).numpy()
            cache = port.init_cache(B, S)
            logits = []
            for t in range(DECODE):
                cache, lg = port.decode_step(cache, {
                    "tokens": torch.as_tensor(dec[:, t]),
                    "pos": torch.full((B,), START + t, dtype=torch.int32)})
                logits.append(lg.numpy())
            _, lg = port.decode_step(cache, {
                "tokens": torch.as_tensor(dec[:, -1]),
                "pos": torch.full((B,), START + DECODE, dtype=torch.int32)})
        out[arch] = {
            "tree": tree, "toks": toks, "dec": dec,
            "ref_prefill": np.asarray(jax.jit(model.prefill)(
                params, {"tokens": jnp.asarray(toks)})[1]),
            "prefill": prefill, "decode": np.stack(logits),
            "next": lg.argmax(-1).numpy()}
    return out


def _close(got, exp, tol=TOL):
    err = float(np.abs(got - exp).max())
    assert err <= tol * float(np.abs(exp).max()), err


@pytest.mark.parametrize("arch,mesh,flags", [
    ("h2o-danube-3-4b-reduced", (2, 2), None),
    ("h2o-danube-3-4b-reduced", (1, 4), None),
    ("h2o-danube-3-4b-reduced", (2, 2), {"fsdp": True, "seq_parallel": True}),
    ("smollm-360m-reduced", (2, 2), None),
    ("smollm-360m-reduced", (1, 4), None),
])
def test_sharded_serving_matches_unsharded_and_reference(pool, ref_out, arch,
                                                         mesh, flags):
    r = ref_out[arch]
    ranks = pool.call(serve_rank, arch, mesh, AXES, flags, 0, r["tree"], None,
                      r["toks"], r["dec"], S, False, START)
    got = ranks[0]
    assert got["prefill_logits"].shape == r["prefill"].shape
    _close(got["prefill_logits"], r["prefill"])
    _close(got["prefill_logits"], r["ref_prefill"])
    _close(got["decode_logits"], r["decode"])
    for rank in ranks:
        np.testing.assert_array_equal(rank["decode"]["next_tokens"], r["next"])
    # the weights are split: no rank holds them all
    total = sum(v.size * 4 for v in jax.tree.leaves(r["tree"]))
    assert all(rank["weight_bytes"] < total for rank in ranks)
    coll = got["prefill"]["collectives"]
    assert coll["count"] > 0 and coll["total"] == sum(
        v for k, v in coll.items() if k not in ("total", "count"))


def test_shard_model_equals_model_init(pool):
    """Shards drawn from seed 3 on the ranks, gathered, against
    ``Model.init`` from the same seed, leaf for leaf, bit for bit."""
    from repro_torch.launch.sharded import gathered_params_rank
    arch = "h2o-danube-3-4b-reduced"
    model = Model(resolve_config(arch), device=CPU)
    gen = torch.Generator()
    gen.manual_seed(3)
    model.init(gen)
    exp = {k: v.float().numpy() for k, v in model.state_dict().items()}
    for mesh in ((2, 2), (1, 4)):
        got = pool.call(gathered_params_rank, arch, mesh, AXES, 3)
        assert sorted(got[0]) == sorted(exp)
        for k, v in exp.items():
            assert np.array_equal(got[0][k], v), (mesh, k)


@pytest.fixture(scope="module")
def pipe():
    """A 4-layer danube-reduced stack (the reference's weights), 4
    micro-batches, the port's layers in a loop and the reference's."""
    cfg = dataclasses.replace(jax_resolve_config(ARCHS[0]), n_layers=PIPE_LAYERS)
    jm = JaxModel(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          jm.init(jax.random.key(7)))
    layers = jax.tree.map(np.array, params["layers"])
    x = np.random.default_rng(7).standard_normal(
        (PIPE_M, 1, PIPE_S, cfg.d_model)).astype(np.float32)
    pos = jnp.broadcast_to(jnp.arange(PIPE_S), (1, PIPE_S))

    @jax.jit
    def ref_stack(lps, xm):
        for i in range(PIPE_LAYERS):
            lp = jax.tree.map(lambda a: a[i], lps)
            xm = jm._attn_seq(lp["attn"], xm, pos, cfg.window)
            xm = jm._mlp(lp["mlp"], xm)
        return xm

    ref = np.stack([np.asarray(ref_stack(params["layers"], x[m]))
                    for m in range(PIPE_M)])
    pcfg = dataclasses.replace(resolve_config(ARCHS[0]), n_layers=PIPE_LAYERS)
    stacked = jax.tree.map(torch.as_tensor, layers)
    layer_fn = DecoderLayer(pcfg)
    with torch.no_grad():
        loop = []
        for m in range(PIPE_M):
            y = torch.as_tensor(x[m])
            for i in range(PIPE_LAYERS):
                y = layer_fn(jax.tree.map(lambda a: a[i], stacked), y)
            loop.append(y)
    return {"layer_fn": layer_fn, "stacked": stacked, "x": torch.as_tensor(x),
            "loop": torch.stack(loop), "ref": ref}


@pytest.mark.parametrize("stages", [2, 4])
def test_pipeline_forward_equals_the_loop(pool, pipe, stages):
    out = pool.call(pipeline_rank, pipe["layer_fn"], pipe["stacked"],
                    pipe["x"], stages)
    for r, res in enumerate(out):
        if r >= stages:
            assert res is None
            continue
        got, staged = res
        assert staged == 0                     # CPU tensors: nothing staged
        assert torch.equal(torch.as_tensor(got), pipe["loop"]), r
        np.testing.assert_allclose(got, pipe["ref"], rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("S,M,L,ok", [(4, 4, 24, True), (4, 8, 8, True),
                                      (4, 3, 8, False), (4, 4, 6, False)])
def test_gpipe_schedule_checks(S, M, L, ok):
    if ok:
        assert gpipe_ticks(S, M, L) == M + S - 1
    else:
        with pytest.raises(ValueError):
            gpipe_ticks(S, M, L)


@pytest.mark.parametrize("kind", ["prefill", "decode"])
def test_dryrun_execute_on_cpu_ranks(monkeypatch, capsys, kind):
    """``--execute`` of a serving cell of (2, 24) on the (1, 2) mesh: every
    rank reports its step's wall and collectives, and a decode cell's
    greedy tokens agree across ranks."""
    import json

    from repro_torch.launch.dryrun import main
    from repro_torch.models import SHAPES, ShapeConfig
    monkeypatch.setitem(SHAPES, "tiny", ShapeConfig("tiny", 24, 2, kind))
    assert main(["--execute", "--arch", "smollm-360m-reduced", "--shape", "tiny",
                 "--mesh", "1x2", "--device", "cpu"]) == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert (rec["world"], rec["device"], rec["shape"]) == (2, "cpu", "tiny")
    assert [r["rank"] for r in rec["ranks"]] == [0, 1]
    for r in rec["ranks"]:
        step = r[kind]
        wall = step["wall_s"] if kind == "prefill" else step["wall_s"][0]
        coll = step["collectives"] if kind == "prefill" else step["collectives"][0]
        assert wall > 0 and coll["count"] > 0
        assert r["weight_bytes"] > 0
    if kind == "decode":
        assert len({str(r["decode"]["next_tokens"]) for r in rec["ranks"]}) == 1
