"""Sharded training of the dense family on a mesh of 4 gloo CPU ranks (one
``RankPool`` for the module), against the reference's jitted
``make_train_step`` and the one-process port.

- Two train steps of (n_micro 2, mb 2, S 16) in f32 on weights from the
  reference's ``Model.init``, batches drawn by numpy from a seed
  (``launch.sharded.train_rank``): h2o-danube-3-4b-reduced on the (2, 2)
  ("data", "model") mesh under the default flags (TP + DP, ZeRO-1), under
  fsdp + seq_parallel and with ``zero1`` off, and on the (4, 1) and
  (1, 4) meshes (on (1, 4) its 2 kv heads are replicated under 4 q-head
  shards, the case whose k/v gradients are partial sums over the ranks:
  ``models.attention.local_heads``); smollm-360m-reduced under the dry
  run's ``--opt`` policy (``dp_over_model`` + ``zero1``).  On (4, 1) the
  micro-batch of 2 does not divide over 4 data ranks, so the fallback
  replicates it (the moments are still split 4 ways).
- Each step's loss and grad norm within 1e-5 relative of the reference's.
  Each step is held against the one-process port's step from the same
  state: the mesh's state after step 1 (its checkpoint) against the
  one-process step 1, and its state after step 2 (gathered) against the
  one-process step 2 taken from that checkpoint.  ``mu`` and ``nu``
  within 1e-5 of each leaf's largest magnitude; the parameters within
  1e-5 (absolute).  Not of each leaf's largest magnitude: AdamW divides
  each moment by √ν + ε, so at an element whose gradient is near ε
  (10⁻⁸) a rounding difference of 10⁻⁹ of the leaf's scale moves that
  element's update by a percent of lr; the worst such element of these
  runs moves by 2.7·10⁻⁵ of its leaf's scale (1.5·10⁻⁶ absolute).
- remat "full" and "dots" on (2, 2): bit-equal to no remat, the
  backward's collectives more (the forward's, recomputed).
- Checkpoints: the (2, 2) state after step 1 restores onto one process
  ``torch.equal`` to the mesh's leaves (on every rank, its blocks),
  onto the (1, 4) mesh bit-equal to the checkpoint, and one more step on
  (2, 2) after the restore equals the uninterrupted run's step 2 bit for
  bit; the reference's ``load_checkpoint`` reads the mesh's checkpoint.
- ``dryrun.execute`` of a train cell on 2 spawned CPU ranks, with a depth
  cut: a rank's optimizer-state bytes equal ``argument_bytes``'
  ``opt_state`` per device; the same for a moe train cell
  (``tests/test_torch_mesh_train_families.py`` holds the other families'
  sharded steps).
The reference side is computed once per module."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint.manager import load_checkpoint as jax_load_checkpoint
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.train import _resolve_config as jax_resolve_config
from repro.models import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import adamw_init as jax_adamw_init
from repro_torch.checkpoint import load_checkpoint
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch.mesh import make_mesh
from repro_torch.launch.sharded import train_rank
from repro_torch.launch.sharding import PolicyFlags, default_flags
from repro_torch.launch.specs import argument_bytes, input_specs
from repro_torch.launch.spawn import RankPool
from repro_torch.launch.steps import make_train_step
from repro_torch.models import Model, ShapeConfig, resolve_config
from repro_torch.optim import AdamWState, adamw_init

CPU = torch.device("cpu")
ARCHS = ("h2o-danube-3-4b-reduced", "smollm-360m-reduced")
AXES = ("data", "model")
N_MICRO, MB, S, STEPS = 2, 2, 16, 2
TOL = 1e-5
FSDP_SP = {"fsdp": True, "seq_parallel": True}
OPT = {"dp_over_model": True, "zero1": True}     # smollm-360m's --opt policy
CASES = [
    ("h2o-danube-3-4b-reduced", (2, 2), None),
    ("h2o-danube-3-4b-reduced", (2, 2), FSDP_SP),
    ("h2o-danube-3-4b-reduced", (2, 2), {"zero1": False}),
    ("h2o-danube-3-4b-reduced", (4, 1), None),
    ("h2o-danube-3-4b-reduced", (1, 4), None),
    ("smollm-360m-reduced", (2, 2), OPT),
]
IDS = ["danube-2x2", "danube-2x2-fsdp-sp", "danube-2x2-no-zero1",
       "danube-4x1", "danube-1x4", "smollm-2x2-opt"]


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, backend="gloo", device="cpu", timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def ref():
    """Per arch: the reference's f32 weights (numpy tree), the two batches
    and its jitted steps' losses and grad norms."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = jax_resolve_config(arch)
        model = JaxModel(cfg)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              model.init(jax.random.key(i)))
        rng = np.random.default_rng(i)
        toks = rng.integers(0, cfg.vocab, (STEPS, N_MICRO, MB, S + 1)
                            ).astype(np.int32)
        batches = [{"tokens": t[..., :-1], "labels": t[..., 1:]} for t in toks]
        step = jax.jit(jax_make_train_step(model, JaxAdamWConfig()))
        p, st, metrics = params, jax_adamw_init(params), []
        for b in batches:
            p, st, m = step(p, st, {k: jnp.asarray(v) for k, v in b.items()})
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[arch] = {"tree": jax.tree.map(np.asarray, params),
                     "batches": batches, "metrics": metrics}
    return out


@pytest.fixture(scope="module")
def runs(pool, ref, tmp_path_factory):
    """Each case's mesh run, on demand, once: two steps, the state saved
    after step 1 (the (2, 2) default case also restores it onto one
    process on the ranks), everything gathered after step 2."""
    done = {}

    def run(case):
        key = repr(case)
        if key not in done:
            arch, mesh, flags = case
            d = tmp_path_factory.mktemp("ck")
            out = pool.call(train_rank, arch, mesh, AXES,
                            ref[arch]["batches"], flags, 0, ref[arch]["tree"],
                            None, None, ("params", "mu", "nu"), str(d), None,
                            case == CASES[0])
            done[key] = (out, d)
        return done[key]

    return run


def _one_process(arch, params, state, batch):
    """The port's one-process train step from ``params`` (numpy by name)
    and ``state`` (AdamWState of numpy, or None: zero moments) on
    ``batch`` → (loss, grad norm, {params, mu, nu} numpy)."""
    model = Model(resolve_config(arch), device=CPU)
    model.load_state_dict({k: torch.as_tensor(v) for k, v in params.items()},
                          assign=True)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    if state is None:
        state = adamw_init(named)
    else:
        state = AdamWState(step=torch.as_tensor(state.step),
                           mu={k: torch.as_tensor(v).clone()
                               for k, v in state.mu.items()},
                           nu={k: torch.as_tensor(v).clone()
                               for k, v in state.nu.items()})
    state, m = make_train_step(model)(
        state, {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(m["loss"]), float(m["grad_norm"]), {
        "params": {k: p.detach().numpy() for k, p in named.items()},
        "mu": {k: v.numpy() for k, v in state.mu.items()},
        "nu": {k: v.numpy() for k, v in state.nu.items()}}


def _like(arch):
    """The train state's structure as the ranks checkpoint it."""
    model = Model(resolve_config(arch), device=CPU)
    named = {k: p.detach() for k, p in model.named_parameters()}
    return {"params": named, "opt": adamw_init(named)}


def _np(tree):
    return {k: v.numpy() for k, v in tree.items()}


def _assert_state(got, exp, what):
    for k, e in exp["params"].items():
        err = float(np.abs(got["params"][k] - e).max())
        assert err <= TOL, (what, "params", k, err)
    for name in ("mu", "nu"):
        for k, e in exp[name].items():
            err = float(np.abs(got[name][k] - e).max())
            assert err <= TOL * float(np.abs(e).max()), (what, name, k, err)


def _rel(got, exp):
    return abs(got - exp) / abs(exp)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_sharded_train_steps_match_reference_and_one_process(runs, ref, case):
    arch = case[0]
    out, d = runs(case)
    r0, batches = out[0], ref[arch]["batches"]
    for got, (loss, gnorm) in zip(r0["steps"], ref[arch]["metrics"]):
        assert _rel(got["loss"], loss) <= TOL, (got["loss"], loss)
        assert _rel(got["grad_norm"], gnorm) <= TOL, (got["grad_norm"], gnorm)
    assert [s["step"] for s in r0["steps"]] == [1, 2]
    for r in out:     # every rank holds the same metrics
        assert [(s["loss"], s["grad_norm"]) for s in r["steps"]] == \
            [(s["loss"], s["grad_norm"]) for s in r0["steps"]]
    # step 1, from the same initial weights
    tree = ref[arch]["tree"]
    init = {k: v.numpy() for k, v in model_params_from_numpy(
        resolve_config(arch), tree, CPU).items()}
    *_, exp1 = _one_process(arch, init, None, batches[0])
    saved, meta = load_checkpoint(_like(arch), d, 1)
    assert meta == {"step": 1} and int(saved["opt"].step) == 1
    got1 = {"params": _np(saved["params"]), "mu": _np(saved["opt"].mu),
            "nu": _np(saved["opt"].nu)}
    _assert_state(got1, exp1, "step 1")
    # step 2, from the mesh's state after step 1
    loss, gnorm, exp2 = _one_process(
        arch, got1["params"], AdamWState(step=saved["opt"].step,
                                         mu=got1["mu"], nu=got1["nu"]),
        batches[1])
    assert _rel(r0["steps"][1]["loss"], loss) <= TOL
    assert _rel(r0["steps"][1]["grad_norm"], gnorm) <= TOL
    _assert_state(r0, exp2, "step 2")
    # the moments are split as opt_rules says: the dry run's bytes a device
    cfg = resolve_config(arch)
    mesh = make_mesh(case[1], AXES)
    flags = PolicyFlags(**case[2]) if case[2] else default_flags(cfg)
    kwargs, shardings, _, _ = input_specs(
        cfg, ShapeConfig("t", S, N_MICRO * MB, "train"), mesh, flags)
    opt_bytes = argument_bytes(kwargs, shardings, mesh)["opt_state"]
    for r in out:
        assert r["opt_state_bytes"] == opt_bytes
        coll = r["steps"][-1]["collectives"]
        assert set(coll["by_phase"]) <= {"forward", "backward", "optimizer"}
        assert coll["total"] == sum(p["total"] for p in coll["by_phase"].values())
        assert r["host_staged_messages"] == 0          # CPU tensors


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_on_a_mesh_recomputes_the_forward_bit_for_bit(pool, runs, ref,
                                                            remat):
    """danube-reduced (remat "none" as registered) with ``remat`` "full"
    (non-reentrant ``torch.utils.checkpoint``) and "dots" (the selective
    policy) on (2, 2): the same two steps bit for bit as without, and
    more collectives a step (the recomputed forward's)."""
    arch = CASES[0][0]
    exp, _ = runs(CASES[0])
    got = pool.call(train_rank, arch, (2, 2), AXES, ref[arch]["batches"],
                    None, 0, ref[arch]["tree"], None, {"remat": remat},
                    ("params", "mu", "nu"))
    for g, e in zip(got[0]["steps"], exp[0]["steps"]):
        assert (g["loss"], g["grad_norm"]) == (e["loss"], e["grad_norm"])
        assert g["collectives"]["by_phase"]["backward"]["count"] > \
            e["collectives"]["by_phase"]["backward"]["count"]
    for name in ("params", "mu", "nu"):
        for k, v in exp[0][name].items():
            assert np.array_equal(got[0][name][k], v), (name, k)


def test_checkpoint_restores_onto_another_mesh_and_one_process(pool, runs, ref):
    arch = CASES[0][0]
    out, d = runs(CASES[0])
    # onto one process, on the first rank, against the gathered leaves
    check = out[0]["restore_equal"]
    n_params = len(_like(arch)["params"])
    assert check["equal"] and check["leaves"] == 3 * n_params + 1, check
    assert all(r.get("restore_equal") is None for r in out[1:])
    saved, _ = load_checkpoint(_like(arch), d, 1)
    # onto the (1, 4) mesh: no step, every leaf gathered back
    got = pool.call(train_rank, arch, (1, 4), AXES, [], None, 0, None,
                    "float32", None, ("params", "mu", "nu"), None, str(d))[0]
    for k, v in saved["params"].items():
        assert np.array_equal(got["params"][k], v.numpy()), k
    for name in ("mu", "nu"):
        for k, v in getattr(saved["opt"], name).items():
            assert np.array_equal(got[name][k], v.numpy()), (name, k)
    # one more step on (2, 2) after the restore: the uninterrupted step 2
    got = pool.call(train_rank, arch, (2, 2), AXES, ref[arch]["batches"][1:],
                    None, 0, None, "float32", None, ("params", "mu", "nu"),
                    None, str(d))[0]
    assert got["steps"][0]["step"] == 2
    assert (got["steps"][0]["loss"], got["steps"][0]["grad_norm"]) == \
        (out[0]["steps"][1]["loss"], out[0]["steps"][1]["grad_norm"])
    for name in ("params", "mu", "nu"):
        for k, v in out[0][name].items():
            assert np.array_equal(got[name][k], v), (name, k)


def test_reference_reads_the_mesh_checkpoint(runs):
    arch = CASES[0][0]
    _, d = runs(CASES[0])
    like = _like(arch)
    saved, meta = load_checkpoint(like, d, 1)
    zeros = {k: np.zeros(v.shape, np.float32) for k, v in like["params"].items()}
    tree_like = {"params": zeros, "opt": {"step": np.zeros((), np.int32),
                                          "mu": zeros, "nu": zeros}}
    got, jmeta = jax_load_checkpoint(tree_like, d, 1)
    assert jmeta == meta
    assert int(got["opt"]["step"]) == 1
    for k, v in saved["params"].items():
        assert np.array_equal(np.asarray(got["params"][k]), v.numpy()), k
    for name in ("mu", "nu"):
        for k, v in getattr(saved["opt"], name).items():
            assert np.array_equal(np.asarray(got["opt"][name][k]), v.numpy())


def test_dryrun_execute_runs_a_train_cell_with_a_depth_cut(monkeypatch):
    """``--execute``'s cell runner on a train cell of (8, 16) on the
    (2, 1) mesh of 2 CPU ranks, danube-reduced cut to 1 layer: a warm step
    and a timed one of its grad_accum 4 micro-batches (of 2); each rank's
    optimizer-state bytes are the dry run's ``opt_state`` per device."""
    from repro_torch.launch.dryrun import execute
    from repro_torch.models import SHAPES
    shape = ShapeConfig("tiny", 16, 8, "train")
    monkeypatch.setitem(SHAPES, "tiny", shape)
    arch = "h2o-danube-3-4b-reduced"
    rec = execute(arch, "tiny", "2x1", "cpu", overrides={"n_layers": 1})
    assert (rec["world"], rec["device"], rec["micro_batches"]) == (2, "cpu", [4, 2])
    assert np.isfinite(rec["loss"]) and rec["grad_norm"] > 0
    full = resolve_config(arch)
    cut = dataclasses.replace(full, n_layers=1)
    kwargs, shardings, _, _ = input_specs(cut, shape, make_mesh((2, 1), AXES),
                                          default_flags(full))
    arg = argument_bytes(kwargs, shardings, make_mesh((2, 1), AXES))
    for r in rec["ranks"]:
        assert r["opt_state_bytes"] == arg["opt_state"]
        assert r["weight_bytes"] == arg["params"]
        assert r["wall_s"] > 0 and r["warm_wall_s"] > 0
        assert r["collectives"]["by_phase"]["optimizer"]["reduce-scatter"] > 0
        assert r["grad_bytes"] > 0


def test_dryrun_execute_runs_a_moe_train_cell_with_a_depth_cut(monkeypatch):
    """``--execute``'s cell runner on a moe train cell of (8, 16) on the
    (2, 1) mesh of 2 CPU ranks, mixtral-8x22b-reduced cut to 1 layer: a
    warm step and a timed one of its grad_accum 8 micro-batches (of 1);
    each rank's weight and optimizer-state bytes are the dry run's per
    device."""
    from repro_torch.launch.dryrun import execute
    from repro_torch.models import SHAPES
    shape = ShapeConfig("tiny", 16, 8, "train")
    monkeypatch.setitem(SHAPES, "tiny", shape)
    arch = "mixtral-8x22b-reduced"
    rec = execute(arch, "tiny", "2x1", "cpu", overrides={"n_layers": 1})
    assert (rec["world"], rec["device"], rec["micro_batches"]) == (2, "cpu", [8, 1])
    assert np.isfinite(rec["loss"]) and rec["grad_norm"] > 0
    full = resolve_config(arch)
    cut = dataclasses.replace(full, n_layers=1)
    mesh = make_mesh((2, 1), AXES)
    kwargs, shardings, _, _ = input_specs(cut, shape, mesh, default_flags(full))
    arg = argument_bytes(kwargs, shardings, mesh)
    for r in rec["ranks"]:
        assert r["opt_state_bytes"] == arg["opt_state"]
        assert r["weight_bytes"] == arg["params"]
        assert r["wall_s"] > 0 and r["warm_wall_s"] > 0
        assert r["grad_bytes"] > 0


def test_elastic_restart_example_runs_on_the_cpu(capsys):
    """``examples/elastic_restart_torch.py``: the train state saved and
    restored onto a mesh of one CPU rank with explicit layouts, bit for
    bit, and the data cursor."""
    import importlib.util
    from pathlib import Path
    path = Path(__file__).resolve().parents[1] / "examples" / \
        "elastic_restart_torch.py"
    spec = importlib.util.spec_from_file_location("elastic_restart_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "restored step=17, data cursor=17, onto a mesh of 1 rank(s)" in out
    assert "bit-identical restore onto a new layout" in out
