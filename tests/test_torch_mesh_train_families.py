"""Sharded training of the moe, ssm, hybrid, vlm and encdec families on a
mesh of 4 gloo CPU ranks (one ``RankPool`` for the module), against the
reference's jitted ``make_train_step`` and the one-process port.

- One train step of (n_micro 2, mb 2, S 16) in f32 on the reference's
  ``Model.init`` weights, a batch drawn by numpy from a seed
  (``launch.sharded.train_rank``), for each case below: loss and grad
  norm within 1e-5 relative of the reference's (encdec's within 2e-3, as
  ``tests/test_torch_mesh_families.py`` holds its prefill: both packages
  round the frames to bf16 and XLA keeps some of the first layer's
  intermediates in f32).  A case with config overrides is held against
  the one-process port only.  Against the one-process port's step from
  the same weights: loss and grad norm within 1e-5 relative, ``mu`` and
  ``nu`` within 1e-5 of each leaf's largest magnitude, and the
  parameters within 1e-5 absolute wherever the gradient is at least
  10 ε (10⁻⁷).  Below that AdamW's first step g/(|g| + ε) turns a
  rounding difference in g into a parameter's: at an element of
  qwen3-moe's ``w2`` whose gradient is 4.7·10⁻⁹, a difference of
  7·10⁻⁸ of the leaf's largest moment moves the parameter by 1.1·10⁻⁵.
  So every parameter is also held within 1e-6 to the AdamW step that
  the mesh's own moments give from the initial weights.
- The cases are the ones whose backward runs through ``local_map`` on
  rank-local data: mixtral-8x22b-reduced as EP on (2, 2), its one
  dispatch group of 32 tokens straddling the data ranks, under the
  default flags and under fsdp + sp, and as TP-MoE (3 experts, each one's
  ffn split); qwen3-moe-235b-a22b-reduced with the sorted dispatch and
  groups of 8, each rank routing its own groups; falcon-mamba-7b-reduced
  on (2, 2) (the causal convolution's weights whole over split batch
  rows) and on (1, 4) (the readout's C whole over split channels);
  recurrentgemma-2b-reduced, internvl2-76b-reduced (8 patches) and
  seamless-m4t-large-v2-reduced (4 frames) on (2, 2).
- Checkpoints: the EP (2, 2) state after its step restores onto one
  process ``torch.equal`` to the mesh's leaves (each rank restores it and
  holds its blocks against the restored leaves), its parameters are the
  ones gathered from the mesh, and it restores onto the (1, 4) mesh
  bit-equal to the checkpoint.
The reference side is computed once per module."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

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
from repro_torch.optim import AdamWConfig, adamw_init

CPU = torch.device("cpu")
AXES = ("data", "model")
N_MICRO, MB, S = 2, 2, 16
TOL = 1e-5
REF_TOL = {"encdec": 2e-3}     # loss and grad norm against the reference
FSDP_SP = {"fsdp": True, "seq_parallel": True}
MIXTRAL = "mixtral-8x22b-reduced"
# (id, arch, config overrides, mesh, policy flags)
CASES = (
    ("mixtral-ep", MIXTRAL, None, (2, 2), None),
    ("mixtral-ep-fsdp-sp", MIXTRAL, None, (2, 2), FSDP_SP),
    ("mixtral-tp-moe", MIXTRAL, {"n_experts": 3}, (2, 2), None),
    ("qwen3-sort", "qwen3-moe-235b-a22b-reduced",
     {"moe_dispatch": "sort", "moe_group": 8}, (2, 2), None),
    ("mamba", "falcon-mamba-7b-reduced", None, (2, 2), None),
    ("mamba-1x4", "falcon-mamba-7b-reduced", None, (1, 4), None),
    ("rg", "recurrentgemma-2b-reduced", None, (2, 2), None),
    ("internvl2", "internvl2-76b-reduced", None, (2, 2), None),
    ("seamless", "seamless-m4t-large-v2-reduced", None, (2, 2), None),
)


def _key(arch, over):
    return arch + repr(sorted((over or {}).items()))


def _batch(cfg, rng):
    """numpy train batch (n_micro, mb, …) in the family's layout (f32
    patches; f32 frames of bf16 values) with labels."""
    text = S - cfg.n_patches if cfg.family == "vlm" else S
    toks = rng.integers(0, cfg.vocab, (N_MICRO, MB, text + 1)).astype(np.int32)
    out = {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal(
            (N_MICRO, MB, cfg.n_patches, cfg.d_model)).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = torch.randn(
            (N_MICRO, MB, S // cfg.frame_ratio, cfg.d_model),
            generator=torch.Generator().manual_seed(int(rng.integers(1 << 30)))
        ).to(torch.bfloat16).float().numpy()
    return out


def _port_cfg(arch, over):
    return dataclasses.replace(resolve_config(arch), **(over or {}))


def _one_process(cfg, tree, batch):
    """The port's one-process train step from the reference's weights
    ``tree`` → (loss, grad norm, {init, params, mu, nu} numpy)."""
    model = Model(cfg, device=CPU)
    model.load_state_dict(model_params_from_numpy(cfg, tree, CPU), assign=True)
    model.requires_grad_(True)
    named = dict(model.named_parameters())
    init = {k: p.detach().numpy().copy() for k, p in named.items()}
    state, m = make_train_step(model)(
        adamw_init(named), {k: torch.from_numpy(v) for k, v in batch.items()})
    return float(m["loss"]), float(m["grad_norm"]), {
        "init": init,
        "params": {k: p.detach().numpy() for k, p in named.items()},
        "mu": {k: v.numpy() for k, v in state.mu.items()},
        "nu": {k: v.numpy() for k, v in state.nu.items()}}


def _adamw_first_step(p0, mu, nu, cfg=AdamWConfig()):
    """The parameter after AdamW's first step from ``p0`` with the
    moments ``mu``, ``nu`` (f32, ``optim.adamw``'s order of operations)."""
    f32 = np.float32
    b1c = f32(1) - f32(cfg.b1)
    b2c = f32(1) - f32(cfg.b2)
    delta = (mu / b1c) / (np.sqrt(nu / b2c) + f32(cfg.eps))
    delta = delta + f32(cfg.weight_decay) * p0
    return p0 - f32(cfg.lr) * delta


@pytest.fixture(scope="module")
def pool():
    with RankPool(4, backend="gloo", device="cpu", timeout=300) as p:
        yield p


@pytest.fixture(scope="module")
def results(pool, tmp_path_factory):
    """Every case's mesh run and its reference side, once.  Each case's
    run is sent to the ranks as soon as its weights (the reference's
    ``Model.init``) and batch are drawn, and while the ranks work, the
    reference's jitted step and the one-process port's step run here.
    Each run is one step, everything gathered after it; the first case
    also saves its state and restores it onto one process on the ranks,
    and a last call restores that checkpoint onto the (1, 4) mesh.  →
    ({key: the weights, batch, the reference's loss and grad norm (None
    with overrides), the one-process port's step}, {case id: the ranks'
    results}, the checkpoint's directory, the (1, 4) restore's first
    rank)."""
    ref, runs = {}, {}
    ck = tmp_path_factory.mktemp("ck")
    ticket = None
    for i, case in enumerate(CASES):
        cid, arch, over, mesh, flags = case
        key = _key(arch, over)
        if key not in ref:
            cfg = dataclasses.replace(jax_resolve_config(arch), **(over or {}))
            if cfg.family == "encdec":
                # as tests/test_torch_families.py: the encoder's scan
                # refuses a carry whose dtype changes (bf16 frames into
                # f32 layers)
                cfg = dataclasses.replace(cfg, scan_layers=False)
            model = JaxModel(cfg)
            params = jax.tree.map(lambda a: a.astype(jnp.float32),
                                  model.init(jax.random.key(i)))
            ref[key] = {"model": model, "params": params,
                        "family": cfg.family,
                        "tree": jax.tree.map(np.asarray, params),
                        "batch": _batch(cfg, np.random.default_rng(i))}
        if ticket is not None:       # one call at a time on the ranks
            runs[CASES[i - 1][0]] = pool.wait(ticket)
        r, first = ref[key], case == CASES[0]
        ticket = pool.send(
            train_rank, arch, mesh, AXES, [r["batch"]], flags, 0, r["tree"],
            None, over, ("params", "mu", "nu"), str(ck) if first else None,
            None, first)
        if "port" not in r:
            r["metrics"] = None
            if not over:
                step = jax.jit(jax_make_train_step(r["model"],
                                                   JaxAdamWConfig()))
                _, _, m = step(r["params"], jax_adamw_init(r["params"]),
                               {k: jnp.asarray(v)
                                for k, v in r["batch"].items()})
                r["metrics"] = (float(m["loss"]), float(m["grad_norm"]))
            r["port"] = _one_process(_port_cfg(arch, over), r["tree"],
                                     r["batch"])
    runs[CASES[-1][0]] = pool.wait(ticket)
    onto_1x4 = pool.call(train_rank, MIXTRAL, (1, 4), AXES, [], None, 0, None,
                         "float32", None, ("params", "mu", "nu"), None,
                         str(ck))[0]
    return ref, runs, ck, onto_1x4


def _rel(got, exp):
    return abs(got - exp) / abs(exp)


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_family_train_step_on_a_mesh_matches_reference_and_one_process(
        results, case):
    cid, arch, over, _, _ = case
    ref, runs, _, _ = results
    r, out = ref[_key(arch, over)], runs[cid]
    r0 = out[0]
    assert [s["step"] for s in r0["steps"]] == [1]
    got = r0["steps"][0]
    for rank in out:             # every rank holds the same metrics
        assert (rank["steps"][0]["loss"], rank["steps"][0]["grad_norm"]) == \
            (got["loss"], got["grad_norm"])
    if r["metrics"] is not None:
        tol = REF_TOL.get(r["family"], TOL)
        loss, gnorm = r["metrics"]
        assert _rel(got["loss"], loss) <= tol, (got["loss"], loss)
        assert _rel(got["grad_norm"], gnorm) <= tol, (got["grad_norm"], gnorm)
    loss, gnorm, exp = r["port"]
    assert _rel(got["loss"], loss) <= TOL, (got["loss"], loss)
    assert _rel(got["grad_norm"], gnorm) <= TOL, (got["grad_norm"], gnorm)
    for name in ("mu", "nu"):
        for k, e in exp[name].items():
            err = float(np.abs(r0[name][k] - e).max())
            assert err <= TOL * float(np.abs(e).max()), (name, k, err)
    b1 = AdamWConfig().b1
    for k, e in exp["params"].items():
        # where the one-process gradient is at least 10 ε: within 1e-5
        kept = np.abs(exp["mu"][k]) / (1 - b1) >= 10 * AdamWConfig().eps
        err = float(np.abs(r0["params"][k] - e)[kept].max(initial=0.0))
        assert err <= TOL, ("params", k, err)
        # everywhere: the step that the mesh's own moments give
        step = _adamw_first_step(exp["init"][k], r0["mu"][k], r0["nu"][k])
        err = float(np.abs(r0["params"][k] - step).max())
        assert err <= TOL / 10, ("params from the moments", k, err)
    # the moments are split as opt_rules says: the dry run's bytes a device
    cfg, mesh = _port_cfg(arch, over), make_mesh(case[3], AXES)
    policy = PolicyFlags(**case[4]) if case[4] else default_flags(cfg)
    kwargs, shardings, _, _ = input_specs(
        cfg, ShapeConfig("t", S, N_MICRO * MB, "train"), mesh, policy)
    arg = argument_bytes(kwargs, shardings, mesh)
    for rank in out:
        assert rank["opt_state_bytes"] == arg["opt_state"]
        coll = rank["steps"][0]["collectives"]
        assert set(coll["by_phase"]) <= {"forward", "backward", "optimizer"}
        assert coll["by_phase"]["backward"]["count"] > 0
        assert rank["host_staged_messages"] == 0       # CPU tensors


def _like(arch):
    """The train state's structure as the ranks checkpoint it."""
    model = Model(resolve_config(arch), device=CPU)
    named = {k: p.detach() for k, p in model.named_parameters()}
    return {"params": named, "opt": adamw_init(named)}


def test_moe_checkpoint_restores_onto_another_mesh_and_one_process(results):
    _, runs, ck, onto_1x4 = results
    out = runs[CASES[0][0]]
    check = out[0]["restore_equal"]
    n_params = len(_like(MIXTRAL)["params"])
    assert check["equal"] and check["leaves"] == 3 * n_params + 1, check
    assert all(r.get("restore_equal") is None for r in out[1:])
    saved, meta = load_checkpoint(_like(MIXTRAL), ck, 1)
    assert meta == {"step": 1} and int(saved["opt"].step) == 1
    for k, v in saved["params"].items():        # the checkpoint is the state
        assert np.array_equal(out[0]["params"][k], v.numpy()), k
    # onto the (1, 4) mesh (one expert a rank): no step, every leaf back
    assert onto_1x4["steps"] == []
    for k, v in saved["params"].items():
        assert np.array_equal(onto_1x4["params"][k], v.numpy()), k
    for name in ("mu", "nu"):
        for k, v in getattr(saved["opt"], name).items():
            assert np.array_equal(onto_1x4[name][k], v.numpy()), (name, k)
