"""The port's training path against the reference, on the same numpy
inputs: AdamW (three steps from the reference's converted parameters and
state), the cosine schedule, the data cursor and the micro-batch layout,
the failure injector's event sequence, ``make_train_step`` with gradient
accumulation and ``adaptive_accumulate`` on ``smollm-360m-reduced``, and
the training CLI on the CPU (end to end, and resumed after a preemption
with the uninterrupted run's losses), as ``tests/test_system.py`` runs the
reference's.

Tolerance: f32 on both sides, summed in other orders.  AdamW's parameters
and moments within 1e-6 of each leaf's largest magnitude (the same
arithmetic, rounded at the same places but for fused multiply-adds), the
step equal, the grad norm within 1e-6 relative.  The train steps: losses
and grad norms within 1e-5 relative, the parameters after AdamW within
1e-5 of each leaf's largest magnitude.  The reference side is computed
once per module."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.data import DataCursor as JaxDataCursor
from repro.data import TokenStream as JaxTokenStream
from repro.launch.steps import make_train_step as jax_make_train_step
from repro.launch.train import _resolve_config as jax_resolve_config
from repro.models import Model as JaxModel
from repro.optim import AdamWConfig as JaxAdamWConfig
from repro.optim import AdaptiveAccumConfig as JaxAdaptiveAccumConfig
from repro.optim import adamw_init as jax_adamw_init
from repro.optim import adaptive_accumulate as jax_adaptive_accumulate
from repro.optim import cosine_schedule as jax_cosine_schedule
from repro.optim.adamw import adamw_update as jax_adamw_update
from repro.runtime import FailureInjector as JaxFailureInjector
from repro_torch.checkpoint.manager import latest_step
from repro_torch.convert import adamw_state_from_numpy, model_params_from_numpy
from repro_torch.data import DataCursor, TokenStream
from repro_torch.launch.steps import loss_and_grads, make_train_step, step_for
from repro_torch.launch.train import main as train_main
from repro_torch.models import Model, resolve_config
from repro_torch.optim import (AdamWConfig, AdaptiveAccumConfig,
                               adamw_update, adaptive_accumulate,
                               cosine_schedule)
from repro_torch.runtime import FailureEvent, FailureInjector

ARCH = "smollm-360m-reduced"
N_MICRO, MB, S = 2, 2, 32


def _rel(got, exp):
    got = np.asarray(got.detach() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


@pytest.fixture(scope="module")
def ref():
    """The reference's AdamW steps, train steps and adaptive accumulation
    on smollm-360m-reduced in f32, with their inputs (numpy)."""
    cfg = jax_resolve_config(ARCH)
    model = JaxModel(cfg)
    params = jax.tree.map(lambda a: a.astype(jnp.float32),
                          model.init(jax.random.key(0)))
    rng = np.random.default_rng(0)
    # AdamW: three steps of given gradients, the first two clipped (norm >
    # 1), the third not
    opt_cfg = JaxAdamWConfig(lr=1e-3)
    state = jax_adamw_init(params)
    grads = [jax.tree.map(lambda p: (scale * rng.standard_normal(p.shape)
                                     ).astype(np.float32), params)
             for scale in (1.0, 0.05, 1e-4)]
    p, st, adamw = params, state, []
    for g in grads:
        p, st, gnorm = jax_adamw_update(g, st, p, opt_cfg)
        adamw.append({"params": jax.tree.map(np.asarray, p),
                      "mu": jax.tree.map(np.asarray, st.mu),
                      "nu": jax.tree.map(np.asarray, st.nu),
                      "step": int(st.step), "gnorm": float(gnorm)})
    # two jitted train steps with n_micro 2
    toks = rng.integers(0, cfg.vocab, (2, N_MICRO, MB, S + 1)).astype(np.int32)
    batches = [{"tokens": t[..., :-1], "labels": t[..., 1:]} for t in toks]
    step = jax.jit(jax_make_train_step(model, JaxAdamWConfig()))
    p, st, steps = params, jax_adamw_init(params), []
    for b in batches:
        p, st, m = step(p, st, {k: jnp.asarray(v) for k, v in b.items()})
        steps.append({"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                      "step": int(m["step"]), "params": jax.tree.map(np.asarray, p)})
    # adaptive accumulation over up to 4 micro-batches
    micro = rng.integers(0, cfg.vocab, (4, MB, S + 1)).astype(np.int32)
    micro = {"tokens": micro[..., :-1], "labels": micro[..., 1:]}
    acc = {}
    for rtol in (0.5, 0.001):
        g, loss, n, rel = jax_adaptive_accumulate(
            jax.value_and_grad(model.train_loss), params,
            {k: jnp.asarray(v) for k, v in micro.items()},
            JaxAdaptiveAccumConfig(rtol=rtol, min_micro=2, max_micro=4))
        acc[rtol] = {"grads": jax.tree.map(np.asarray, g), "loss": float(loss),
                     "n": int(n), "rel_sem": float(rel)}
    return {"tree": jax.tree.map(np.asarray, params),
            "state0": jax.tree.map(np.asarray, state), "grads": grads,
            "adamw": adamw, "batches": batches, "steps": steps,
            "micro": micro, "acc": acc}


def _model(tree):
    cfg = resolve_config(ARCH)
    model = Model(cfg, device="cpu")
    model.load_state_dict(model_params_from_numpy(cfg, tree, "cpu"), assign=True)
    return model.requires_grad_(True)


def _assert_tree(got: dict, exp_tree, tol):
    exp = model_params_from_numpy(resolve_config(ARCH), exp_tree, "cpu")
    assert set(got) == set(exp)
    for name, e in exp.items():
        assert _rel(got[name], e.numpy()) <= tol, name


def test_adamw_matches_the_reference_for_three_steps(ref):
    cfg = resolve_config(ARCH)
    model = _model(ref["tree"])
    params = dict(model.named_parameters())
    state = adamw_state_from_numpy(cfg, ref["state0"], "cpu")
    assert state.step.dtype == torch.int32 and set(state.mu) == set(params)
    for g, exp in zip(ref["grads"], ref["adamw"]):
        grads = model_params_from_numpy(cfg, g, "cpu")
        _, state, gnorm = adamw_update(grads, state, params, AdamWConfig(lr=1e-3))
        assert int(state.step) == exp["step"]
        assert abs(float(gnorm) - exp["gnorm"]) <= 1e-6 * exp["gnorm"]
        _assert_tree(params, exp["params"], 1e-6)
        _assert_tree(state.mu, exp["mu"], 1e-6)
        _assert_tree(state.nu, exp["nu"], 1e-6)
    assert [e["gnorm"] > 1.0 for e in ref["adamw"]] == [True, True, False]


def test_cosine_schedule_matches_the_reference():
    kw = {"peak": 1e-3, "warmup": 10, "total": 100}
    for s in (0, 3, 10, 11, 50, 99, 100, 150):
        exp = float(jax_cosine_schedule(jnp.int32(s), **kw))
        assert abs(cosine_schedule(s, **kw) - exp) <= 1e-6 * max(exp, 1e-9)
        got = cosine_schedule(torch.tensor(s, dtype=torch.int32), **kw)
        assert got.dtype == torch.float32
        assert abs(float(got) - exp) <= 1e-6 * max(exp, 1e-9)


def test_data_cursor_and_micro_batch_layout():
    cur = DataCursor(step=7, seed=3)
    assert cur.as_meta() == JaxDataCursor(step=7, seed=3).as_meta()
    assert DataCursor.from_meta(cur.as_meta()) == cur
    assert DataCursor.from_meta({}) == DataCursor()
    stream = TokenStream(vocab=256, seq_len=16, batch=6, seed=1)
    exp = JaxTokenStream(vocab=256, seq_len=16, batch=6, seed=1).micro_batches(
        jnp.int32(2), 3)
    got = stream.micro_batches(2, 3, device="cpu")
    full = stream.batch_at(2, device="cpu")
    for k in ("tokens", "labels"):
        assert tuple(got[k].shape) == exp[k].shape == (3, 2, 16)
        assert got[k].dtype == torch.int32
        assert torch.equal(got[k].reshape(6, 16), full[k])
    # the remainder is dropped, as the reference drops it
    assert tuple(stream.micro_batches(2, 4, device="cpu")["tokens"].shape) == \
        JaxTokenStream(vocab=256, seq_len=16, batch=6).micro_batches(
            jnp.int32(2), 4)["tokens"].shape == (4, 1, 16)


def test_failure_injector_gives_the_reference_event_sequence():
    kw = {"seed": 5, "crash_prob": 0.2, "straggler_prob": 0.3,
          "preempt_at_step": 7}
    got, exp = FailureInjector(**kw), JaxFailureInjector(**kw)
    seq = [got.poll(s) for s in range(60)]
    assert [e.value for e in seq] == [exp.poll(s).value for s in range(60)]
    assert seq[7] == FailureEvent.PREEMPTION
    assert {e for e in seq} == set(FailureEvent)


def test_make_train_step_matches_the_reference(ref):
    model = _model(ref["tree"])
    from repro_torch.optim import adamw_init
    step = make_train_step(model)
    state = adamw_init(dict(model.named_parameters()))
    for b, exp in zip(ref["batches"], ref["steps"]):
        state, m = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(m["loss"]) - exp["loss"]) <= 1e-5 * exp["loss"]
        assert abs(float(m["grad_norm"]) - exp["grad_norm"]) <= 1e-5 * exp["grad_norm"]
        assert int(m["step"]) == exp["step"]
        _assert_tree(dict(model.named_parameters()), exp["params"], 1e-5)


def test_train_step_on_a_single_batch_and_step_for(ref):
    """A (B, S) batch takes no accumulation: the same loss as one micro-batch
    of the same rows; ``step_for`` picks the step by kind."""
    model = _model(ref["tree"])
    from repro_torch.optim import adamw_init
    b = {k: torch.from_numpy(v[0]) for k, v in ref["batches"][0].items()}
    state = adamw_init(dict(model.named_parameters()))
    loss, _ = loss_and_grads(model, dict(model.named_parameters()), b)
    state, m = step_for(model, "train")(state, b)
    assert float(m["loss"]) == float(loss) and int(m["step"]) == 1
    assert step_for(model, "prefill")(b).shape == (MB, model.cfg.padded_vocab)


@pytest.mark.parametrize("rtol", [0.5, 0.001])
def test_adaptive_accumulate_matches_the_reference(ref, rtol):
    from repro_torch import device as dev_mod
    model = _model(ref["tree"])
    params = dict(model.named_parameters())
    syncs = dev_mod.host_syncs
    grads, loss, n, rel = adaptive_accumulate(
        lambda p, b: loss_and_grads(model, p, b), params,
        {k: torch.from_numpy(v) for k, v in ref["micro"].items()},
        AdaptiveAccumConfig(rtol=rtol, min_micro=2, max_micro=4))
    exp = ref["acc"][rtol]
    assert n == exp["n"] and dev_mod.host_syncs - syncs == n
    assert n == (2 if rtol == 0.5 else 4)
    assert abs(float(loss) - exp["loss"]) <= 1e-5 * exp["loss"]
    assert abs(float(rel) - exp["rel_sem"]) <= 1e-4 * exp["rel_sem"]
    _assert_tree(grads, exp["grads"], 1e-4)


def _losses(out: str) -> dict:
    return {int(line.split()[2]): line.split()[3]
            for line in out.splitlines() if line.startswith("[train] step ")
            and "loss=" in line}


def test_train_cli_end_to_end(tmp_path, capsys):
    assert train_main(["--arch", ARCH, "--device", "cpu", "--steps", "8",
                       "--batch", "4", "--seq", "32", "--micro", "2",
                       "--ckpt-dir", str(tmp_path), "--ckpt-every", "4",
                       "--log-every", "4"]) == 0
    out = capsys.readouterr().out
    assert "done" in out and latest_step(tmp_path) == 8
    assert train_main(["--arch", ARCH, "--device", "cpu", "--steps", "3",
                       "--batch", "4", "--seq", "32", "--micro", "4",
                       "--adaptive", "--log-every", "1"]) == 0
    out = capsys.readouterr().out
    assert "micro=" in out and "rel_sem=" in out and "done" in out


def test_train_cli_resumes_after_preemption_with_the_same_losses(tmp_path, capsys):
    args = ["--arch", ARCH, "--device", "cpu", "--steps", "10", "--batch", "4",
            "--seq", "32", "--micro", "1", "--log-every", "1"]
    assert train_main(args + ["--ckpt-dir", str(tmp_path / "a")]) == 0
    full = _losses(capsys.readouterr().out)
    assert train_main(args + ["--ckpt-dir", str(tmp_path / "b"),
                              "--ckpt-every", "3", "--preempt-at", "5"]) == 0
    out = capsys.readouterr().out
    assert "PREEMPTION" in out and latest_step(tmp_path / "b") == 5
    assert train_main(args + ["--ckpt-dir", str(tmp_path / "b"), "--resume"]) == 0
    out = capsys.readouterr().out
    assert "resumed at step 5" in out and "done" in out
    resumed = _losses(out)
    assert sorted(resumed) == list(range(5, 10))
    assert resumed == {s: full[s] for s in range(5, 10)}
    # the final checkpoints (parameters, moments, step) hold the same bytes
    import json

    def crcs(run):
        man = json.loads((tmp_path / run / "step_0000000010" / "manifest.json"
                          ).read_text())
        return {k: [c["crc32"] for c in v["chunks"]]
                for k, v in man["leaves"].items()}
    assert crcs("a") == crcs("b")


def test_train_cli_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train_main(["--arch", ARCH, "--steps", "1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TokenStream(vocab=256, seq_len=8, batch=2).micro_batches(0, 2)
