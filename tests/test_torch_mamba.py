"""The port's falcon-mamba serving path against the reference model, at
``falcon-mamba-7b-reduced`` (2 layers, d 64, d_inner 128, N 4, vocab 256)
on the same weights (carried across by ``convert.model_params_from_numpy``)
and the same numpy inputs: the Mamba block with and without a state,
prefill logits, ``train_loss``, 48 decode steps and greedy generation.

Tolerances.  In f32 (parameters cast to f32 on both sides) the two packages
compute the same function in other orders (the reference's prefill scans
associatively, the port's kernel sequentially): 1e-4; measured ≤ 2·10⁻⁶.
In bf16 they round at other places (XLA fuses elementwise chains in f32;
PyTorch rounds after every operation).  Measured here: the block's output
one bf16 ulp (0.016 at |y| ≤ 3.9), the state 8·10⁻⁴, prefill logits 0.039,
decode logits 0.035, the loss 6.3·10⁻⁴; held to 0.05 for the block, 0.1 for
logits and 2e-3 for the loss.  The reference side is computed once per
module."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch.serve import generate as jax_generate
from repro.launch.train import _resolve_config as jax_resolve_config
from repro.models import Model as JaxModel
from repro.models.ssm import MambaState as JaxMambaState
from repro.models.ssm import linear_scan as jax_linear_scan
from repro.models.ssm import mamba_block as jax_mamba_block
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch.serve import generate
from repro_torch.models import Model, resolve_config
from repro_torch.models.ssm import (MambaState, linear_scan, mamba_block,
                                    mamba_init_state)

CPU = torch.device("cpu")
ARCH = "falcon-mamba-7b-reduced"
B, S, DECODE, PROMPT, GEN = 2, 64, 48, 32, 16
BLOCK_TOL = {"f32": 1e-4, "bf16": 0.05}
TOL = {"f32": 1e-4, "bf16": 0.1}
LOSS_TOL = {"f32": 1e-4, "bf16": 2e-3}


@pytest.fixture(scope="module")
def ref():
    """The reference's outputs on the reduced config, in f32 and in bf16,
    with the inputs that produced them (numpy)."""
    cfg = jax_resolve_config(ARCH)
    model = JaxModel(cfg)
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((B, cfg.dinner, cfg.ssm_state)).astype(np.float32)
    tail = rng.standard_normal((B, cfg.ssm_conv - 1, cfg.dinner)).astype(np.float32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    decode = jax.jit(model.decode_step)
    out = {"toks": toks, "x": x, "h0": h0, "tail": tail}
    for mode in ("f32", "bf16"):
        p = jax.tree.map(lambda a: a.astype(jnp.float32), params) \
            if mode == "f32" else params
        dt = p["embed"].dtype
        lp = jax.tree.map(lambda a: a[1], p["layers"])
        xj = jnp.asarray(x).astype(dt)
        state = JaxMambaState(h=jnp.asarray(h0),
                              conv_tail=jnp.asarray(tail).astype(dt))
        y_state, st = jax_mamba_block(lp, xj, cfg, state=state, return_state=True)
        y_fresh, st_fresh = jax_mamba_block(lp, xj, cfg, return_state=True)
        cache, logits = model.init_cache(B, S), []
        for t in range(DECODE):
            cache, lg = decode(p, cache, {"tokens": jnp.asarray(toks[:, t]),
                                          "pos": jnp.full((B,), t, jnp.int32)})
            logits.append(np.asarray(lg, np.float32))
        out[mode] = {
            "tree": jax.tree.map(np.asarray, p),
            "block": np.asarray(jax_mamba_block(lp, xj, cfg), np.float32),
            "block_state": (np.asarray(y_state, np.float32), np.asarray(st.h),
                            np.asarray(st.conv_tail, np.float32)),
            "block_fresh_state": (np.asarray(y_fresh, np.float32),
                                  np.asarray(st_fresh.h),
                                  np.asarray(st_fresh.conv_tail, np.float32)),
            "prefill": np.asarray(jax.jit(model.prefill)(p, batch)[1], np.float32),
            "loss": float(jax.jit(model.train_loss)(p, batch)),
            "decode": np.stack(logits),
            "generate": np.asarray(jax_generate(
                model, p, jnp.asarray(toks[:, :PROMPT]), GEN)),
        }
    return out


def _port(ref, mode):
    cfg = resolve_config(ARCH)
    model = Model(cfg, device=CPU)
    model.load_state_dict(model_params_from_numpy(cfg, ref[mode]["tree"], CPU),
                          assign=True)
    return model


def _close(got, exp, tol):
    np.testing.assert_allclose(np.asarray(got, np.float32), exp, rtol=tol, atol=tol)


def test_config_is_the_references():
    for name in (ARCH, "falcon-mamba-7b"):
        assert dataclasses.asdict(resolve_config(name)) == \
            dataclasses.asdict(jax_resolve_config(name))
    cfg = resolve_config("falcon-mamba-7b")
    assert cfg.param_count() == jax_resolve_config("falcon-mamba-7b").param_count()
    # the closed form leaves out each layer's conv_b and the final norm
    held = sum(p.numel() for p in Model(cfg, device="meta").parameters())
    assert held == 7_272_665_088
    assert held - cfg.param_count() == cfg.n_layers * cfg.dinner + cfg.d_model


def test_parameters_carry_the_reference_names_shapes_and_dtypes(ref):
    cfg = resolve_config(ARCH)
    model = Model(cfg, device=CPU)
    state = model_params_from_numpy(cfg, jax.tree.map(
        np.asarray, JaxModel(jax_resolve_config(ARCH)).init(jax.random.key(0))), CPU)
    params = dict(model.named_parameters())
    assert sorted(state) == sorted(params)
    assert "layers.1.A_log" in params and "layers.2.in_proj" not in params
    for name, p in params.items():
        assert state[name].shape == p.shape, name
        assert state[name].dtype == p.dtype, name
        f32 = name.rsplit(".", 1)[-1] in ("dt_bias", "A_log", "D")
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    # bf16 carried across bit for bit, layer by layer
    tree = ref["bf16"]["tree"]
    got = model_params_from_numpy(cfg, tree, CPU)["layers.1.x_proj"]
    exp = np.asarray(tree["layers"]["x_proj"][1], np.float32)
    np.testing.assert_array_equal(got.float().numpy(), exp)


def test_init_draws_the_reference_init_kinds():
    cfg = resolve_config(ARCH)
    model = Model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    p = model.layers[0]
    assert torch.all(p["A_log"] == 1.0) and torch.all(p["D"] == 1.0)
    assert torch.all(p["dt_bias"] == 0.0) and torch.all(p["conv_b"] == 0.0)
    z = p["in_proj"].float() * 8.0                        # scaled, fan-in 64
    assert float(z.abs().max()) <= 2.0 + 1e-2
    again = Model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    assert torch.equal(again.layers[1]["out_proj"], model.layers[1]["out_proj"])


@pytest.mark.parametrize("b,s,d,n", [(2, 9, 6, 3), (1, 5, 4, 2)])
def test_linear_scan_4d_folds_h0_as_the_reference(b, s, d, n):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.1, 0.99, (b, s, d, n)).astype(np.float32)
    bb = rng.standard_normal((b, s, d, n)).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32)
    exp = np.asarray(jax_linear_scan(jnp.asarray(a), jnp.asarray(bb),
                                     h0=jnp.asarray(h0), axis=1))
    got = linear_scan(*(torch.from_numpy(v) for v in (a, bb, h0)))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_mamba_block(ref, mode):
    """Without a state, with ``return_state`` from a fresh start, and from a
    given state (h0 and a conv tail)."""
    model = _port(ref, mode)
    p, cfg = model.layers[1], model.cfg
    x = torch.from_numpy(ref["x"]).to(model.dtype)
    tol = BLOCK_TOL[mode]
    with torch.inference_mode():
        _close(mamba_block(p, x, cfg).float(), ref[mode]["block"], tol)
        y, st = mamba_block(p, x, cfg, return_state=True)
        for got, exp in zip((y, st.h, st.conv_tail), ref[mode]["block_fresh_state"]):
            _close(got.float(), exp, tol)
        fresh = mamba_init_state(cfg, B, dtype=model.dtype, device=CPU)
        assert torch.equal(mamba_block(p, x, cfg, state=fresh), mamba_block(p, x, cfg))
        state = MambaState(h=torch.from_numpy(ref["h0"]),
                           conv_tail=torch.from_numpy(ref["tail"]).to(model.dtype))
        y, st = mamba_block(p, x, cfg, state=state, return_state=True)
    for got, exp in zip((y, st.h, st.conv_tail), ref[mode]["block_state"]):
        _close(got.float(), exp, tol)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_prefill_logits(ref, mode):
    model = _port(ref, mode)
    with torch.inference_mode():
        got = model.prefill({"tokens": torch.from_numpy(ref["toks"][:, :-1])})
    assert got.shape == (B, model.cfg.padded_vocab)
    _close(got.float(), ref[mode]["prefill"], TOL[mode])


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_train_loss(ref, mode):
    model = _port(ref, mode)
    toks = torch.from_numpy(ref["toks"])
    with torch.inference_mode():
        loss = float(model.train_loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]}))
    assert abs(loss - ref[mode]["loss"]) <= LOSS_TOL[mode]


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_decode_steps(ref, mode):
    """48 steps; the cache holds each layer's scan state and conv tail and
    is written in place."""
    model = _port(ref, mode)
    cfg = model.cfg
    cache = model.init_cache(B, S)
    assert cache["h"].shape == (cfg.n_layers, B, cfg.dinner, cfg.ssm_state)
    assert cache["h"].dtype == torch.float32
    assert cache["conv"].shape == (cfg.n_layers, B, cfg.ssm_conv - 1, cfg.dinner)
    assert cache["conv"].dtype == model.dtype
    toks = torch.from_numpy(ref["toks"])
    with torch.inference_mode():
        for t in range(DECODE):
            cache, logits = model.decode_step(
                cache, {"tokens": toks[:, t], "pos": torch.full((B,), t, dtype=torch.int32)})
            _close(logits.float(), ref[mode]["decode"][t], TOL[mode])
    assert bool(cache["h"].abs().sum() > 0)


def test_generate_gives_the_reference_tokens(ref):
    """f32: greedy tokens equal.  (In bf16 the two sides' logits differ by
    rounding, so a near-tie may flip; the logits are compared above.)"""
    model = _port(ref, "f32")
    with torch.inference_mode():
        got = generate(model, torch.from_numpy(ref["toks"][:, :PROMPT]), GEN)
    np.testing.assert_array_equal(got.numpy(), ref["f32"]["generate"])


@pytest.mark.parametrize("mode,tol", [("f32", 1e-5), ("bf16", 0.05)])
def test_prefill_agrees_with_token_by_token_decode(ref, mode, tol):
    """The same function two ways: the full-sequence path (the ssm_scan)
    and 32 decode steps.  Error relative to max |logit|: 1.8·10⁻⁷ measured
    in f32, 8.6·10⁻³ in bf16 (the paths round at other places)."""
    model = _port(ref, mode)
    toks = torch.from_numpy(ref["toks"][:, :PROMPT])
    cache = model.init_cache(B, PROMPT)
    with torch.inference_mode():
        for t in range(PROMPT):
            cache, logits = model.decode_step(
                cache, {"tokens": toks[:, t], "pos": torch.full((B,), t, dtype=torch.int32)})
        full = model.prefill({"tokens": toks}).float()
    rel = float((full - logits.float()).abs().max() / full.abs().max())
    assert rel <= tol
