"""The port's recurrentgemma serving path against the reference model, at
``recurrentgemma-2b-reduced`` (5 layers, d 64, local window 32) on the same
weights (carried across by ``convert.model_params_from_numpy``) and the
same numpy tokens: the RG-LRU block, prefill logits at S = 64 > window
(through the reference's ``attn_full`` and, with ``attn_chunk=16``, its
``attn_chunked``), ``train_loss``, 48 decode steps across the ring buffer's
wrap, and greedy generation.

Tolerances.  In f32 (parameters cast to f32 on both sides) the two packages
compute the same function in other summation orders: 1e-4.  In bf16 they
round at other places (XLA fuses elementwise chains in f32; PyTorch rounds
after every operation), and at this size each bf16 side lies up to 0.11
from the f32 logits of the same weights: logits within 0.25, the loss
within 2e-3.  The reference side is computed once per module."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.launch.serve import generate as jax_generate
from repro.launch.train import _resolve_config as jax_resolve_config
from repro.models import Model as JaxModel
from repro.models.rglru import RGLRUState as JaxRGLRUState
from repro.models.rglru import rglru_block as jax_rglru_block
from repro_torch.convert import model_params_from_numpy
from repro_torch.data import TokenStream
from repro_torch.launch.serve import adaptive_eval, generate
from repro_torch.models import Model, resolve_config
from repro_torch.models.rglru import RGLRUState, rglru_block

CPU = torch.device("cpu")
ARCH = "recurrentgemma-2b-reduced"
B, S, DECODE, PROMPT, GEN = 2, 64, 48, 32, 16
TOL = {"f32": 1e-4, "bf16": 0.25}
LOSS_TOL = {"f32": 1e-4, "bf16": 2e-3}


@pytest.fixture(scope="module")
def ref():
    """The reference's outputs on the reduced config, in f32 and in bf16,
    with the inputs that produced them (numpy)."""
    cfg = jax_resolve_config(ARCH)
    model = JaxModel(cfg)
    chunked = JaxModel(dataclasses.replace(cfg, attn_chunk=16))
    params = model.init(jax.random.key(1))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    x = rng.standard_normal((B, S, cfg.d_model)).astype(np.float32)
    h0 = rng.standard_normal((B, cfg.lru_width)).astype(np.float32)
    tail = rng.standard_normal((B, 3, cfg.lru_width)).astype(np.float32)
    batch = {"tokens": jnp.asarray(toks[:, :-1]), "labels": jnp.asarray(toks[:, 1:])}
    decode = jax.jit(model.decode_step)
    out = {"toks": toks, "x": x, "h0": h0, "tail": tail}
    for mode in ("f32", "bf16"):
        p = jax.tree.map(lambda a: a.astype(jnp.float32), params) \
            if mode == "f32" else params
        dt = p["embed"].dtype
        lp = jax.tree.map(lambda a: a[0], p["units"]["r0"])
        xj = jnp.asarray(x).astype(dt)
        state = JaxRGLRUState(h=jnp.asarray(h0),
                              conv_tail=jnp.asarray(tail).astype(dt))
        y_state, st = jax_rglru_block(lp, xj, cfg, state=state, return_state=True)
        cache, logits = model.init_cache(B, S), []
        for t in range(DECODE):
            cache, lg = decode(p, cache, {"tokens": jnp.asarray(toks[:, t]),
                                          "pos": jnp.full((B,), t, jnp.int32)})
            logits.append(np.asarray(lg, np.float32))
        out[mode] = {
            "tree": jax.tree.map(np.asarray, p),
            "rglru": np.asarray(jax_rglru_block(lp, xj, cfg), np.float32),
            "rglru_state": (np.asarray(y_state, np.float32), np.asarray(st.h),
                            np.asarray(st.conv_tail, np.float32)),
            "prefill": np.asarray(jax.jit(model.prefill)(p, batch)[1], np.float32),
            "prefill_chunked": np.asarray(jax.jit(chunked.prefill)(p, batch)[1],
                                          np.float32),
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
    for name in (ARCH, "recurrentgemma-2b"):
        assert dataclasses.asdict(resolve_config(name)) == \
            dataclasses.asdict(jax_resolve_config(name))
    assert resolve_config("recurrentgemma-2b").param_count() == \
        jax_resolve_config("recurrentgemma-2b").param_count()


def test_parameters_carry_the_reference_names_shapes_and_dtypes(ref):
    cfg = resolve_config(ARCH)
    model = Model(cfg, device=CPU)
    state = model_params_from_numpy(cfg, jax.tree.map(
        np.asarray, JaxModel(jax_resolve_config(ARCH)).init(jax.random.key(0))), CPU)
    params = dict(model.named_parameters())
    assert sorted(state) == sorted(params)
    for name, p in params.items():
        assert state[name].shape == p.shape, name
        assert state[name].dtype == p.dtype, name
        f32 = name.rsplit(".", 1)[-1] in ("b_r", "b_i", "lam")
        assert p.dtype == (torch.float32 if f32 else torch.bfloat16), name
    # bf16 carried across bit for bit
    tree = ref["bf16"]["tree"]
    got = model_params_from_numpy(cfg, tree, CPU)["units.0.r0.w_in"]
    exp = np.asarray(tree["units"]["r0"]["w_in"][0], np.float32)
    np.testing.assert_array_equal(got.float().numpy(), exp)


def test_init_draws_the_reference_init_kinds():
    cfg = dataclasses.replace(resolve_config(ARCH), d_model=256, lru_width=256)
    gen = torch.Generator().manual_seed(0)
    model = Model(cfg, device=CPU).init(gen)
    w_in = model.units[0]["r0"]["w_in"].float()         # scaled, fan-in 256
    z = w_in * 16.0
    assert float(z.abs().max()) <= 2.0 + 1e-2
    assert abs(float(z.std()) - 0.88) < 0.03              # std of N(0,1) cut at ±2
    emb = model.embed.float()                             # normal · 0.02
    assert abs(float(emb.std()) - 0.02) < 1e-3
    assert torch.all(model.units[0]["r0"]["lam"] == 1.0)
    assert torch.all(model.units[0]["r0"]["b_r"] == 0.0)
    again = Model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    assert torch.equal(again.unembed, model.unembed)


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_rglru_block(ref, mode):
    model = _port(ref, mode)
    p, cfg = model.units[0]["r0"], model.cfg
    x = torch.from_numpy(ref["x"]).to(model.dtype)
    with torch.inference_mode():
        _close(rglru_block(p, x, cfg).float(), ref[mode]["rglru"], TOL[mode])
        state = RGLRUState(h=torch.from_numpy(ref["h0"]),
                           conv_tail=torch.from_numpy(ref["tail"]).to(model.dtype))
        y, st = rglru_block(p, x, cfg, state=state, return_state=True)
    y_exp, h_exp, tail_exp = ref[mode]["rglru_state"]
    _close(y.float(), y_exp, TOL[mode])
    _close(st.h, h_exp, TOL[mode])
    _close(st.conv_tail.float(), tail_exp, TOL[mode])


@pytest.mark.parametrize("mode", ["f32", "bf16"])
@pytest.mark.parametrize("path", ["prefill", "prefill_chunked"])
def test_prefill_logits(ref, mode, path):
    """S = 64 is twice the window, so the window mask acts.
    ``prefill_chunked`` is the reference's flash-style ``attn_chunked``
    (chunk 16), the other its ``attn_full``."""
    model = _port(ref, mode)
    with torch.inference_mode():
        got = model.prefill({"tokens": torch.from_numpy(ref["toks"][:, :-1])})
    assert got.shape == (B, model.cfg.padded_vocab)
    _close(got.float(), ref[mode][path], TOL[mode])


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_train_loss(ref, mode):
    model = _port(ref, mode)
    toks = torch.from_numpy(ref["toks"])
    with torch.inference_mode():
        loss = float(model.train_loss({"tokens": toks[:, :-1], "labels": toks[:, 1:]}))
    assert abs(loss - ref[mode]["loss"]) <= LOSS_TOL[mode]


@pytest.mark.parametrize("mode", ["f32", "bf16"])
def test_decode_steps_across_the_ring_buffer_wrap(ref, mode):
    """48 steps with a 32-slot ring buffer: slots are reused from step 32."""
    model = _port(ref, mode)
    cache = model.init_cache(B, S)
    assert cache["k"].shape[2] == model.cfg.local_window < DECODE
    toks = torch.from_numpy(ref["toks"])
    with torch.inference_mode():
        for t in range(DECODE):
            cache, logits = model.decode_step(
                cache, {"tokens": toks[:, t], "pos": torch.full((B,), t, dtype=torch.int32)})
            _close(logits.float(), ref[mode]["decode"][t], TOL[mode])
    assert sorted(cache["kpos"][0].tolist()) == list(range(DECODE - 32, DECODE))


def test_generate_gives_the_reference_tokens(ref):
    """f32: greedy tokens equal.  (In bf16 the two sides' logits differ by
    rounding, so a near-tie may flip; the logits are compared above.)"""
    model = _port(ref, "f32")
    with torch.inference_mode():
        got = generate(model, torch.from_numpy(ref["toks"][:, :PROMPT]), GEN)
    np.testing.assert_array_equal(got.numpy(), ref["f32"]["generate"])


@pytest.mark.parametrize("mode,tol", [("f32", 1e-5), ("bf16", 0.05)])
def test_prefill_agrees_with_token_by_token_decode(ref, mode, tol):
    """The same function two ways: the full-sequence path (scan and flash
    attention) and 32 decode steps.  Error relative to max |logit|: 5e-7
    measured in f32, 1.9e-2 in bf16 (the paths round at other places)."""
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


def test_token_stream_is_a_pure_function_of_seed_step_and_row():
    s = TokenStream(vocab=1000, seq_len=256, batch=8, seed=3)
    a = s.batch_at(5, device=CPU)
    assert a["tokens"].shape == (8, 256) and a["tokens"].dtype == torch.int32
    assert torch.equal(a["tokens"][:, 1:], a["labels"][:, :-1])
    assert torch.equal(s.batch_at(5, device=CPU)["tokens"], a["tokens"])
    assert not torch.equal(s.batch_at(6, device=CPU)["tokens"], a["tokens"])
    halves = [s.batch_at(5, shard=i, n_shards=2, device=CPU)["tokens"] for i in (0, 1)]
    assert torch.equal(torch.cat(halves), a["tokens"])
    t = a["tokens"]
    assert int(t.min()) >= 0 and int(t.max()) < 1000


def test_token_stream_has_the_reference_distribution():
    """log-uniform ranks on [1, V−1] with EOS at rate 1/mean_doc_len: the
    mean log-rank and the EOS share match the reference's draws."""
    from repro.data import TokenStream as JaxTokenStream
    kw = dict(vocab=5000, seq_len=512, batch=16, seed=0, mean_doc_len=64)
    ours = TokenStream(**kw).batch_at(0, device=CPU)["tokens"].numpy()
    theirs = np.asarray(JaxTokenStream(**kw).batch_at(jnp.int32(0))["tokens"])
    for toks in (ours, theirs):
        eos = (toks == 0).mean()
        assert abs(eos - 1 / 64) < 0.006
        mean_log = np.log(toks[toks > 0]).mean()
        assert abs(mean_log - np.log(4999) / 2) < 0.1
    assert abs((ours == 0).mean() - (theirs == 0).mean()) < 0.008


def test_adaptive_eval_stops_on_the_empirical_bernstein_rule():
    """ε = 0.5, δ = 0.1, range 15: the bound's range term alone needs
    3·15·ln 30 / τ ≤ 0.5, τ ≥ 307, and the per-batch loss barely varies,
    so the rule stops at the first even τ above that."""
    cfg = resolve_config(ARCH)
    model = Model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
    stream = TokenStream(vocab=cfg.vocab, seq_len=16, batch=2, seed=0)
    with torch.inference_mode():
        mean, res = adaptive_eval(model, stream, eps=0.5, delta=0.1)
        direct = np.mean([float(model.train_loss(stream.batch_at(s, device=CPU)))
                          for s in range(8)])
    assert res.stopped and 308 <= res.num <= 330 and res.num % 2 == 0
    assert abs(mean - direct) < 0.5


def test_unported_paths_raise_naming_their_roadmap_item():
    cfg = resolve_config(ARCH)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        Model(dataclasses.replace(cfg, family="moe"), device=CPU)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        Model(dataclasses.replace(cfg, family="dense"), device=CPU)
    with pytest.raises(NotImplementedError, match="queue 1 item 10"):
        Model(dataclasses.replace(cfg, family="encdec"), device=CPU)
    # the pool's sessions run on the sequential and vmap substrates; the
    # shard_map one waits for the pool's process-group sessions
    from repro_torch.serve import AdaptiveSession, SessionSpec
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        AdaptiveSession.create(SessionSpec("wrs", "local", world=1,
                                           substrate="shard_map"),
                               device=CPU)
