"""The port's dense, moe, vlm and encdec families against the reference
model, at their ``-reduced`` configs, on the same weights (carried across by
``convert.model_params_from_numpy``) and the same numpy inputs:

- prefill logits, ``train_loss`` and 48 decode steps (the windowed configs'
  32 ring slots wrap) for smollm-360m (hd 20), h2o-danube-3-4b (window 32,
  S = 64 so that it binds), internlm2-20b, mistral-large-123b,
  mixtral-8x22b (window 32), qwen3-moe-235b-a22b, internvl2-76b (8 patches)
  and seamless-m4t-large-v2 (16 frames);
- the moe routing: ``route_topk``'s dispatch and combine bit for bit (the
  capacity-dropped tokens and the top-k ties too), ``moe_capacity``, and
  ``moe_ffn_sorted`` against ``moe_ffn`` (as ``tests/test_moe.py``);
- the reference's Pallas ``flash_attention`` in interpret mode against the
  port's plain version (blocked by query rows) at hd 16, 20 and 120;
- the batch layouts of ``data.family_batch`` against the reference's
  ``launch/specs.py``.

Tolerance.  In f32 (parameters cast to f32 on both sides) the packages
compute the same function in other summation orders: logits within 1e-5 of
their largest magnitude, the loss within 1e-5 relative.  One exception:
encdec's prefill and loss take the frames in bf16 (both packages cast them,
as the reference does), and in the first encoder layer XLA keeps some of the
bf16 intermediates in f32 (its excess precision; which ones depends on the
fusion, so the jitted prefill and loss differ) where PyTorch rounds each:
logits within 2e-3 (5.7e-4 measured), the loss within 1e-4 relative
(1.2e-5 measured).  The encoder and decoder themselves are held at 1e-5 on
f32 frames.  The reference side is computed once per module."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.launch.specs import batch_struct
from repro.launch.train import _resolve_config as jax_resolve_config
from repro.models import Model as JaxModel
from repro.models import ShapeConfig as JaxShapeConfig
from repro.models import moe as jax_moe
from repro_torch.convert import model_params_from_numpy
from repro_torch.data import family_batch
from repro_torch.kernels import ref
from repro_torch.launch.serve import generate
from repro_torch.models import Model, resolve_config
from repro_torch.models import moe

CPU = torch.device("cpu")
ARCHS = ("smollm-360m-reduced", "h2o-danube-3-4b-reduced",
         "internlm2-20b-reduced", "mistral-large-123b-reduced",
         "mixtral-8x22b-reduced", "qwen3-moe-235b-a22b-reduced",
         "internvl2-76b-reduced", "seamless-m4t-large-v2-reduced")
B, S, DECODE = 2, 64, 48
TOL = 1e-5
# encdec's public paths: the bf16 frames (see the module's docstring)
LOGIT_TOL = {"encdec": 2e-3}
LOSS_TOL = {"encdec": 1e-4}


def _inputs(cfg, rng):
    """numpy inputs in the family's layout (f32 patches and frames; the
    reference rounds frames to bf16, as the port does)."""
    text = S - cfg.n_patches if cfg.family == "vlm" else S
    toks = rng.integers(0, cfg.vocab, (B, text + 1)).astype(np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.family == "vlm":
        out["patches"] = rng.standard_normal((B, cfg.n_patches, cfg.d_model)
                                             ).astype(np.float32)
    if cfg.family == "encdec":
        out["frames"] = rng.standard_normal((B, S // cfg.frame_ratio, cfg.d_model)
                                            ).astype(np.float32)
    return out, rng.integers(0, cfg.vocab, (B, DECODE)).astype(np.int32)


@pytest.fixture(scope="module")
def ref_out():
    """The reference's outputs for every arch in f32, with its weights and
    the inputs that produced them (numpy)."""
    out = {}
    for i, arch in enumerate(ARCHS):
        cfg = jax_resolve_config(arch)
        if cfg.family == "encdec":
            # its encoder's scan carries the bf16 frames into f32 layers, a
            # carry whose dtype changes, which lax.scan refuses; the
            # unrolled layers (and the unchunked attention they select) are
            # the same function
            cfg = dataclasses.replace(cfg, scan_layers=False)
        model = JaxModel(cfg)
        params = jax.tree.map(lambda a: a.astype(jnp.float32),
                              model.init(jax.random.key(i)))
        batch, dec_toks = _inputs(cfg, np.random.default_rng(i))
        jb = {k: jnp.asarray(v) for k, v in batch.items()}
        # an f32 cache from the start: the reference's bf16 cache turns f32
        # at the first step of an f32 model, with the same (zero) values
        cache = jax.tree.map(lambda a: a.astype(jnp.float32)
                             if a.dtype == jnp.bfloat16 else a,
                             model.init_cache(B, S))
        decode = jax.jit(model.decode_step)
        logits = []
        for t in range(DECODE):
            cache, lg = decode(params, cache, {
                "tokens": jnp.asarray(dec_toks[:, t]),
                "pos": jnp.full((B,), t, jnp.int32)})
            logits.append(np.asarray(lg))
        if cfg.family == "encdec":
            def enc_dec(params, frames, tokens):
                mem = model._encoder(params, frames)
                x, positions = model._embed_batch(params, {"tokens": tokens})
                return model._decoder_ed(params, x, mem, positions)
            out[arch + ":f32 frames"] = np.asarray(jax.jit(enc_dec)(
                params, jb["frames"], jb["tokens"]))
        out[arch] = {
            "tree": jax.tree.map(np.asarray, params), "batch": batch,
            "dec_toks": dec_toks,
            "prefill": np.asarray(jax.jit(model.prefill)(params, jb)[1]),
            "loss": float(jax.jit(model.train_loss)(params, jb)),
            "decode": np.stack(logits),
        }
    return out


def _port(arch, tree):
    cfg = resolve_config(arch)
    model = Model(cfg, device=CPU)
    model.load_state_dict(model_params_from_numpy(cfg, tree, CPU), assign=True)
    return model


def _batch(batch, labels=True):
    return {k: torch.from_numpy(v) for k, v in batch.items()
            if labels or k != "labels"}


def _rel(got, exp):
    got = np.asarray(got, np.float32)
    return float(np.abs(got - exp).max() / np.abs(exp).max())


def test_configs_are_the_references():
    from repro.models.config import all_configs as jax_all_configs
    from repro.models.config import cell_is_applicable as jax_applicable
    from repro_torch.models import SHAPES, all_configs, cell_is_applicable
    ours, theirs = all_configs(), jax_all_configs()
    assert sorted(ours) == sorted(theirs)
    for name, cfg in ours.items():
        assert dataclasses.asdict(cfg) == dataclasses.asdict(theirs[name])
        assert cfg.param_count() == theirs[name].param_count()
        assert cfg.is_subquadratic == theirs[name].is_subquadratic
        for shape in SHAPES.values():
            assert cell_is_applicable(cfg, shape) == jax_applicable(
                theirs[name], JaxShapeConfig(**dataclasses.asdict(shape)))
    for arch in ARCHS:
        assert dataclasses.asdict(resolve_config(arch)) == \
            dataclasses.asdict(jax_resolve_config(arch))


@pytest.mark.parametrize("arch", ARCHS)
def test_parameters_carry_the_reference_names_shapes_and_dtypes(arch):
    model = Model(resolve_config(arch), device=CPU)
    jax_model = JaxModel(jax_resolve_config(arch))
    tree = jax.tree.map(np.asarray, jax_model.init(jax.random.key(0)))
    state = model_params_from_numpy(model.cfg, tree, CPU)
    params = dict(model.named_parameters())
    assert sorted(state) == sorted(params)
    for name, p in params.items():
        assert state[name].shape == p.shape, name
        assert state[name].dtype == p.dtype, name
    assert sum(p.numel() for p in params.values()) == sum(
        np.asarray(a).size for a in jax.tree.leaves(tree))
    other = resolve_config("mixtral-8x22b-reduced" if arch.startswith("smollm")
                           else "smollm-360m-reduced")
    with pytest.raises(ValueError, match="stacked layers"):
        model_params_from_numpy(dataclasses.replace(other, n_layers=3), tree, CPU)


@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_logits(ref_out, arch):
    r = ref_out[arch]
    model = _port(arch, r["tree"])
    with torch.inference_mode():
        got = model.prefill(_batch(r["batch"], labels=False))
    assert got.shape == (B, model.cfg.padded_vocab)
    assert _rel(got, r["prefill"]) <= LOGIT_TOL.get(model.cfg.family, TOL)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss(ref_out, arch):
    r = ref_out[arch]
    model = _port(arch, r["tree"])
    with torch.inference_mode():
        loss = float(model.train_loss(_batch(r["batch"])))
    assert abs(loss - r["loss"]) <= LOSS_TOL.get(model.cfg.family, TOL) * abs(r["loss"])


def test_encoder_and_decoder_on_f32_frames(ref_out):
    """encdec's encoder (bidirectional, non-causal attention) and decoder
    (causal self attention through the kernel's plain version, then cross
    attention on the encoder's output) on f32 frames: 1e-5."""
    arch = "seamless-m4t-large-v2-reduced"
    r = ref_out[arch]
    model = _port(arch, r["tree"])
    b = _batch(r["batch"])
    with torch.inference_mode():
        mem = model._encoder(b["frames"])
        x, positions = model._embed_batch(b)
        got = model._decoder_ed(x, mem, positions)
    assert _rel(got, ref_out[arch + ":f32 frames"]) <= TOL


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_steps(ref_out, arch):
    """48 steps; with a window of 32 the ring's slots are reused from step
    32 on."""
    r = ref_out[arch]
    model = _port(arch, r["tree"])
    cfg = model.cfg
    cache = model.init_cache(B, S)
    assert cache["k"].shape[2] == (min(S, cfg.window) if cfg.window else S)
    toks = torch.from_numpy(r["dec_toks"])
    with torch.inference_mode():
        for t in range(DECODE):
            cache, logits = model.decode_step(cache, {
                "tokens": toks[:, t], "pos": torch.full((B,), t, dtype=torch.int32)})
            assert _rel(logits, r["decode"][t]) <= TOL, t
    if cfg.window:
        assert sorted(cache["kpos"][0].tolist()) == list(range(DECODE - cfg.window,
                                                               DECODE))


@pytest.mark.parametrize("arch", ["smollm-360m-reduced", "h2o-danube-3-4b-reduced",
                                  "mixtral-8x22b-reduced",
                                  "qwen3-moe-235b-a22b-reduced"])
def test_prefill_agrees_with_token_by_token_decode(ref_out, arch):
    """The same function two ways, in f32 on the port alone: the full
    sequence through the attention kernel's plain version, and 40 decode
    steps (past the window of 32 where there is one).  The moe configs run
    with a capacity no expert can overflow (factor E / top_k): prefill
    routes 80 tokens a group and decode 2, so a drop in prefill alone
    would make them different functions."""
    cfg = resolve_config(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    model = Model(cfg, device=CPU)
    model.load_state_dict(model_params_from_numpy(
        cfg, ref_out[arch]["tree"], CPU), assign=True)
    toks = torch.from_numpy(ref_out[arch]["dec_toks"][:, :40])
    cache = model.init_cache(B, 40)
    with torch.inference_mode():
        for t in range(40):
            cache, logits = model.decode_step(cache, {
                "tokens": toks[:, t], "pos": torch.full((B,), t, dtype=torch.int32)})
        full = model.prefill({"tokens": toks})
    assert _rel(logits, full.numpy()) <= TOL


def test_serve_cli_defaults_to_smollm_and_serves_mixtral(monkeypatch):
    """The CLI's default ``--arch`` is the reference's, smollm-360m-reduced;
    a moe model serves through it too."""
    from repro_torch.launch import serve
    served = []

    def resolve(name):
        served.append(name)
        return resolve_config(name)
    monkeypatch.setattr(serve, "resolve_config", resolve)
    common = ["--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4"]
    assert serve.main(common) == 0
    assert serve.main(["--arch", "mixtral-8x22b-reduced", *common]) == 0
    assert served == ["smollm-360m-reduced", "mixtral-8x22b-reduced"]


def test_generate_serves_a_dense_and_a_moe_model():
    for arch in ("smollm-360m-reduced", "mixtral-8x22b-reduced"):
        cfg = resolve_config(arch)
        model = Model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
        prompts = torch.randint(0, cfg.vocab, (2, 8),
                                generator=torch.Generator().manual_seed(1),
                                dtype=torch.int32)
        with torch.inference_mode():
            out = generate(model, prompts, 4)
        assert out.shape == (2, 12) and torch.equal(out[:, :8], prompts)
        assert int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab


# ------------------------------------------------------------------ moe


def _moe_cfg():
    return resolve_config("qwen3-moe-235b-a22b-reduced")


@pytest.mark.parametrize("capacity", [4, 8, 64])
@pytest.mark.parametrize("ties", [False, True])
def test_route_topk_is_the_references_bit_for_bit(capacity, ties):
    """Dispatch bit for bit, the capacity-dropped tokens included
    (capacity 4 and 8 drop, 64 does not); with all logits equal every
    token's top-k are the lowest expert indices, as ``jax.lax.top_k``
    breaks ties, and combine is bit for bit too.  On random logits the
    combine weights agree within 1e-6: XLA's exp and PyTorch's differ by an
    ulp on some inputs (43 of these 512), so no softmax matches bit for
    bit."""
    rng = np.random.default_rng(capacity)
    logits = np.zeros((2, 32, 8), np.float32) if ties else \
        rng.standard_normal((2, 32, 8)).astype(np.float32)
    d1, c1, a1 = jax_moe.route_topk(jnp.asarray(logits), 2, capacity)
    d2, c2, a2 = moe.route_topk(torch.from_numpy(logits), 2, capacity)
    np.testing.assert_array_equal(d2.numpy(), np.asarray(d1))
    if ties:
        np.testing.assert_array_equal(c2.numpy(), np.asarray(c1))
    else:
        np.testing.assert_allclose(c2.numpy(), np.asarray(c1), rtol=1e-6, atol=0)
    assert float(a2) == pytest.approx(float(a1), rel=1e-6)
    kept = d2.sum((1, 3))
    assert float(kept.max()) <= capacity
    if capacity == 4:
        assert float(d2.sum()) < 2 * 32 * 2        # some choices dropped
    if ties:
        assert torch.all(d2[..., 2:, :] == 0)      # experts 0 and 1 only


def test_moe_capacity_is_the_references():
    for name in ("qwen3-moe-235b-a22b-reduced", "mixtral-8x22b-reduced",
                 "qwen3-moe-235b-a22b", "mixtral-8x22b"):
        for g in (1, 4, 32, 64, 512):
            assert moe.moe_capacity(resolve_config(name), g) == \
                jax_moe.moe_capacity(jax_resolve_config(name), g)


@pytest.fixture(scope="module")
def moe_setup():
    """tests/test_moe.py's setup: qwen3-moe-reduced's MoE block from the
    reference's init, x (2, 64, d) in bf16."""
    from repro.models.layers import init_params
    cfg = jax_resolve_config("qwen3-moe-235b-a22b-reduced")
    p = jax.tree.map(np.asarray, init_params(jax_moe.moe_defs(cfg),
                                             jax.random.key(0)))
    x = jax.random.normal(jax.random.key(1), (2, 64, cfg.d_model),
                          jnp.float32).astype(jnp.bfloat16)
    state = model_params_from_numpy(cfg, p, CPU)
    x_t = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    return p, x, state, x_t


@pytest.mark.parametrize("group", [32, 64, 128])
def test_moe_ffn_sorted_equals_onehot(moe_setup, group):
    """As tests/test_moe.py: the two dispatches within 3e-2 in bf16, the
    aux losses within 1e-5."""
    _, _, state, x = moe_setup
    cfg = _moe_cfg()
    y1, a1 = moe.moe_ffn(state, x, dataclasses.replace(cfg, moe_dispatch="onehot"),
                         group_size=group)
    y2, a2 = moe.moe_ffn(state, x, dataclasses.replace(cfg, moe_dispatch="sort"),
                         group_size=group)
    np.testing.assert_allclose(y1.float().numpy(), y2.float().numpy(),
                               atol=3e-2, rtol=3e-2)
    assert float(a1) == pytest.approx(float(a2), rel=1e-5)


@pytest.mark.parametrize("dispatch", ["onehot", "sort"])
def test_moe_ffn_matches_the_reference_in_f32(moe_setup, dispatch):
    p, x, _, _ = moe_setup
    cfg = dataclasses.replace(_moe_cfg(), moe_dispatch=dispatch)
    p32 = {k: np.asarray(v, np.float32) for k, v in p.items()}
    x32 = np.asarray(x.astype(jnp.float32))
    y1, a1 = jax_moe.moe_ffn({k: jnp.asarray(v) for k, v in p32.items()},
                             jnp.asarray(x32), dataclasses.replace(
                                 jax_resolve_config(cfg.name), moe_dispatch=dispatch),
                             group_size=64)
    y2, a2 = moe.moe_ffn({k: torch.from_numpy(v.copy()) for k, v in p32.items()},
                         torch.from_numpy(x32), cfg, group_size=64)
    assert _rel(y2, np.asarray(y1)) <= TOL
    assert float(a2) == pytest.approx(float(a1), rel=1e-6)


# ----------------------------------------------------------- the kernel


@pytest.mark.parametrize("s", [64, 128, 256])
@pytest.mark.parametrize("window", [0, 48])
@pytest.mark.parametrize("hd", [16, 20, 120])
def test_flash_attention_plain_matches_pallas_at_the_families_head_dims(hd, window, s):
    """The Pallas kernel in interpret mode (blocks of 64; its blocks span
    the whole head dim) against the port's plain version, blocked by query
    rows (here 2 blocks a call): f32, summed in other orders."""
    rng = np.random.default_rng(hd * s + window)
    q, k, v = (rng.standard_normal(shape).astype(np.float32)
               for shape in ((1, 4, s, hd), (1, 2, s, hd), (1, 2, s, hd)))
    exp = np.asarray(jax_flash_attention(jnp.asarray(q), jnp.asarray(k),
                                         jnp.asarray(v), window=window,
                                         block_q=64, block_k=64, interpret=True))
    qt, kt, vt = (torch.from_numpy(a) for a in (q, k, v))
    got = ref.flash_attention_ref(qt, kt, vt, window=window,
                                  block_elems=4 * s * s // 2)
    np.testing.assert_allclose(got.numpy(), exp, rtol=2e-5, atol=2e-5)


# ------------------------------------------------------- batch layouts


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("train", [False, True])
def test_family_batch_has_the_reference_layout(arch, train):
    cfg = resolve_config(arch)
    shape = JaxShapeConfig("t", S, 4, "train" if train else "prefill")
    structs = batch_struct(jax_resolve_config(arch), shape, micro=1)
    got = family_batch(cfg, 4, S, torch.Generator().manual_seed(0), train=train)
    assert sorted(got) == sorted(structs)
    for key, st in structs.items():
        assert tuple(got[key].shape) == st.shape, key
        assert str(got[key].dtype).split(".")[-1] == str(st.dtype), key
    if train:
        assert int(got["labels"].max()) < cfg.vocab
    with torch.inference_mode():   # the port's model takes it as it is
        model = Model(cfg, device=CPU).init(torch.Generator().manual_seed(0))
        out = model.train_loss(got) if train else model.prefill(got)
    assert bool(torch.isfinite(out).all())
