"""The port's backward passes against the reference's gradients, on the
same numpy inputs:

- the plain backwards: ``ref.flash_attention_bwd_ref`` against
  ``jax.vjp`` of the reference's ``flash_attention_ref`` at hd 16, 20 and
  120, with and without a window, and ``ref.scan_bwd_ref`` against the
  reference's ``linear_scan`` (its custom VJP); both also against
  ``torch.autograd`` through the plain forwards;
- an emulation of the card's f32 attention backward arithmetic (3xTF32:
  each product as three products of TF32 parts) against ``jax.vjp`` and
  against the card's row-by-row check;
- ``ops``' autograd on CPU tensors (the plain backwards), and
  ``cfg.remat`` "full" and "dots" giving "none"'s gradients;
- serving builds no graph: the parameters track no gradients until a
  trainer opts in, and ``generate``/``adaptive_eval`` return tensors that
  require none.

The gradients of ``train_loss`` for the reduced configs of every family
are in ``test_torch_train_grads.py``.

Tolerance.  f32 on both sides, summed in other orders: each gradient
within 1e-5 of its largest magnitude."""

import pytest

torch = pytest.importorskip("torch")

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np

from repro.kernels.ref import flash_attention_ref as jax_flash_ref
from repro.models.ssm import linear_scan as jax_linear_scan
from repro_torch.data import TokenStream
from repro_torch.kernels import ops, ref
from repro_torch.launch.serve import adaptive_eval, generate
from repro_torch.models import Model, resolve_config

TOL = 1e-5


def _rel(got, exp):
    got = np.asarray(got, np.float64)
    exp = np.asarray(exp, np.float64)
    return float(np.abs(got - exp).max() / max(np.abs(exp).max(), 1e-30))


def _attn_inputs(hd, s, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((2, 4, s, hd), (2, 2, s, hd), (2, 2, s, hd),
                          (2, 4, s, hd))]


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("hd", [16, 20, 120])
def test_flash_attention_bwd_ref_matches_jax_vjp(hd, window):
    s = 70
    q, k, v, do = _attn_inputs(hd, s, hd + window)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_ref(q, k, v, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    exp = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_ref(qt, kt, vt, window=window, return_lse=True,
                                     block_elems=2 * 4 * s * 20)  # 4 blocks
    got = ref.flash_attention_bwd_ref(qt, kt, vt, o, lse, dot, window=window,
                                      block_elems=2 * 4 * s * 20)
    for g, e in zip(got, exp):
        assert _rel(g.numpy(), e) <= TOL


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("hd", [16, 20, 120])
def test_flash_attention_bwd_ref_matches_torch_autograd(hd, window):
    """Against autograd through the plain forward itself (in one block)."""
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(hd, 50, hd))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ref.flash_attention_ref(*leaves, window=window)
    exp = torch.autograd.grad(o, leaves, do)
    o, lse = ref.flash_attention_ref(q, k, v, window=window, return_lse=True)
    got = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, window=window)
    for g, e in zip(got, exp):
        assert _rel(g.numpy(), e.numpy()) <= TOL


@pytest.mark.parametrize("shape", [(2, 33, 7), (1, 40, 5, 3)])
def test_scan_bwd_ref_matches_the_reference_custom_vjp(shape):
    rng = np.random.default_rng(len(shape))
    a = rng.uniform(0.2, 0.95, shape).astype(np.float32)
    b, g = (rng.standard_normal(shape).astype(np.float32) for _ in range(2))
    _, vjp = jax.vjp(jax_linear_scan, jnp.asarray(a), jnp.asarray(b))
    eda, edb = vjp(jnp.asarray(g))
    at = torch.from_numpy(a)
    h = ref.rglru_scan_ref(at, torch.from_numpy(b))
    da, db = ref.scan_bwd_ref(at, h, torch.from_numpy(g))
    assert _rel(da.numpy(), eda) <= TOL and _rel(db.numpy(), edb) <= TOL
    # and autograd through the plain recurrence
    al, bl = (torch.from_numpy(x).double().requires_grad_() for x in (a, b))
    hs, hv = [], torch.zeros_like(al[:, 0])
    for t in range(shape[1]):
        hv = al[:, t] * hv + bl[:, t]
        hs.append(hv)
    ada, adb = torch.autograd.grad(torch.stack(hs, 1), (al, bl),
                                   torch.from_numpy(g).double())
    assert _rel(da.numpy(), ada.numpy()) <= TOL and _rel(db.numpy(), adb.numpy()) <= TOL


def test_ops_differentiate_cpu_tensors_through_the_plain_backwards():
    q, k, v, do = (torch.from_numpy(a) for a in _attn_inputs(20, 30, 5))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    o = ops.flash_attention(*leaves, window=7)
    assert o.grad_fn is not None
    got = torch.autograd.grad(o, leaves, do)
    o2, lse = ref.flash_attention_ref(q, k, v, window=7, return_lse=True)
    for g, e in zip(got, ref.flash_attention_bwd_ref(q, k, v, o2, lse, do, window=7)):
        assert torch.equal(g, e)
    a = torch.rand(2, 9, 4, 3) * 0.5 + 0.4
    b, g = torch.randn(2, 9, 4, 3), torch.randn(2, 9, 4, 3)
    al, bl = a.clone().requires_grad_(), b.clone().requires_grad_()
    da, db = torch.autograd.grad(ops.ssm_scan(al, bl), (al, bl), g)
    eda, edb = ref.scan_bwd_ref(a, ref.ssm_scan_ref(a, b), g)
    assert torch.equal(da, eda) and torch.equal(db, edb)
    with torch.no_grad():
        assert ops.rglru_scan(al[..., 0], bl[..., 0]).grad_fn is None



# ------------------------------------------------ 3xTF32, emulated on the CPU
# The card's f32 backward (csrc/flash_attention.cu, namespace tf3) runs its
# five products on the tensor cores as 3xTF32: each f32 operand x is split
# into big = tf32(x), rounded to nearest, and small = x − big, which the
# tensor cores read truncated to TF32, and a product is small·big +
# big·small + big·big in f32 (small·small, ~2⁻²² of it, is dropped).  A
# plain emulation of that arithmetic, held to the reference's gradients at
# the file's tolerance and to the card's check at its tolerance, before any
# card time: a test aid, not a plain version of a kernel.


def _tf32(x):
    """x rounded to TF32 (10 mantissa bits) to nearest, ties away from
    zero, on the int32 view: ``cvt.rna.tf32.f32``."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_truncated(x):
    """x cut to TF32 toward zero: the top 19 bits, as the tensor cores read
    an operand that is not TF32."""
    return (x.view(torch.int32) & -0x2000).view(torch.float32)


def _mm_3xtf32(a, b):
    """a @ b (batched) as three f32 products of TF32 operands; each product
    of two TF32 values is exact in f32."""
    a_big, b_big = _tf32(a), _tf32(b)
    a_small, b_small = _tf32_truncated(a - a_big), _tf32_truncated(b - b_big)
    return a_small @ b_big + a_big @ b_small + a_big @ b_big


def _flash_bwd_3xtf32(q, k, v, o, lse, do, window):
    """``ref.flash_attention_bwd_ref``'s recurrences with its five products
    (S = Q·Kᵀ, dP = dO·Vᵀ, dV = Pᵀ·dO, dK = dSᵀ·Q, dQ = dS·K) in 3xTF32,
    P and dS kept in f32."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / np.sqrt(hd)
    qg, dog = (t.reshape(B, KV, G, S, hd) for t in (q, do))
    kg, vg = k[:, :, None], v[:, :, None]
    D = (dog * o.reshape(B, KV, G, S, hd)).sum(-1, keepdim=True)
    pos = torch.arange(S)
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    s = _mm_3xtf32(qg, kg.transpose(-1, -2)) * scale
    p = torch.where(mask, torch.exp(s - lse.reshape(B, KV, G, S, 1)), 0.0)
    ds = p * (_mm_3xtf32(dog, vg.transpose(-1, -2)) - D)
    dv = _mm_3xtf32(p.transpose(-1, -2), dog).sum(2)
    dk = _mm_3xtf32(ds.transpose(-1, -2), qg).sum(2) * scale
    dq = _mm_3xtf32(ds, kg) * scale
    return dq.reshape(B, H, S, hd), dk, dv


def test_tf32_rounds_to_nearest_ties_away():
    one = 1.0 + 2.0 ** -10                    # a TF32 value
    x = torch.tensor([1.0 + 2.0 ** -11, -(1.0 + 2.0 ** -11), 1.0 + 3 * 2.0 ** -12,
                      1.0 + 2.0 ** -12, one, 0.0, 2.0 - 2.0 ** -12],
                     dtype=torch.float32)
    exp = [one, -one, one, 1.0, one, 0.0, 2.0]
    assert _tf32(x).tolist() == exp
    assert _tf32_truncated(x).tolist() == [1.0, -1.0, 1.0, 1.0, one, 0.0,
                                           2.0 - 2.0 ** -10]
    third = torch.tensor([1.0 / 3.0])
    big = _tf32(third)
    assert (big.view(torch.int32) & 0x1FFF).item() == 0
    # small = x − big is exact, and its truncation keeps x to 2⁻²¹
    assert abs(float(big + _tf32_truncated(third - big)) - 1.0 / 3.0) <= 2.0 ** -21 / 3


@pytest.mark.parametrize("window", [0, 24])
@pytest.mark.parametrize("hd", [16, 20, 120])
def test_flash_attention_bwd_3xtf32_matches_jax_vjp(hd, window):
    """The emulated 3xTF32 backward against ``jax.vjp`` of the reference
    attention, at the plain backward's cases and tolerance."""
    s = 70
    q, k, v, do = _attn_inputs(hd, s, hd + window)
    _, vjp = jax.vjp(lambda q, k, v: jax_flash_ref(q, k, v, window=window),
                     jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    exp = vjp(jnp.asarray(do))
    qt, kt, vt, dot = (torch.from_numpy(a) for a in (q, k, v, do))
    o, lse = ref.flash_attention_ref(qt, kt, vt, window=window, return_lse=True)
    got = _flash_bwd_3xtf32(qt, kt, vt, o, lse, dot, window)
    for g, e in zip(got, exp):
        assert _rel(g.numpy(), e) <= TOL


@pytest.mark.parametrize("s,group,window", [(1, 1, 0), (100, 4, 40),
                                            (300, 8, 150), (300, 1, 0)])
@pytest.mark.parametrize("hd", [16, 20, 32, 64, 120, 128, 256])
def test_flash_attention_bwd_3xtf32_passes_the_card_check(hd, s, group, window):
    """The emulated 3xTF32 backward held row by row by
    ``ref.flash_attention_bwd_check`` at the f32 tolerance the card's
    kernel is held to (1e-4), at the card test's shapes (b 2, kv 2)."""
    rng = np.random.default_rng(hd * s + group)
    q, k, v, do = (torch.from_numpy(rng.standard_normal((2, n, s, hd))
                                    .astype(np.float32))
                   for n in (2 * group, 2, 2, 2 * group))
    o, lse = ref.flash_attention_ref(q, k, v, window=window, return_lse=True)
    got = _flash_bwd_3xtf32(q, k, v, o, lse, do, window)
    res = ref.flash_attention_bwd_check(q, k, v, o, lse, do, got, window=window,
                                        tol=1e-4)
    assert all(r["worst"] <= 1.0 for r in res.values()), res

def _grads(model, batch):
    params = dict(model.named_parameters())
    loss = model.train_loss(batch)
    return loss, dict(zip(params, torch.autograd.grad(loss, list(params.values()))))


@pytest.mark.parametrize("remat", ["full", "dots"])
@pytest.mark.parametrize("arch", ["smollm-360m-reduced", "mixtral-8x22b-reduced",
                                  "recurrentgemma-2b-reduced",
                                  "falcon-mamba-7b-reduced",
                                  "seamless-m4t-large-v2-reduced"])
def test_remat_gives_the_gradients_of_none(arch, remat):
    from repro_torch.data import family_batch
    cfg = resolve_config(arch)
    assert cfg.remat == "none"
    gen = torch.Generator().manual_seed(0)
    model = Model(cfg, device="cpu").init(gen).float().requires_grad_(True)
    batch = family_batch(cfg, 2, 40, gen, train=True)
    loss, exp = _grads(model, batch)
    model.cfg = dataclasses.replace(cfg, remat=remat)
    loss_r, got = _grads(model, batch)
    assert float(loss_r.detach()) == float(loss.detach())
    for name, e in exp.items():
        torch.testing.assert_close(got[name], e, rtol=1e-6, atol=1e-7)


def test_serving_builds_no_graph():
    """The parameters track no gradients until a trainer opts in, so
    ``train_loss``, ``prefill``, ``generate`` and ``adaptive_eval`` under
    plain grad mode (as the pool's sessions call them) build no graph."""
    cfg = resolve_config("recurrentgemma-2b-reduced")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    assert not any(p.requires_grad for p in model.parameters())
    stream = TokenStream(vocab=cfg.vocab, seq_len=8, batch=2)
    batch = stream.batch_at(0, device="cpu")
    assert torch.is_grad_enabled()
    assert model.train_loss(batch).grad_fn is None
    assert model.prefill(batch).grad_fn is None
    out = generate(model, batch["tokens"], 2)
    mean, res = adaptive_eval(model, stream, eps=5.0, delta=0.5)
    assert not out.requires_grad and res.stopped
    assert not any(t.requires_grad for t in (res.state.total.num,
                                             *res.state.total.data.values()))
    model.requires_grad_(True)
    assert model.train_loss(batch).grad_fn is not None
