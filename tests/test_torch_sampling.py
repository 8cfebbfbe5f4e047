"""Weighted sampling in the port against the reference: the alias table is
bit-identical, ``alias_draw_ref`` equals the Pallas ``alias_draw`` (interpret
mode) exactly on the same uniforms, ``ops`` dispatches by device, and the
wrs SAMPLE() keeps each worker's randomness to its own generator.  The
CUDA kernel against its plain version is in ``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import repro.sampling as jsamp
from repro.kernels.alias_draw import alias_draw as jax_alias_draw
from repro_torch.convert import alias_table_from_numpy
from repro_torch.core.epoch import make_generator
from repro_torch.kernels import alias_draw as alias_mod
from repro_torch.kernels import build, ops, ref
from repro_torch.sampling import (alias_draw_probabilities, build_alias_table,
                                  make_weighted_sample_fn,
                                  weighted_frame_template, weighted_mean_exact)

CPU = torch.device("cpu")
EDGE = np.array([0.0, np.nextafter(np.float32(1), np.float32(0))], np.float32)


def _weights(n, seed):
    return np.random.default_rng(seed).pareto(1.5, size=n) + 1e-3


def _assert_same_table(tt, jt):
    assert tt.n == jt.n
    assert tt.prob.dtype == torch.float32 and tt.alias.dtype == torch.int32
    np.testing.assert_array_equal(tt.prob.numpy().view(np.uint32),
                                  np.asarray(jt.prob).view(np.uint32))
    np.testing.assert_array_equal(tt.alias.numpy(), np.asarray(jt.alias))


@pytest.mark.parametrize("n", [1, 2, 7, 257, 4096, 100_003])
def test_build_alias_table_bit_identical(n):
    w = _weights(n, seed=n)
    _assert_same_table(build_alias_table(w, device=CPU),
                       jsamp.build_alias_table(w))


@pytest.mark.parametrize("w", [[3.0], [1.0, 0.0, 1.0], [0.0, 0.0, 5.0, 0.0],
                               [1.0] * 9, [1e-12, 1.0, 1e12]])
def test_build_alias_table_degenerate_bit_identical(w):
    tt = build_alias_table(np.asarray(w), device=CPU)
    jt = jsamp.build_alias_table(np.asarray(w))
    _assert_same_table(tt, jt)
    np.testing.assert_array_equal(alias_draw_probabilities(tt),
                                  jsamp.alias_draw_probabilities(jt))


@pytest.mark.parametrize("w", [np.zeros(4), np.asarray([1.0, -2.0]),
                               np.asarray([1.0, np.inf]), np.zeros(0),
                               np.asarray([np.nan, 1.0])])
def test_build_alias_table_invalid_raises_as_reference(w):
    with pytest.raises(ValueError):
        jsamp.build_alias_table(w)
    with pytest.raises(ValueError):
        build_alias_table(w, device=CPU)


def test_probabilities_and_exact_mean_equal():
    w = _weights(513, seed=5)
    values = np.random.default_rng(6).integers(8, 32, size=513)
    tt, jt = build_alias_table(w, device=CPU), jsamp.build_alias_table(w)
    np.testing.assert_array_equal(alias_draw_probabilities(tt),
                                  jsamp.alias_draw_probabilities(jt))
    np.testing.assert_allclose(alias_draw_probabilities(tt), w / w.sum(),
                               rtol=1e-5, atol=1e-9)
    assert weighted_mean_exact(w, values, 32) == \
        jsamp.weighted_mean_exact(w, values, 32)


def _uniforms(b, seed):
    """u1, u2 (b,) f32 in [0, 1) with the edge uniforms 0 and 1−2⁻²⁴ in every
    combination at the front."""
    rng = np.random.default_rng(seed)
    u1 = rng.random(b, dtype=np.float32)
    u2 = rng.random(b, dtype=np.float32)
    k = min(b, 4)
    u1[:k] = np.array([EDGE[0], EDGE[1], EDGE[0], EDGE[1]])[:k]
    u2[:k] = np.array([EDGE[0], EDGE[0], EDGE[1], EDGE[1]])[:k]
    return u1, u2


@pytest.mark.parametrize("n,b", [(1, 1), (7, 1000), (1000, 4097),
                                 (4096, 10000), (1000, 4)])
def test_alias_draw_ref_equals_pallas(n, b):
    jt = jsamp.build_alias_table(_weights(n, seed=n + b))
    u1, u2 = _uniforms(b, seed=b)
    exp = np.asarray(jax_alias_draw(jt.prob, jt.alias, jnp.asarray(u1),
                                    jnp.asarray(u2), interpret=True))
    tt = alias_table_from_numpy(np.asarray(jt.prob), np.asarray(jt.alias), CPU)
    got = ref.alias_draw_ref(tt.prob, tt.alias, torch.from_numpy(u1),
                             torch.from_numpy(u2))
    assert got.dtype == torch.int32 and got.shape == (b,)
    np.testing.assert_array_equal(got.numpy(), exp)
    assert got.min() >= 0 and got.max() < n


def test_bucket_is_the_truncated_f32_product():
    """bucket = min(trunc(f32(u₁·n)), n−1): with prob ≡ 1 every draw keeps
    its bucket, which must be the reference's for every u₁ near the bucket
    edges, at n that are and are not powers of two."""
    for n in (3, 7, 1000, 1 << 10, (1 << 24) - 3):
        u1 = np.concatenate([
            np.nextafter(np.arange(1, 50, dtype=np.float32) / np.float32(n),
                         np.float32(0)),
            np.arange(1, 50, dtype=np.float32) / np.float32(n), EDGE])
        u1 = np.clip(u1, 0, EDGE[1]).astype(np.float32)
        exp = np.minimum((u1 * np.float32(n)).astype(np.int32), n - 1)
        prob = torch.ones(n, dtype=torch.float32)
        alias = torch.zeros(n, dtype=torch.int32)
        got = ref.alias_draw_ref(prob, alias, torch.from_numpy(u1),
                                 torch.zeros(u1.shape, dtype=torch.float32))
        np.testing.assert_array_equal(got.numpy(), exp)


def test_ops_alias_draw_on_cpu_uses_ref_and_never_builds(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("built"))
    before = alias_mod.launches
    tt = build_alias_table(_weights(50, 1), device=CPU)
    u1, u2 = (torch.from_numpy(u) for u in _uniforms(300, 2))
    assert torch.equal(ops.alias_draw(tt.prob, tt.alias, u1, u2),
                       ref.alias_draw_ref(tt.prob, tt.alias, u1, u2))
    assert alias_mod.launches == before


def test_alias_kernel_wrapper_refuses_cpu_tensors(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("built"))
    tt = build_alias_table(_weights(5, 1), device=CPU)
    u = torch.zeros(3)
    with pytest.raises(ValueError, match="CUDA"):
        alias_mod.alias_draw(tt.prob, tt.alias, u, u)


def test_weighted_sample_fn_frame_and_worker_streams():
    """One round for W = 3 workers: the frame's moments and histogram agree
    with the draws, and worker w's row depends on ``gens[w]`` alone."""
    w = _weights(40, 9)
    values = torch.from_numpy(
        np.random.default_rng(10).integers(8, 32, size=40).astype(np.int32))
    tt = build_alias_table(w, device=CPU)
    fn = make_weighted_sample_fn(tt, values, batch=64, pad_to=42)
    gens = [make_generator(CPU, 7, k) for k in range(3)]
    delta, _ = fn(gens, None)
    assert delta.num.tolist() == [64, 64, 64]
    hist = delta.data["hist"]
    assert hist.shape == (3, 42) and hist.dtype == torch.int32
    assert hist.sum(dim=1).tolist() == [64, 64, 64] and not hist[:, 40:].any()
    s1 = (hist[:, :40] * values).sum(dim=1)
    s2 = (hist[:, :40] * values * values).sum(dim=1)
    assert torch.equal(delta.data["s1"], s1.to(torch.int32))
    assert torch.equal(delta.data["s2"], s2.to(torch.int32))
    alone, _ = fn([make_generator(CPU, 7, 1)], None)
    for k in ("s1", "s2", "hist"):
        assert torch.equal(alone.data[k][0], delta.data[k][1])
    tmpl = weighted_frame_template(40, 42, device=CPU)
    assert tmpl["hist"].shape == (42,) and tmpl["s1"].shape == ()


def test_weighted_draws_follow_the_weights():
    """200k draws: frequencies within 5σ binomial bands of w/Σw."""
    w = _weights(16, 1) + 0.05
    tt = build_alias_table(w, device=CPU)
    fn = make_weighted_sample_fn(tt, torch.zeros(16, dtype=torch.int32),
                                 batch=100_000)
    delta, _ = fn([make_generator(CPU, 1, 0), make_generator(CPU, 1, 1)], None)
    freq = delta.data["hist"].sum(dim=0).double().numpy() / 200_000
    p = w / w.sum()
    assert np.all(np.abs(freq - p) <= 5 * np.sqrt(p * (1 - p) / 200_000))
