"""Frames and the KADABRA stopping rule of the port against the reference,
on the same numpy inputs: exact for integer frames, allclose in f32 for the
bounds, equal verdicts away from the threshold."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.core import frames as jf
from repro.core import stopping as js
from repro_torch.convert import frame_from_numpy
from repro_torch.core import frames as tf
from repro_torch.core import stopping as ts


def _int_frames(w, n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 7, (w,)).astype(np.int32),
            {"counts": rng.integers(0, 1000, (w, n)).astype(np.int32),
             "s1": rng.integers(0, 1000, (w,)).astype(np.int32)})


def _jframe(num, data):
    return jf.StateFrame(num=jnp.asarray(num),
                         data={k: jnp.asarray(v) for k, v in data.items()})


def _assert_frames_equal(tframe, jframe):
    np.testing.assert_array_equal(tframe.num.numpy(), np.asarray(jframe.num))
    for k in jframe.data:
        np.testing.assert_array_equal(tframe.data[k].numpy(),
                                      np.asarray(jframe.data[k]))


@pytest.mark.parametrize("w,n", [(1, 5), (4, 33), (8, 1000)])
def test_combine_and_accumulate_exact(w, n):
    num, data = _int_frames(w, n, seed=w * n)
    a = {k: v[0] for k, v in data.items()}
    b = {k: v[-1] for k, v in data.items()}
    _assert_frames_equal(
        tf.combine(frame_from_numpy(num[0], a, "cpu"), frame_from_numpy(num[-1], b, "cpu")),
        jf.combine(_jframe(num[0], a), _jframe(num[-1], b)))
    _assert_frames_equal(tf.accumulate(frame_from_numpy(num, data, "cpu")),
                         jf.accumulate(_jframe(num, data)))


@pytest.mark.parametrize("w,f", [(4, 4), (4, 2), (8, 2), (6, 3)])
def test_virtual_reductions_match_accumulate(w, f):
    num, data = _int_frames(w, 24, seed=w + f)
    stacked = frame_from_numpy(num, data, "cpu")
    full = jf.accumulate(_jframe(num, data))
    colls = tf.virtual_collectives(w, f)
    _assert_frames_equal(colls.reduce_frames(stacked), full)
    shards = colls.scatter_frames(stacked)
    total = np.asarray(full.data["counts"]).reshape(f, -1)
    for wid in range(w):  # worker w holds shard w % F of the global sum
        np.testing.assert_array_equal(shards.data["counts"][wid].numpy(),
                                      total[wid % f])


@pytest.mark.parametrize("n,w", [(1, 1), (10, 4), (12, 4), (999, 8), (7, 7)])
def test_shard_frame_pad_equal(n, w):
    assert tf.shard_frame_pad(n, w) == jf.shard_frame_pad(n, w)


@pytest.mark.parametrize("w,f", [(1, 1), (4, 4), (4, 2), (8, 2), (8, 1), (6, 3)])
def test_shard_groups_equal(w, f):
    assert tf.shard_groups(w, f) == jf.shard_groups(w, f)


@pytest.mark.parametrize("tau", [64, 640, 4096, 20000])
def test_kadabra_condition_matches_reference(tau):
    n, eps, delta, omega = 300, 0.05, 0.1, 5000.0
    rng = np.random.default_rng(tau)
    counts = (rng.random(n) ** 4 * tau * 0.3).astype(np.int32)
    jc = js.KadabraCondition(eps=eps, delta=delta, omega=omega, n_vertices=n)
    tc = ts.KadabraCondition(eps=eps, delta=delta, omega=omega, n_vertices=n)
    jstop, jaux = jc(jf.StateFrame(num=jnp.int32(tau), data=jnp.asarray(counts)))
    tstop, taux = tc(frame_from_numpy(np.int32(tau), counts, "cpu"))
    bt = counts.astype(np.float32) / tau
    jfv, jgv = jc.per_vertex_bounds(jnp.asarray(bt), jnp.float32(tau))
    tfv, tgv = tc.per_vertex_bounds(torch.from_numpy(bt), torch.tensor(tau))
    np.testing.assert_allclose(tfv.numpy(), np.asarray(jfv), rtol=1e-5)
    np.testing.assert_allclose(tgv.numpy(), np.asarray(jgv), rtol=1e-5)
    for k in ("max_f", "max_g", "tau"):
        np.testing.assert_allclose(taux[k].numpy(), np.asarray(jaux[k]), rtol=1e-5)
    margin = min(abs(float(jaux["max_f"]) - eps), abs(float(jaux["max_g"]) - eps))
    assert margin > 1e-4 * eps, "input too close to the threshold to compare verdicts"
    assert bool(tstop) == bool(jstop)


def test_kadabra_condition_verdicts_both_ways():
    """One frame on each side of the threshold, so both verdicts occur."""
    n, eps, delta = 100, 0.05, 0.1
    counts = np.full(n, 3, np.int32)
    verdicts = []
    for tau, omega in [(50, 5000.0), (4000, 5000.0), (50, 40.0)]:
        jc = js.KadabraCondition(eps=eps, delta=delta, omega=omega, n_vertices=n)
        tc = ts.KadabraCondition(eps=eps, delta=delta, omega=omega, n_vertices=n)
        jstop, _ = jc(jf.StateFrame(num=jnp.int32(tau), data=jnp.asarray(counts)))
        tstop, _ = tc(frame_from_numpy(np.int32(tau), counts, "cpu"))
        assert bool(tstop) == bool(jstop)
        verdicts.append(bool(tstop))
    assert verdicts == [False, True, True]


@pytest.mark.parametrize("eps,delta,vd", [(0.05, 0.1, 9), (0.02, 0.1, 17),
                                          (0.1, 0.01, 3), (0.03, 0.05, 1000)])
def test_kadabra_omega_equal(eps, delta, vd):
    assert ts.kadabra_omega(eps, delta, vd) == js.kadabra_omega(eps, delta, vd)


def test_hoeffding_and_bernstein_allclose():
    np.testing.assert_allclose(float(ts.hoeffding_tau_needed(0.05, 0.1)),
                               float(js.hoeffding_tau_needed(0.05, 0.1)), rtol=1e-6)
    s1, s2, tau = np.float32(40.0), np.float32(31.0), np.float32(100.0)
    tm, th = ts.empirical_bernstein_half_width(torch.tensor(s1), torch.tensor(s2),
                                               torch.tensor(tau), 0.1)
    jm, jh = js.empirical_bernstein_half_width(jnp.float32(s1), jnp.float32(s2),
                                               jnp.float32(tau), 0.1)
    np.testing.assert_allclose([float(tm), float(th)], [float(jm), float(jh)],
                               rtol=1e-6)
