"""The port's stopping conditions of the instance layer against the
reference's, on the same numpy frames: the f32 values of each condition's
aux agree to rtol 1e-6 / atol 1e-7, and the verdicts are equal (the frames
are drawn so that none sits at a threshold)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import repro.core.frames as jf
import repro.core.stopping as js
import repro_torch.core.stopping as ts
from repro_torch.convert import frame_from_numpy


def _frames(kind, seed, count=6):
    """``count`` numpy frames of one layout: (num, data)."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(count):
        num = int(rng.integers(2, 5000))
        if kind == "vector":
            out.append((num, rng.integers(0, num + 1, size=7).astype(np.int32)))
        elif kind == "moments":
            xq = rng.integers(0, 32, size=num)
            out.append((num, {"s1": np.int32(xq.sum()),
                              "s2": np.int32((xq * xq).sum())}))
        elif kind == "indicator":
            s1 = np.int32(rng.integers(0, num + 1))
            out.append((num, {"s1": s1, "s2": s1,
                              "hits": np.zeros(5, np.int32)}))
        else:  # "cert": a certificate count beside a histogram
            out.append((num, {"cert": np.int32(rng.integers(0, 3)),
                              "ecc_hist": np.zeros(4, np.int32)}))
    return out


def _jax_frame(num, data):
    data = {k: jnp.asarray(v) for k, v in data.items()} \
        if isinstance(data, dict) else jnp.asarray(data)
    return jf.StateFrame(num=jnp.int32(num), data=data)


def _flat(aux):
    """The aux dict as {name: float64 array}, nested dicts flattened."""
    out = {}
    for k, v in aux.items():
        if isinstance(v, dict):
            out.update({f"{k}.{kk}": np.asarray(vv, np.float64)
                        for kk, vv in v.items()})
        else:
            out[k] = np.asarray(v, np.float64)
    return out


CASES = {
    "hoeffding": (lambda m: m.HoeffdingCondition(eps=0.05, delta=0.1), "vector"),
    "hoeffding-range": (lambda m: m.HoeffdingCondition(eps=0.3, delta=0.05,
                                                       value_range=4.0), "vector"),
    "bernstein": (lambda m: m.EmpiricalBernsteinCondition(
        eps=0.02, delta=0.1, value_range=32.0), "moments"),
    "wedge": (lambda m: m.WedgeClosureCondition(eps=0.05, delta=0.1,
                                                total_wedges=812.0), "vector"),
    "percolation": (lambda m: m.PercolationCondition(eps=0.05, delta=0.1,
                                                     max_samples=3000),
                    "indicator"),
    "relative": (lambda m: m.RelativeErrorCondition(
        rtol=0.05, delta=0.1, scale=32.0, max_samples=4000), "moments"),
    "eccentricity": (lambda m: m.EccentricityGapCondition(gap=1,
                                                          max_samples=4000),
                     "cert"),
    "gradvar": (lambda m: m.GradVarianceCondition(rtol=0.05,
                                                  max_samples=4000),
                "moments"),
}


@pytest.mark.parametrize("case", sorted(CASES))
@pytest.mark.parametrize("seed", [0, 1])
def test_condition_matches_reference(case, seed):
    make, kind = CASES[case]
    jc, tc = make(js), make(ts)
    for num, data in _frames(kind, seed=100 * seed + sorted(CASES).index(case)):
        jstop, jaux = jc(_jax_frame(num, data))
        tstop, taux = tc(frame_from_numpy(np.int32(num), data, "cpu"))
        assert tstop.dtype == torch.bool and tstop.dim() == 0
        assert bool(tstop) == bool(jstop), (num, data)
        jflat, tflat = _flat(jaux), _flat(taux)
        assert sorted(jflat) == sorted(tflat)
        for k in jflat:
            np.testing.assert_allclose(tflat[k], jflat[k], rtol=1e-6, atol=1e-7,
                                       err_msg=k)


@pytest.mark.parametrize("case,num,data,stop", [
    # the static caps fire whatever the moments say
    ("percolation", 3000, {"s1": np.int32(1500), "s2": np.int32(1500)}, True),
    ("percolation", 100, {"s1": np.int32(50), "s2": np.int32(50)}, False),
    ("relative", 4000, {"s1": np.int32(0), "s2": np.int32(0)}, True),
    ("gradvar", 4000, {"s1": np.int32(0), "s2": np.int32(0)}, True),
    ("eccentricity", 10, {"cert": np.int32(1)}, True),
    ("eccentricity", 10, {"cert": np.int32(0)}, False),
    # below two samples the moment rules never stop
    ("bernstein", 1, {"s1": np.int32(0), "s2": np.int32(0)}, False),
    ("relative", 1, {"s1": np.int32(31), "s2": np.int32(961)}, False),
])
def test_condition_edges_match_reference(case, num, data, stop):
    make, _ = CASES[case]
    jstop, _ = make(js)(_jax_frame(num, data))
    tstop, _ = make(ts)(frame_from_numpy(np.int32(num), data, "cpu"))
    assert bool(tstop) == bool(jstop) == stop


def test_conditions_read_only_reduced_leaves_under_shared_frame():
    """A SHARED_FRAME shard holds the scalar leaves fully reduced and 1/F of
    the vector leaf; the verdict of every instance-layer condition is the
    same on a shard as on the full frame."""
    full = {"s1": np.int32(900), "s2": np.int32(21000),
            "hits": np.arange(8, dtype=np.int32), "cert": np.int32(0)}
    shard = dict(full, hits=full["hits"][:2])
    for case in ("percolation", "relative", "gradvar", "eccentricity"):
        cond = CASES[case][0](ts)
        a, _ = cond(frame_from_numpy(np.int32(1000), full, "cpu"))
        b, _ = cond(frame_from_numpy(np.int32(1000), shard, "cpu"))
        assert bool(a) == bool(b)
