"""The triangle, reachability, diameter and gradvar workloads of the port
against the reference, on the same graphs and the same numpy inputs:
integer and deterministic outputs are exact; frame templates match in
shape, type and padding."""

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.graphs as jg
import repro.graphs.diameter as jdiam
import repro.graphs.reachability as jreach
import repro.graphs.triangles as jtri
import repro.optim.adaptive as jopt
import repro.sampling as jsamp
import repro_torch.graphs.diameter as tdiam
import repro_torch.graphs.reachability as treach
import repro_torch.graphs.triangles as ttri
import repro_torch.optim.adaptive as topt
import repro_torch.sampling as tsamp
from repro_torch.convert import graph_from_numpy, instance_inputs_from_numpy

CPU = torch.device("cpu")


def _carry(g):
    """The reference's graph, carried across to the port."""
    arrays = [np.asarray(a) for a in (g.indptr, g.indices_padded, g.src, g.dst)]
    return graph_from_numpy(g.n, *arrays, device=CPU)


GRAPHS = {
    "ba": lambda: jg.barabasi_albert(40, 3, seed=2),
    "er": lambda: jg.erdos_renyi(64, 192, seed=4),
    "grid": lambda: jg.grid2d(5, 5),
    "grid3": lambda: jg.grid2d(3, 3),
    "er-split": lambda: jg.erdos_renyi(30, 25, seed=7),
}


@pytest.fixture(scope="module")
def graphs():
    return {k: (make(), _carry(make())) for k, make in GRAPHS.items()}


# ------------------------------------------------------------------ triangles
@pytest.mark.parametrize("kind", ["ba", "er", "grid"])
def test_wedges_and_triangles_exact(graphs, kind):
    g, t = graphs[kind]
    jw, jtot = jtri.wedge_weights(g)
    tw, ttot = ttri.wedge_weights(t)
    np.testing.assert_array_equal(tw, jw)
    assert ttot == jtot
    assert ttri.triangles_exact(t) == jtri.triangles_exact(g)


def test_triangle_estimate_equal():
    counts = np.random.default_rng(0).integers(0, 9, size=40)
    for num in (0, 1, 640, 12345):
        assert ttri.triangle_estimate(counts, num, 812.0) == \
            jtri.triangle_estimate(counts, num, 812.0)


def test_wedge_sample_fn_closes_only_real_wedges(graphs):
    """Every sampled centre has degree ≥ 2 and the closed count at a vertex
    never exceeds the samples drawn there; with 4 workers × 4096 wedges the
    closure probability is within 4σ of 3T/W."""
    from repro_torch.core.epoch import make_generator
    _, t = graphs["ba"]
    w, w_total = ttri.wedge_weights(t)
    fn = ttri.make_wedge_sample_fn(t, 4096, pad_to=44)
    delta, _ = fn([make_generator(CPU, 3, k) for k in range(4)], None)
    counts = delta.data
    assert counts.shape == (4, 44) and counts.dtype == torch.int32
    assert not counts[:, 40:].any()
    assert not counts[:, :40][:, torch.from_numpy(w == 0)].any()
    p = 3 * ttri.triangles_exact(t) / w_total
    p_hat = float(counts.sum()) / (4 * 4096)
    assert abs(p_hat - p) <= 4 * np.sqrt(p * (1 - p) / (4 * 4096))


# --------------------------------------------------------------- reachability
@pytest.mark.parametrize("kind", ["grid3", "grid", "er-split"])
def test_arc_edge_ids_equal(graphs, kind):
    g, t = graphs[kind]
    jids, jm = jreach.arc_edge_ids(g)
    tids, tm = treach.arc_edge_ids(t)
    np.testing.assert_array_equal(tids, jids)
    assert tm == jm


@pytest.mark.parametrize("kind,s", [("grid3", 0), ("grid", 12), ("er-split", 3)])
def test_reached_masked_equal_on_the_same_masks(graphs, kind, s):
    g, t = graphs[kind]
    ids, m = jreach.arc_edge_ids(g)
    rng = np.random.default_rng(len(kind))
    masks = rng.random((12, m)) < np.linspace(0.2, 1.0, 12)[:, None]
    inp = instance_inputs_from_numpy(CPU, arc_ids=ids, masks=masks)
    got = treach.reached_masked(t, inp["arc_ids"], inp["masks"], s)
    assert got.dtype == torch.bool and got.shape == (12, g.n)
    jfn = jax.jit(lambda a: jreach.reached_masked(g, jnp.asarray(ids), a,
                                                  jnp.int32(s)))
    for b in range(12):
        np.testing.assert_array_equal(got[b].numpy(),
                                      np.asarray(jfn(jnp.asarray(masks[b]))))


def test_reachability_exact_equal(graphs):
    g, t = graphs["grid3"]
    for s, tt, pi in [(0, 8, 0.7), (0, 4, 0.5), (2, 6, 0.9)]:
        assert treach.reachability_exact(t, s, tt, pi) == \
            jreach.reachability_exact(g, s, tt, pi)


# ------------------------------------------------------------------- diameter
@pytest.mark.parametrize("kind", ["grid", "er", "ba", "er-split"])
def test_diameter_exact_equal(graphs, kind):
    g, t = graphs[kind]
    assert tdiam.diameter_exact(t) == jdiam.diameter_exact(g)


@pytest.mark.parametrize("kind", ["grid", "er", "er-split"])
def test_double_sweep_equal_from_the_same_starts(graphs, kind):
    g, t = graphs[kind]
    starts = np.arange(0, g.n, max(1, g.n // 10))
    ecc_v, ecc_u = tdiam.double_sweep(t, torch.from_numpy(starts),
                                      max_levels=g.n)
    assert ecc_v.dtype == ecc_u.dtype == torch.int32
    jfn = jax.jit(lambda v: jdiam.double_sweep(g, v, max_levels=g.n))
    for k, v in enumerate(starts):
        jv, ju = jfn(jnp.int32(v))
        assert (int(ecc_v[k]), int(ecc_u[k])) == (int(jv), int(ju)), v


def test_diameter_estimate_equal():
    for hist in (np.zeros(9), np.array([0, 3, 0, 1, 0]), np.array([2, 0, 0])):
        assert tdiam.diameter_estimate(hist) == jdiam.diameter_estimate(hist)


# -------------------------------------------------------------------- gradvar
@pytest.mark.parametrize("n,dim,seed", [(256, 8, 5), (1 << 14, 32, 5),
                                        (100, 3, 11)])
def test_quantized_grad_norms_equal(n, dim, seed):
    jq, jmu = jopt.quantized_grad_norms(n, dim, seed, 32)
    tq, tmu = topt.quantized_grad_norms(n, dim, seed, 32)
    np.testing.assert_array_equal(tq, jq)
    assert tq.dtype == np.int32 and tmu == jmu


def test_gradnorm_sample_fn_counts_its_draws():
    from repro_torch.core.epoch import make_generator
    gq, _ = topt.quantized_grad_norms(50, 4, 1, 32)
    fn = topt.make_gradnorm_sample_fn(torch.from_numpy(gq), 300, pad_to=52)
    delta, _ = fn([make_generator(CPU, 0, k) for k in range(2)], None)
    hits = delta.data["hits"]
    assert hits.shape == (2, 52) and hits.sum(dim=1).tolist() == [300, 300]
    g = torch.from_numpy(gq).long()
    assert delta.data["s1"].tolist() == (hits[:, :50] * g).sum(dim=1).tolist()
    assert delta.data["s2"].tolist() == (hits[:, :50] * g * g).sum(dim=1).tolist()


# ------------------------------------------------------------------ templates
def _shape_types(tmpl):
    if isinstance(tmpl, dict):
        return {k: (tuple(v.shape), str(v.dtype).replace("torch.", ""))
                for k, v in tmpl.items()}
    return (tuple(tmpl.shape), str(tmpl.dtype).replace("torch.", ""))


@pytest.mark.parametrize("pad", [None, 12, 28])
def test_frame_templates_match(graphs, pad):
    g, t = graphs["grid3"]
    pairs = [
        (jreach.frame_template(g, pad), treach.frame_template(t, pad)),
        (jdiam.frame_template(g, pad), tdiam.frame_template(t, pad)),
        (jsamp.weighted_frame_template(9, pad),
         tsamp.weighted_frame_template(9, pad, device=CPU)),
        (jopt.gradnorm_frame_template(9, pad or 9),
         topt.gradnorm_frame_template(9, pad or 9, device=CPU)),
    ]
    for jt, tt in pairs:
        assert _shape_types(tt) == _shape_types(jt)
        for v in (tt.values() if isinstance(tt, dict) else [tt]):
            assert not v.any()
