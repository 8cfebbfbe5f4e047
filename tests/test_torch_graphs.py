"""Graphs of the port against the reference: bit-identical generators,
exact BFS distances and component labels, allclose σ, equal Brandes, and
path sampling that is uniform over shortest paths (χ² test)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

import repro.graphs as jg
from repro.graphs.bfs import bfs_sssp as jax_bfs_sssp
from repro_torch import graphs as tg
from repro_torch.core.epoch import make_generator
from repro_torch.graphs.bfs import INF

CPU = torch.device("cpu")


def _arrays(g):
    return [np.asarray(a) for a in (g.indptr, g.indices_padded, g.src, g.dst)]


@pytest.mark.parametrize("kind", ["er", "ba", "grid"])
def test_generators_bit_identical(kind):
    build = {"er": lambda m: m.erdos_renyi(300, 900, seed=5),
             "ba": lambda m: m.barabasi_albert(200, 3, seed=2),
             "grid": lambda m: m.grid2d(7, 9)}[kind]
    jgr = build(jg)
    with_cpu = {"er": lambda: tg.erdos_renyi(300, 900, seed=5, device=CPU),
                "ba": lambda: tg.barabasi_albert(200, 3, seed=2, device=CPU),
                "grid": lambda: tg.grid2d(7, 9, device=CPU)}[kind]
    tgr = with_cpu()
    assert (tgr.n, tgr.m_arcs, tgr.max_degree) == (jgr.n, jgr.m_arcs, jgr.max_degree)
    for a, b in zip(_arrays(jgr), [x.numpy() for x in
                                   (tgr.indptr, tgr.indices_padded, tgr.src, tgr.dst)]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def graphs():
    """One ER and one grid graph, built by the reference; the port gets them
    through convert.graph_from_numpy."""
    from repro_torch.convert import graph_from_numpy
    out = {}
    for name, g in [("er", jg.erdos_renyi(120, 300, seed=3)), ("grid", jg.grid2d(6, 8))]:
        out[name] = (g, graph_from_numpy(g.n, *_arrays(g), device=CPU))
    return out


@pytest.mark.parametrize("name", ["er", "grid"])
@pytest.mark.parametrize("early_exit", [False, True])
def test_bfs_sssp_matches_reference(graphs, name, early_exit):
    jgr, tgr = graphs[name]
    rng = np.random.default_rng(7)
    s = rng.integers(0, jgr.n, 6).astype(np.int32)
    t = ((s + 1 + rng.integers(0, jgr.n - 1, 6)) % jgr.n).astype(np.int32)
    dist, sigma = tg.bfs_sssp(tgr, torch.from_numpy(s),
                              torch.from_numpy(t) if early_exit else None,
                              max_levels=jgr.n, early_exit=early_exit, device=CPU)
    for b in range(6):
        jd, js = jax_bfs_sssp(jgr, jnp.int32(s[b]),
                              jnp.int32(t[b]) if early_exit else None,
                              max_levels=jgr.n, early_exit=early_exit)
        np.testing.assert_array_equal(dist[b].numpy(), np.asarray(jd))
        np.testing.assert_allclose(sigma[b].numpy(), np.asarray(js), rtol=1e-5)


def test_sigma_cap_rescale_is_per_lane():
    """A lane whose σ overflows the cap is rescaled without touching the
    other lanes: a long chain of diamonds doubles σ at every level."""
    k = 110  # 2^110 > 1e30 shortest paths end to end
    edges = []
    for i in range(k):
        a, b, c, d = 3 * i, 3 * i + 1, 3 * i + 2, 3 * i + 3
        edges += [(a, b), (a, c), (b, d), (c, d)]
    n = 3 * k + 1
    jgr = jg.from_edges(n, np.array(edges))
    tgr = tg.from_edges(n, np.array(edges), device=CPU)
    s = torch.tensor([0, n - 1])
    dist, sigma = tg.bfs_sssp(tgr, s, None, max_levels=n, early_exit=False,
                              device=CPU)
    assert torch.isfinite(sigma).all() and sigma.max() <= 1e30
    for b in range(2):
        jd, js = jax_bfs_sssp(jgr, jnp.int32(int(s[b])), None, max_levels=n,
                              early_exit=False)
        np.testing.assert_array_equal(dist[b].numpy(), np.asarray(jd))
        np.testing.assert_allclose(sigma[b].numpy(), np.asarray(js), rtol=1e-5)


@pytest.mark.parametrize("name", ["er", "grid"])
def test_connected_components_exact(graphs, name):
    jgr, tgr = graphs[name]
    np.testing.assert_array_equal(
        tg.connected_components(tgr, device=CPU).numpy(),
        np.asarray(jg.connected_components(jgr)))


def test_connected_components_several_components():
    edges = np.array([(0, 1), (1, 2), (4, 5), (6, 7), (7, 8), (8, 6)])
    jgr, tgr = jg.from_edges(10, edges), tg.from_edges(10, edges, device=CPU)
    labels = tg.connected_components(tgr, device=CPU).numpy()
    np.testing.assert_array_equal(labels, np.asarray(jg.connected_components(jgr)))
    np.testing.assert_array_equal(labels, [0, 0, 0, 3, 4, 4, 6, 6, 6, 9])


@pytest.mark.parametrize("name", ["er", "grid"])
def test_eccentricity_matches_reference(graphs, name):
    jgr, tgr = graphs[name]
    s = [0, 5, jgr.n - 1]
    got = tg.eccentricity(tgr, torch.tensor(s), max_levels=jgr.n, device=CPU)
    exp = [int(jg.eccentricity(jgr, jnp.int32(v), max_levels=jgr.n)) for v in s]
    assert got.tolist() == exp


def test_brandes_equal(graphs):
    jgr, tgr = graphs["er"]
    np.testing.assert_array_equal(tg.brandes_exact(tgr), jg.brandes_exact(jgr))


def test_sample_path_uniform_over_shortest_paths():
    """On a 4×4 grid, corner to corner there are C(6,3) = 20 shortest paths;
    2000 draws (from W = 2 workers' streams) must be σ-uniform over them:
    χ² with 19 degrees of freedom below 43.8 (its 0.999 quantile)."""
    g = tg.grid2d(4, 4, device=CPU)
    W, B, draws = 2, 500, 2000
    s = torch.zeros(W * B, dtype=torch.long)
    t = torch.full((W * B,), 15, dtype=torch.long)
    dist, sigma = tg.bfs_sssp(g, s, t, max_levels=16, early_exit=True, device=CPU)
    assert float(sigma[0, 15]) == 20.0
    seen = {}
    for r in range(draws // (W * B)):
        gens = [make_generator(CPU, 99, r, w) for w in range(W)]
        path = tg.sample_path(g, gens, s, t, dist, sigma, max_len=7)
        for row in path.tolist():
            key = tuple(v for v in row if v != g.n)
            assert len(key) == 5  # 6 steps → 5 internal vertices
            seen[key] = seen.get(key, 0) + 1
    assert len(seen) == 20
    expected = draws / 20
    chi2 = sum((c - expected) ** 2 / expected for c in seen.values())
    assert chi2 < 43.8, chi2


def test_sample_path_unreachable_and_adjacent():
    edges = np.array([(0, 1), (1, 2), (3, 4)])
    g = tg.from_edges(5, edges, device=CPU)
    s, t = torch.tensor([0, 0, 0]), torch.tensor([3, 1, 2])
    dist, sigma = tg.bfs_sssp(g, s, t, max_levels=5, device=CPU)
    assert int(dist[0, 3]) == INF
    path = tg.sample_path(g, [make_generator(CPU, 1)], s, t, dist, sigma, max_len=4)
    assert path[0].tolist() == [5] * 4           # unreachable → empty
    assert path[1].tolist() == [5] * 4           # adjacent → no internal vertex
    assert sorted(path[2].tolist()) == [1, 5, 5, 5]
