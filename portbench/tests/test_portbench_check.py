"""What decides ``correct``, at a tiny size on the CPU: the plain reference
agrees with the port's sound runs, and ``correct`` comes out false for the
control (the reference in the port's place with path sampling that ignores
σ) and for each fault of the timed path a cell can have."""

import numpy as np
import pytest
import torch

from portbench import control
from portbench import graph as graph_mod
from portbench.reference import kadabra as ref_kadabra
from portbench.reference.graph import RefGraph
from portbench.run import run_cell
from portbench.spec import Bench

from .tiny import make_root


@pytest.fixture
def bench(tmp_path):
    return Bench.load(make_root(tmp_path))


def _graph(bench, config, seed):
    n, tuples = graph_mod.edge_tuples(bench, bench.config(config), seed, "cpu")
    csr = graph_mod.csr_from_tuples(n, tuples)
    return graph_mod.port_graph(csr), RefGraph(n, tuples, "cpu")


@pytest.mark.parametrize("config", ["urand-s9", "kron-s9"])
def test_reference_bfs_and_preprocessing_match_the_port(bench, config):
    from repro_torch.graphs import bfs, kadabra

    g, rg = _graph(bench, config, 9)
    gen = torch.Generator().manual_seed(1)
    s = torch.randint(0, g.n, (40,), generator=gen)
    t = torch.randint(0, g.n, (40,), generator=gen)
    for targets in (None, t):
        dist, sigma = bfs.bfs_sssp(g, s, targets, max_levels=g.n,
                                   early_exit=targets is not None, device="cpu")
        rdist, rsigma = rg.bfs(s, targets, max_levels=g.n)
        reached = dist != bfs.INF
        assert torch.equal(reached, rdist != np.iinfo(np.int32).max)
        assert torch.equal(dist[reached], rdist[reached])
        assert torch.equal(sigma, rsigma)
    for q in (0, 2**40 + 3):
        pre = kadabra.preprocess(g, 0.1, 0.1, seed=q, device="cpu")
        rpre = ref_kadabra.preprocess(rg, 0.1, 0.1, q)
        assert np.array_equal(pre.components.numpy(), rpre["components"])
        assert (pre.vd_upper, pre.diam_levels) == (rpre["vd_upper"],
                                                   rpre["diam_levels"])
        assert pre.omega == pytest.approx(rpre["omega"], rel=1e-12)


@pytest.mark.parametrize("traffic", ["local-w2", "indexed-w3"])
def test_reference_queries_match_the_port(bench, traffic):
    driver_mod = bench.module("queries", "kadabra")
    tr = bench.traffic(traffic)
    g, rg = _graph(bench, "kron-s9", 4)
    driver = driver_mod.Driver(g, tr, "cpu")
    for q in (7, 2**62 + 1):
        out = driver_mod.settle(driver.query(q)[1])
        ref = driver_mod.reference_output(rg, tr, q)
        assert driver_mod.compare(out, ref) == {
            "pre_mismatch": 0, "verdict_mismatch": 0, "count_gap_share": 0.0}


@pytest.mark.parametrize("cell", ["u.local", "u.indexed"])
def test_the_control_is_not_correct(bench, cell):
    """The reference with each predecessor drawn uniformly (σ ignored), in
    the port's place: on every seed some number passes its limit."""
    limits = bench.limits("kadabra")
    for seed in (1, 2, 3):
        line = control.readings(bench, cell, seed, 2, "cpu")
        assert all(v <= limits[k] for p in line["port"] for k, v in p.items())
        assert any(v > limits[k] for c in line["uniform"]
                   for k, v in c.items()), line


def test_a_vertex_diameter_bound_from_an_isolated_vertex_is_not_correct(bench):
    """The port's preprocessing bounds the vertex diameter by a double sweep
    in the component of v0 = q mod n alone.  On a Kron graph, which keeps
    its isolated vertices, a query whose v0 is isolated gets vd_upper 3
    while the largest component's shortest paths are longer: the check
    reads it on every query of the window."""
    from repro_torch.graphs import bfs

    driver_mod = bench.module("queries", "kadabra")
    g, rg = _graph(bench, "kron-s9", 4)
    degree = (g.indptr[1:] - g.indptr[:-1]).numpy()
    isolated = int(np.flatnonzero(degree == 0)[0])
    in_largest = int(np.bincount(rg.components()).argmax())
    driver = driver_mod.Driver(g, bench.traffic("local-w2"), "cpu")
    outs = [driver_mod.settle(driver.query(q)[1])
            for q in (isolated, in_largest, isolated + 7 * g.n)]
    short = [n["vd_bound_short"] for n in driver_mod.check_every(outs, rg)]
    assert outs[0]["vd_upper"] == 3 and short[0] > 0 and short[2] == short[0]
    assert short[1] == 0
    # a second witness, the port's own BFS: a shortest path in the largest
    # component has more vertices than vd_upper
    ecc = bfs.eccentricity(g, torch.tensor([in_largest]), max_levels=g.n,
                           device="cpu")
    assert int(ecc[0]) + 1 > outs[0]["vd_upper"]


def _unchanged_state(monkeypatch):
    import repro_torch.core.epoch as epoch

    monkeypatch.setattr(epoch, "combine", lambda a, b, op=None: a)


def _half_batch(monkeypatch):
    import repro_torch.graphs.kadabra as kadabra

    inner = kadabra.sample_path

    def half(*args, **kwargs):
        path = inner(*args, **kwargs)
        half = path.shape[0] // 2
        path[half:2 * half] = path[:half]
        return path

    monkeypatch.setattr(kadabra, "sample_path", half)


def _no_exchange(monkeypatch):
    """Each reduction over the workers keeps worker 0's frame alone: the sum
    of LOCAL_FRAME's deltas, INDEXED_FRAME's gathered frames."""
    import repro_torch.core.epoch as epoch
    import repro_torch.core.frames as frames

    inner = epoch.frame_at
    monkeypatch.setattr(frames, "_accum_leaf", lambda x: x[0].clone())
    monkeypatch.setattr(epoch, "frame_at", lambda stacked, w: inner(stacked, 0))


def _altered_answer(monkeypatch):
    import repro_torch.graphs.kadabra as kadabra

    inner = kadabra.sample_path

    def altered(g, gens, *args, **kwargs):
        """Each worker's first sample of a round: its path's vertices
        moved to the next vertex id."""
        path = inner(g, gens, *args, **kwargs)
        first = path[::path.shape[0] // len(gens)]
        path[::path.shape[0] // len(gens)] = torch.where(
            first < g.n, (first + 1) % g.n, first)
        return path

    monkeypatch.setattr(kadabra, "sample_path", altered)


@pytest.mark.parametrize("fault", [_unchanged_state, _half_batch,
                                   _no_exchange, _altered_answer])
@pytest.mark.parametrize("cell", ["u.local", "u.indexed"])
def test_a_broken_timed_path_is_not_correct(bench, monkeypatch, fault, cell):
    fault(monkeypatch)
    out = run_cell(bench, cell, 21, 0.2, trace=False, device="cpu")
    assert out["correct"] is False and out["failed"] >= 1, out["checks"]


def test_one_altered_path_a_worker_a_round_at_the_cells_batch_is_not_correct(
        bench, monkeypatch):
    """At the cells' 64 samples a worker a round, the altered answer moves
    the vertices of one path in 64, which Σ|b̃ − b̃_ref| / Σ b̃_ref counts
    where they left and where they arrived: above the limit, where a looser
    one (0.1) would let it pass."""
    _altered_answer(monkeypatch)
    out = run_cell(bench, "u.local-w16", 21, 0.2, trace=False, device="cpu")
    gap = out["checks"]["count_gap_share"]
    assert out["correct"] is False and gap["value"] > gap["limit"], gap
    assert 0.01 < gap["value"] < 0.1, gap


def test_a_traffic_file_the_driver_cannot_run_is_refused(bench):
    driver_mod = bench.module("queries", "kadabra")
    g, _ = _graph(bench, "urand-s9", 1)
    traffic = {**bench.traffic("local-w2"), "in_flight": 4}
    with pytest.raises(ValueError, match="in_flight"):
        driver_mod.Driver(g, traffic, "cpu")


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_short_run_of_each_cell_is_correct_on_the_card(card):
    from portbench.tests.tiny import ROOT

    bench = Bench.load(ROOT)
    for cell in bench.spec["workloads"]:
        out = run_cell(bench, cell["name"], 2**31 + 11, 2.0, trace=False,
                       device=card)
        assert out["correct"], (cell["name"], out["checks"])
        assert out["device"]["platform"] == "gpu"
