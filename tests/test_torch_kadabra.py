"""KADABRA end to end in the port, held against the reference: equal
preprocessing on the same graph, (ε,δ) accuracy against exact Brandes for
the reference's six (strategy, W) cells, INDEXED_FRAME bit-identity across
W, τ in whole frame units, and SHARED == LOCAL reassembly."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.graphs as jg
from repro_torch.convert import graph_from_numpy, preprocessed_from_numpy
from repro_torch.core.frames import FrameStrategy as FS
from repro_torch.graphs import (KadabraParams, brandes_exact, erdos_renyi,
                                preprocess, run_kadabra)

CPU = torch.device("cpu")


def _arrays(g):
    return [np.asarray(a) for a in (g.indptr, g.indices_padded, g.src, g.dst)]


@pytest.fixture(scope="module")
def er_graph():
    """The graph of tests/test_kadabra.py, built by the reference and carried
    across, with its exact betweenness."""
    g = jg.erdos_renyi(60, 150, seed=1)
    tgr = graph_from_numpy(g.n, *_arrays(g), device=CPU)
    return g, tgr, brandes_exact(tgr)


def test_graph_round_trip(er_graph):
    g, tgr, _ = er_graph
    for a, b in zip(_arrays(g), (tgr.indptr, tgr.indices_padded, tgr.src, tgr.dst)):
        np.testing.assert_array_equal(a, b.numpy())
    assert (tgr.n, tgr.m_arcs, tgr.max_degree) == (g.n, g.m_arcs, g.max_degree)
    ported = erdos_renyi(60, 150, seed=1, device=CPU)
    for a, b in zip(_arrays(g), (ported.indptr, ported.indices_padded)):
        np.testing.assert_array_equal(a, b.numpy())


@pytest.mark.parametrize("kind", ["er", "grid", "ba"])
def test_preprocess_equal(kind):
    g = {"er": lambda: jg.erdos_renyi(80, 200, seed=2),
         "grid": lambda: jg.grid2d(5, 7),
         "ba": lambda: jg.barabasi_albert(70, 2, seed=4)}[kind]()
    jpre = jg.preprocess(g, eps=0.05, delta=0.1, seed=3)
    tpre = preprocess(graph_from_numpy(g.n, *_arrays(g), device=CPU), 0.05, 0.1,
                      seed=3, device=CPU)
    assert (tpre.vd_upper, tpre.diam_levels) == (jpre.vd_upper, jpre.diam_levels)
    assert tpre.omega == jpre.omega
    np.testing.assert_array_equal(tpre.components.numpy(), np.asarray(jpre.components))


PARAMS = KadabraParams(eps=0.05, delta=0.1, batch=32, rounds_per_epoch=2,
                       max_epochs=2000)


@pytest.mark.parametrize("strategy,world", [
    (FS.LOCK, 1), (FS.BARRIER, 4), (FS.LOCAL_FRAME, 1), (FS.LOCAL_FRAME, 4),
    (FS.SHARED_FRAME, 4), (FS.INDEXED_FRAME, 4)])
def test_eps_accuracy(er_graph, strategy, world):
    _, tgr, exact = er_graph
    btilde, res, _ = run_kadabra(tgr, PARAMS, strategy=strategy, world=world,
                                 seed=3, device=CPU)
    assert res.stopped
    err = np.abs(btilde - exact).max()
    assert err <= PARAMS.eps, f"{strategy} W={world}: max err {err} > ε"
    # Prop. 1: τ is a whole number of frame units
    rounds = 1 if strategy == FS.LOCK else PARAMS.rounds_per_epoch
    unit = PARAMS.batch * rounds
    if strategy in (FS.BARRIER, FS.LOCAL_FRAME, FS.SHARED_FRAME):
        unit *= world
    assert res.num % unit == 0


def test_indexed_bit_identical_across_world(er_graph):
    _, tgr, _ = er_graph
    runs = [run_kadabra(tgr, PARAMS, strategy=FS.INDEXED_FRAME, world=w,
                        seed=9, device=CPU) for w in (1, 2, 4)]
    for b, res, _ in runs[1:]:
        assert res.num == runs[0][1].num
        np.testing.assert_array_equal(b, runs[0][0])


@pytest.mark.parametrize("world,frame_shards", [(4, 0), (4, 2)])
def test_shared_reassembly_equals_local(er_graph, world, frame_shards):
    """Same worker streams ⇒ the glued SHARED_FRAME shards (also with F < W
    redundant groups) equal the LOCAL_FRAME total bit for bit."""
    from repro_torch.core.adaptive import run_adaptive
    from repro_torch.core.frames import shard_frame_pad
    from repro_torch.core.stopping import KadabraCondition
    from repro_torch.graphs.kadabra import frame_template, make_sample_fn

    _, tgr, _ = er_graph
    pre = preprocess(tgr, PARAMS.eps, PARAMS.delta, device=CPU)
    pad = shard_frame_pad(tgr.n, world)
    cond = KadabraCondition(eps=PARAMS.eps, delta=PARAMS.delta, omega=pre.omega,
                            n_vertices=tgr.n)
    out = {}
    for strat in ("local", "shared"):
        out[strat] = run_adaptive(make_sample_fn(tgr, pre, 16, pad_to=pad), cond,
                                  frame_template(tgr, pad), strategy=strat,
                                  world=world, seed=5, rounds_per_epoch=2,
                                  frame_shards=frame_shards if strat == "shared" else 0,
                                  device=CPU)
    assert out["shared"].num == out["local"].num
    assert out["shared"].stop_epoch == out["local"].stop_epoch
    np.testing.assert_array_equal(out["shared"].data, out["local"].data)


def test_reference_preprocessing_carried_across(er_graph):
    """The port runs on the reference's own Preprocessed, read out as numpy."""
    g, tgr, exact = er_graph
    jpre = jg.preprocess(g, eps=PARAMS.eps, delta=PARAMS.delta, seed=3)
    pre = preprocessed_from_numpy(jpre.omega, jpre.vd_upper,
                                  np.asarray(jpre.components), jpre.diam_levels,
                                  device=CPU)
    btilde, res, used = run_kadabra(tgr, PARAMS, strategy=FS.LOCAL_FRAME,
                                    world=2, seed=3, pre=pre, device=CPU)
    assert used is pre and res.stopped
    assert np.abs(btilde - exact).max() <= PARAMS.eps
