"""The port's instance layer and conformance harness: the same registry and
the same oracles as the reference, each workload within its ε of the
oracle, and the full conformance grid (6 instances × 5 strategies ×
W ∈ {1, 2, 4}) with its cross invariants, on the CPU."""

import functools

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.core.instances as jinst
from repro_torch.configs.adaptive_instances import BENCH, CONFORMANCE
from repro_torch.core.conformance import run_all, run_conformance
from repro_torch.core.epoch import make_generator
from repro_torch.core.frames import FrameStrategy
from repro_torch.core.instances import (WeightedSamplingInstance,
                                        available_instances, get_instance,
                                        run_instance)

CPU = torch.device("cpu")
INSTANCES = ("kadabra", "triangles", "reachability", "wrs", "diameter",
             "gradvar")
WORLDS = (1, 2, 4)


EXTRA_SEEDS = (1, 2)


@functools.lru_cache(maxsize=None)
def report(name, seed=0):
    """One conformance sweep per instance and seed, shared by all asserts."""
    return run_conformance(name, worlds=WORLDS, seed=seed, device=CPU)


@functools.lru_cache(maxsize=None)
def reference_built(name):
    """The reference's built instance (its oracle and ε), once per module."""
    return jinst.get_instance(name).build(world=1)


def test_registry_names_equal_reference():
    assert available_instances() == jinst.available_instances() == \
        tuple(sorted(INSTANCES))


def test_presets_mirror_reference():
    from repro.configs import adaptive_instances as jcfg
    for mine, theirs in ((CONFORMANCE, jcfg.CONFORMANCE), (BENCH, jcfg.BENCH)):
        assert sorted(mine) == sorted(theirs)
        for k in mine:
            assert type(mine[k]).__name__ == type(theirs[k]).__name__
            assert vars(mine[k]) == vars(theirs[k]), k
    for name in INSTANCES:
        assert vars(get_instance(name)) == vars(jinst.get_instance(name))


@pytest.mark.parametrize("name", INSTANCES)
def test_oracle_and_tolerance_equal_reference(name):
    built = get_instance(name).build(world=1, device=CPU)
    ref = reference_built(name)
    np.testing.assert_array_equal(built.oracle, ref.oracle)
    assert (built.eps, built.delta, built.true_len, built.samples_per_round) \
        == (ref.eps, ref.delta, ref.true_len, ref.samples_per_round)


@pytest.mark.parametrize("name", INSTANCES)
def test_run_instance_within_eps(name):
    est, res, built = run_instance(name, device=CPU)
    assert res.stopped and res.num > 0
    assert est.shape == built.oracle.shape
    assert np.max(np.abs(est - built.oracle)) <= built.eps


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", list(FrameStrategy), ids=lambda s: s.name)
@pytest.mark.parametrize("name", INSTANCES)
def test_conformance_cell(name, strategy, world):
    """Termination, Prop.-1 τ unit, ε against the oracle and 2ε against the
    W=1 BARRIER run."""
    cell = next(c for c in report(name).cells
                if c.strategy == strategy and c.world == world)
    assert cell.ok, "\n".join(cell.failures)


@pytest.mark.parametrize("name", INSTANCES)
def test_conformance_cross_invariants(name):
    """INDEXED_FRAME bit-identity across W; SHARED reassembly == LOCAL."""
    rep = report(name)
    assert rep.ok, rep.summary()
    assert len(rep.cells) == 15


@pytest.mark.slow
@pytest.mark.parametrize("seed", EXTRA_SEEDS)
@pytest.mark.parametrize("name", INSTANCES)
def test_multi_seed_sweep(name, seed):
    """The full grid (every strategy × W, with the INDEXED determinism and
    SHARED reassembly cross checks) at seeds other than the default, as
    the reference's slow tier re-certifies it."""
    rep = report(name, seed)
    assert rep.ok, rep.summary()
    assert len(rep.cells) == 15


@pytest.mark.parametrize("name", INSTANCES)
def test_sample_fn_worker_streams_are_independent(name):
    """Worker w's delta depends on ``gens[w]`` alone — what makes
    INDEXED_FRAME's result the same for every W."""
    built = get_instance(name).build(world=3, device=CPU)
    gens = [make_generator(CPU, 11, k) for k in range(3)]
    delta, _ = built.sample_fn(gens, built.init_carry)
    alone, _ = built.sample_fn([make_generator(CPU, 11, 2)], built.init_carry)
    assert int(delta.num[2]) == int(alone.num[0]) == built.samples_per_round
    for k in (delta.data if isinstance(delta.data, dict) else [None]):
        a = alone.data if k is None else alone.data[k]
        d = delta.data if k is None else delta.data[k]
        assert torch.equal(a[0], d[2]), k


def test_shared_with_fewer_shards_equals_local():
    """SHARED_FRAME at W = 4 with F = 2 shards: the redundant groups agree
    and the reassembled dict frame equals the LOCAL_FRAME total."""
    _, loc, built = run_instance("wrs", strategy="local", world=4, device=CPU)
    _, sh, _ = run_instance("wrs", strategy="shared", world=4, frame_shards=2,
                            device=CPU)
    assert sh.num == loc.num
    for k in ("s1", "s2", "hist"):
        np.testing.assert_array_equal(built.trim(sh.data)[k],
                                      built.trim(loc.data)[k])


def test_unregistered_instance_runs_and_shard_map_is_queued():
    inst = WeightedSamplingInstance(name="wrs-small", n_items=64, batch=32)
    est, res, built = run_instance(inst, world=2, device=CPU)
    assert res.stopped and abs(est[0] - built.oracle[0]) <= built.eps
    with pytest.raises(KeyError):
        get_instance("wrs-small")
    # shard_map runs in a worker group; outside one it says how to launch
    with pytest.raises(RuntimeError, match="spawn_workers"):
        run_instance("wrs", world=2, substrate="shard_map", device=CPU)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_instance("wrs")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_conformance("wrs")
    with pytest.raises(RuntimeError, match="CUDA"):
        run_all()
    with pytest.raises(RuntimeError, match="CUDA"):
        get_instance("gradvar").build(world=1)
