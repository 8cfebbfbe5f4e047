"""The port's serving subsystem: sessions, the epoch scheduler, elastic
re-sharding and placement.

Against the reference, on the same inputs and exactly: the placement pool
(lease/release/resize sequences, topology and pressure grammars), the
session specs, and the elastic regrouping of stacked frames.  These calls
are pure Python and numpy on the JAX side.

On the port itself, the reference's invariants (``tests/test_serve_*.py``,
the VMAP cases): save → restore → run and every reshard are bit-identical
to the uninterrupted run, the stepper is ``run_on_substrate``, the
scheduler's results equal solo sessions, and each estimate is within its
instance's ε of the oracle.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools
import json

import numpy as np

import repro.serve.elastic as jelastic
import repro.serve.placement as jplace
import repro.serve.session as jsession
from repro.core.adaptive import reassemble_shared as j_reassemble
from repro_torch.core.epoch import EpochConfig
from repro_torch.core.frames import FrameStrategy
from repro_torch.core.instances import get_instance, run_instance
from repro_torch.core.substrate import make_stepper, run_on_substrate
from repro_torch.kernels import ops
from repro_torch.serve import (AdaptiveSession, DevicePool, DeviceTopology,
                               EpochScheduler, PlacementWait, PressurePolicy,
                               SessionSpec, StepperCache, reshard_session)
from repro_torch.serve import elastic, placement

CPU = torch.device("cpu")
INSTANCE = "wrs"                    # stops within a handful of epochs
ELASTIC_INSTANCE = "reachability"   # 3 epochs at W=4: a real mid-run
CELLS = [("sequential", 1), ("vmap", 2)]
STRATEGIES = [s.value for s in FrameStrategy]

CACHE = StepperCache(CPU)           # one cache for the module, as a pool

WRS = SessionSpec("wrs", "local", world=2, seed=0)
TRI = SessionSpec("triangles", "local", world=2, seed=1)
REACH = SessionSpec("reachability", "local", world=2, seed=2)
SHARED4 = SessionSpec("reachability", "shared", world=4, substrate="vmap")


@functools.lru_cache(maxsize=None)
def reference(spec: SessionSpec):
    """The uninterrupted solo run of a spec: (estimate, result)."""
    return AdaptiveSession.create(spec, cache=CACHE).start().run().result()


def assert_same_result(got, ref):
    (est, res), (est_ref, res_ref) = got, ref
    assert res.num == res_ref.num
    assert res.epochs == res_ref.epochs
    assert res.stop_epoch == res_ref.stop_epoch
    np.testing.assert_array_equal(est, est_ref)
    for k in (res.data if isinstance(res.data, dict) else {"": 0}):
        a = res.data[k] if k else res.data
        b = res_ref.data[k] if k else res_ref.data
        np.testing.assert_array_equal(a, b)


def state_equal(a, b):
    """Two engine states hold the same values (generators by state)."""
    assert a.epoch == b.epoch and a.stop == b.stop
    assert a.stop_epoch == b.stop_epoch
    assert len(a.gens) == len(b.gens)
    for x, y in zip(a.gens, b.gens):
        assert torch.equal(x.get_state(), y.get_state())
    for fa, fb in ((a.total, b.total), (a.pending, b.pending)):
        assert torch.equal(fa.num, fb.num)
        da = fa.data if isinstance(fa.data, dict) else {"": fa.data}
        db = fb.data if isinstance(fb.data, dict) else {"": fb.data}
        assert da.keys() == db.keys()
        for k in da:
            assert torch.equal(da[k], db[k]), k


# ------------------------------------------------- placement vs reference

def _pool_trace(make_pool, seed, steps=200):
    """Drive one pool through a seeded lease/release/resize sequence and
    record every outcome (ids, or the PlacementWait's numbers)."""
    rng = np.random.default_rng(seed)
    pool, live, trace = make_pool(), [], []
    for _ in range(steps):
        op = rng.integers(0, 3)
        try:
            if op == 0 or not live:
                width = int(rng.integers(1, 6))
                prefer = None
                if rng.random() < 0.3:
                    prefer = tuple(int(i) for i in
                                   rng.choice(8, width, replace=False))
                lease = pool.lease(width, prefer=prefer)
                live.append(lease)
                trace.append(("lease", lease.lid, lease.ids))
            elif op == 1:
                lease = live.pop(int(rng.integers(0, len(live))))
                pool.release(lease)
                trace.append(("release", lease.lid))
            else:
                i = int(rng.integers(0, len(live)))
                new = pool.resize(live[i], int(rng.integers(1, 6)))
                live[i] = new
                trace.append(("resize", new.lid, new.ids))
        except (PlacementWait, jplace.PlacementWait) as e:
            trace.append(("wait", e.width, e.free))
        except ValueError as e:
            trace.append(("error", str(e)))
        trace.append(("free", pool.free_ids()))
    return trace


@pytest.mark.parametrize("topology", ["8", "2x4"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pool_sequences_equal_reference(topology, seed):
    mine = _pool_trace(
        lambda: DevicePool(DeviceTopology.parse(topology))
        if "x" in topology else DevicePool(8), seed)
    ref = _pool_trace(
        lambda: jplace.DevicePool(jplace.DeviceTopology.parse(topology))
        if "x" in topology else jplace.DevicePool(8), seed)
    assert mine == ref
    assert any(t[0] == "wait" for t in mine)


@pytest.mark.parametrize("spec", ["8", "2x4", " 3 ", "1x1", "0", "0x4",
                                  "2x0", "-1", "x4", "abc"])
def test_topology_parse_equals_reference(spec):
    def outcome(mod):
        try:
            return mod.DeviceTopology.parse(spec).groups
        except ValueError:
            return "ValueError"
    assert outcome(placement) == outcome(jplace)


@pytest.mark.parametrize("spec", ["none", "", "off", "shrink",
                                  "shrink-regrow", "shrink-regrow:min=2",
                                  "SHRINK:min=4", "grow", "shrink:max=2",
                                  "shrink:min=x"])
def test_pressure_policy_parse_equals_reference(spec):
    def outcome(mod):
        try:
            p = mod.PressurePolicy.parse(spec)
            return None if p is None else (p.min_world, p.regrow)
        except ValueError:
            return "ValueError"
    assert outcome(placement) == outcome(jplace)


def test_topology_from_host_on_the_cpu_is_one_slot(monkeypatch):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    assert DeviceTopology.from_host().groups == ((0,),)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert DeviceTopology.parse("auto").groups == ((0, 1, 2, 3),)
    assert placement.lease_devices([2, 0]) == [torch.device("cuda", 2),
                                               torch.device("cuda", 0)]
    with pytest.raises(RuntimeError, match="not present"):
        placement.lease_devices([4])


# ------------------------------------------------------ specs vs reference

SPEC_CASES = [
    dict(instance="wrs"),
    dict(instance="wrs", strategy="shared", world=2, logical_world=4),
    dict(instance="kadabra", strategy="indexed", world=4, seed=9,
         substrate="vmap", frame_shards=2),
    dict(instance="wrs", strategy="shared", world=2, substrate="shard_map",
         placement=[4, 5]),
    dict(instance="wrs", strategy="warp"),
    dict(instance="wrs", strategy="shared", world=3, logical_world=4),
    dict(instance="wrs", strategy="local", world=2, logical_world=4),
    dict(instance="wrs", strategy="shared", world=2, substrate="vmap",
         placement=[0, 1]),
    dict(instance="wrs", strategy="shared", world=2, substrate="shard_map",
         placement=[0]),
]


@pytest.mark.parametrize("case", SPEC_CASES)
def test_spec_validation_and_meta_equal_reference(case):
    def outcome(cls):
        try:
            s = cls(**case)
        except ValueError:
            return "ValueError"
        return (s.as_meta(), s.fold, s.stepper_key(),
                cls.from_meta(json.loads(json.dumps(s.as_meta()))) == s)
    assert outcome(SessionSpec) == outcome(jsession.SessionSpec)


@pytest.mark.parametrize("text", ["wrs:shared:4", "triangles:local:2:1",
                                  "kadabra:indexed", "wrs", "a:b:c:d:e",
                                  "wrs:local:x"])
def test_spec_parse_equals_reference(text):
    def outcome(cls):
        try:
            return cls.parse(text).as_meta()
        except ValueError:
            return "ValueError"
    assert outcome(SessionSpec) == outcome(jsession.SessionSpec)


# ---------------------------------------------------- elastic vs reference

@pytest.mark.parametrize("shape,new_world", [((4, 6), 2), ((4, 6), 1),
                                             ((2, 5, 3), 4), ((8,), 2),
                                             ((3, 7), 2), ((6, 2), 4)])
def test_redistribute_equals_reference(shape, new_world):
    rng = np.random.default_rng(sum(shape) + new_world)
    a = rng.integers(-2 ** 20, 2 ** 20, shape).astype(np.int32)
    got = elastic._redistribute(torch.from_numpy(a), new_world)
    exp = jelastic._redistribute(a, new_world)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("world,shards,new_world,n", [(4, 4, 2, 16),
                                                      (4, 2, 1, 8),
                                                      (4, 4, 4, 8),
                                                      (2, 2, 4, 8),
                                                      (4, 4, 2, 0)])
def test_rescatter_equals_reference(world, shards, new_world, n):
    """The consistent total re-cut for W′ workers is the reference's
    reassembly followed by W′ contiguous shards."""
    rng = np.random.default_rng(world * 10 + new_world)
    full = rng.integers(0, 1000, (n,)).astype(np.int32)
    parts = full.reshape(shards, -1) if n else np.zeros((shards, 0), np.int32)
    stacked = np.stack([parts[w % shards] for w in range(world)])
    got = elastic._rescatter(torch.from_numpy(stacked), world, shards,
                             new_world)
    exp = j_reassemble(stacked, world, shards)
    exp = exp.reshape(new_world, exp.shape[0] // new_world)
    np.testing.assert_array_equal(got.numpy(), exp)
    scalar = np.full((world,), 7, np.int32)
    np.testing.assert_array_equal(
        elastic._rescatter(torch.from_numpy(scalar), world, shards,
                           new_world).numpy(), np.full((new_world,), 7))


# ------------------------------------------------------------ the sessions

@pytest.mark.parametrize("substrate,world", CELLS)
@pytest.mark.parametrize("strategy", STRATEGIES)
def test_checkpoint_resume_bit_identical(tmp_path, strategy, substrate,
                                         world):
    spec = SessionSpec(INSTANCE, strategy, world=world, substrate=substrate)
    ref = reference(spec)
    assert ref[1].epochs >= 2, "need a mid-run epoch boundary"
    s = AdaptiveSession.create(spec, cache=CACHE).start()
    s.step()
    assert not s.done
    s.save(tmp_path)
    meta = json.loads(next(tmp_path.glob("step_*/manifest.json")).read_text())
    assert meta["meta"]["kind"] == "adaptive-session"
    assert meta["meta"]["device_type"] == "cpu"
    assert meta["leaves"]["gens"]["shape"] == [world, 5056]
    r = AdaptiveSession.restore(tmp_path, cache=CACHE)
    assert r.epoch == s.epoch and r.tau == s.tau
    state_equal(r.state, s.state)
    # the restored generators are copies: stepping one leaves the other
    assert all(x is not y for x, y in zip(r.state.gens, s.state.gens))
    assert_same_result(r.run().result(), ref)
    assert_same_result(s.run().result(), ref)


@pytest.mark.parametrize("strategy", STRATEGIES)
def test_stepper_equals_run_on_substrate(strategy):
    strat = FrameStrategy(strategy)
    built = get_instance(INSTANCE).build(world=2, strategy=strat, device=CPU)
    cfg = EpochConfig(strategy=strat, rounds_per_epoch=built.rounds_per_epoch,
                      max_epochs=built.max_epochs)
    args = (built.sample_fn, built.check_fn, built.template, None)
    stepper = make_stepper(*args, 2, cfg, substrate="vmap")
    for seed in (0, 5):                 # one stepper serves every seed
        a = stepper.run(seed)
        b = run_on_substrate(*args, seed, 2, cfg, substrate="vmap")
        state_equal(a, b)
        tmpl = stepper.state_template()
        assert tmpl.epoch == 0 and int(tmpl.total.num) == 0
    est, res, _ = run_instance(INSTANCE, strategy=strategy, world=2,
                               substrate="vmap", device=CPU)
    assert_same_result((est, res), reference(
        SessionSpec(INSTANCE, strategy, world=2, substrate="vmap")))


def test_restore_needs_only_the_directory(tmp_path):
    spec = SessionSpec(INSTANCE, "local", world=2, seed=3, substrate="vmap")
    s = AdaptiveSession.create(spec, cache=CACHE).start()
    s.step()
    s.save(tmp_path)
    r = AdaptiveSession.restore(tmp_path, device="cpu")
    assert r.spec == spec and r.epoch == s.epoch
    assert_same_result(r.run().result(), reference(spec))


def test_restore_empty_dir_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        AdaptiveSession.restore(tmp_path, device="cpu")


def test_restore_onto_the_other_device_type_raises(tmp_path):
    s = AdaptiveSession.create(WRS, cache=CACHE).start()
    s.save(tmp_path / "cpu")
    with pytest.raises(ValueError, match="cannot seed"):
        AdaptiveSession.restore(tmp_path / "cpu", device="cuda")
    s.save(tmp_path / "card")
    mf = next((tmp_path / "card").glob("step_*/manifest.json"))
    m = json.loads(mf.read_text())
    m["meta"]["device_type"] = "cuda"
    mf.write_text(json.dumps(m))
    with pytest.raises(ValueError, match="cannot seed"):
        AdaptiveSession.restore(tmp_path / "card", cache=CACHE)


def test_same_spec_sessions_interleaved_share_no_generators():
    spec = SessionSpec(ELASTIC_INSTANCE, "shared", world=4, substrate="vmap")
    a = AdaptiveSession.create(spec, cache=CACHE).start()
    b = AdaptiveSession.create(spec, cache=CACHE).start()
    assert not {id(g) for g in a.state.gens} & {id(g) for g in b.state.gens}
    while not (a.done and b.done):
        a.step()
        b.step()
        b.step()
    assert_same_result(a.result(), reference(spec))
    assert_same_result(b.result(), reference(spec))


def test_shard_map_session_needs_an_open_rank_pool():
    spec = SessionSpec(INSTANCE, "local", world=1, substrate="shard_map")
    with pytest.raises(RuntimeError, match="RankPool"):
        AdaptiveSession.create(spec, device="cpu")


@pytest.mark.parametrize("spec", [WRS, TRI, REACH, SHARED4,
                                  SessionSpec("wrs", "indexed", world=4,
                                              seed=1)])
def test_estimates_within_eps_of_oracle(spec):
    est, _ = reference(spec)
    built = CACHE.get(spec)[0]
    assert abs(float(est[0]) - float(built.oracle[0])) <= built.eps


# ---------------------------------------------------------------- elastic

@pytest.mark.parametrize("steps", [0, 1])
@pytest.mark.parametrize("new_world", [2, 1])
def test_elastic_reshard_matches_uninterrupted(new_world, steps, monkeypatch):
    """SHARED_FRAME W=4 → W′: the same (τ, estimate, data) as the
    uninterrupted W=4 run, shards of n/W′, and the fold's group sums go
    through ``ops.frame_accum`` on (k, W′·n) matrices."""
    ref = reference(SHARED4)
    s = AdaptiveSession.create(SHARED4, cache=CACHE).start()
    for _ in range(steps):
        s.step()
    assert not s.done
    r = reshard_session(s, new_world, cache=CACHE)
    assert r.spec.world == new_world and r.spec.logical_world == 4
    assert r.spec.fold == 4 // new_world and len(r.state.gens) == 4
    assert all(x is not y for x, y in zip(r.state.gens, s.state.gens))
    for k, leaf in r.state.total.data.items():
        old = s.state.total.data[k]
        if old.dim() > 1:
            assert tuple(leaf.shape) == (new_world, old.shape[1] * 4 // new_world)
    shapes = []
    accum = ops.frame_accum
    monkeypatch.setattr(ops, "frame_accum",
                        lambda f: shapes.append(tuple(f.shape)) or accum(f))
    assert_same_result(r.run().result(), ref)
    if steps == 0:                           # the resharded run samples
        k = 4 // new_world
        assert (k, new_world) in shapes      # the fold of num
        assert any(sh[0] == k and sh[1] > new_world for sh in shapes)


def test_elastic_chain_reshard():
    ref = reference(SHARED4)
    s = AdaptiveSession.create(SHARED4, cache=CACHE).start()
    s.step()
    mid = reshard_session(s, 2, cache=CACHE)
    up = reshard_session(mid, 4, cache=CACHE)
    final = reshard_session(reshard_session(up, 1, cache=CACHE), 2,
                            cache=CACHE)
    assert final.spec.fold == 2
    assert_same_result(final.run().result(), ref)


def test_elastic_checkpoint_roundtrip(tmp_path):
    ref = reference(SHARED4)
    s = AdaptiveSession.create(SHARED4, cache=CACHE).start()
    s.step()
    r = reshard_session(s, 2, cache=CACHE)
    r.save(tmp_path)
    r2 = AdaptiveSession.restore(tmp_path, cache=CACHE)
    assert r2.spec.fold == 2 and len(r2.state.gens) == 4
    assert_same_result(r2.run().result(), ref)


def test_elastic_rejects_invalid():
    s = AdaptiveSession.create(
        SessionSpec(INSTANCE, "local", world=2, substrate="vmap"),
        cache=CACHE).start()
    with pytest.raises(ValueError, match="SHARED_FRAME"):
        reshard_session(s, 1)
    sh = AdaptiveSession.create(SHARED4, cache=CACHE)
    with pytest.raises(ValueError, match="no state"):
        reshard_session(sh, 2)
    sh.start()
    with pytest.raises(ValueError, match="divide"):
        reshard_session(sh, 3)
    with pytest.raises(ValueError, match="INDEXED"):
        make_stepper(None, lambda f: (f.num > 0, {}),
                     torch.zeros(4, dtype=torch.int32), None, 2,
                     EpochConfig(strategy=FrameStrategy.INDEXED_FRAME),
                     fold=2)


# -------------------------------------------------------------- scheduler

def sched(**kw):
    return EpochScheduler(device=CPU, **kw)


def test_admission_policy_bounds_in_flight():
    s = sched(max_in_flight=2)
    for i, spec in enumerate([WRS, TRI, REACH, WRS]):
        s.submit(spec, qid=f"q{i}")
    seen = []
    while not s.idle:
        s.tick()
        seen.append(s.in_flight)
    assert max(seen) <= 2 and len(s.results) == 4
    waits = {qid: r.wait_ticks for qid, r in s.results.items()}
    assert waits["q0"] == 0 and waits["q1"] == 0
    assert waits["q2"] >= 1 and waits["q3"] >= 1


def test_results_bit_identical_to_solo_sessions():
    s = sched(max_in_flight=2)
    specs = {"a": WRS, "b": TRI, "c": REACH}
    for qid, spec in specs.items():
        s.submit(spec, qid=qid)
    s.drain()
    for qid, spec in specs.items():
        est, res = reference(spec)
        got = s.results[qid]
        assert got.stopped and got.tau == res.num and got.epochs == res.epochs
        np.testing.assert_array_equal(got.estimate, est)


def test_no_head_of_line_blocking():
    s = sched(max_in_flight=2)
    s.submit(REACH, qid="long")
    s.submit(WRS, qid="short")
    s.submit(TRI, qid="queued")
    events = s.drain()
    retire = {q: ev.tick for ev in events for q in ev.retired}
    admit = {q: ev.tick for ev in events for q in ev.admitted}
    assert retire["short"] < retire["long"]
    assert admit["queued"] == retire["short"] + 1


def test_tau_accounting_per_query():
    s = sched(max_in_flight=3)
    s.submit(WRS, qid="w")
    s.drain()
    r = s.results["w"]
    built = s.cache.get(WRS)[0]
    unit = built.samples_per_round * built.rounds_per_epoch * WRS.world
    assert r.tau > 0 and r.tau % unit == 0
    assert r.retired_tick >= r.admitted_tick >= r.submitted_tick
    assert r.wall_s > 0


def test_stepper_cache_shared_across_seeds():
    s = sched(max_in_flight=4)
    for seed in range(3):
        s.submit(dataclasses.replace(WRS, seed=seed))
    s.drain()
    assert len(s.results) == 3 and len(s.cache) == 1
    for r in s.results.values():
        est, res = reference(r.spec)
        assert r.tau == res.num
        np.testing.assert_array_equal(r.estimate, est)


def test_checkpoint_all_and_resume(tmp_path):
    queries = [("a", WRS), ("b", REACH), ("c", TRI)]
    s = sched(max_in_flight=2, checkpoint_dir=tmp_path)
    for qid, spec in queries:
        s.submit(spec, qid=qid)
    s.tick()
    s.save_all()
    done_early = dict(s.results)
    resumed = EpochScheduler.resume(tmp_path, max_in_flight=2, device=CPU)
    # "c", queued behind the checkpointed sessions, comes back from
    # queue.json
    assert [qid for qid, _ in resumed._queue] == ["a", "b", "c"]
    resumed.drain()
    merged = {**done_early, **resumed.results}
    assert set(merged) == {"a", "b", "c"}
    for qid, spec in queries:
        est, res = reference(spec)
        assert merged[qid].tau == res.num and merged[qid].epochs == res.epochs
        np.testing.assert_array_equal(merged[qid].estimate, est)


def test_resume_recovers_queries_without_session_checkpoints(tmp_path):
    s = sched(max_in_flight=1, checkpoint_dir=tmp_path)
    for qid, spec in [("a", WRS), ("b", TRI), ("c", REACH)]:
        s.submit(spec, qid=qid)
    s.tick()                   # admits only "a"; no session checkpoint
    assert (tmp_path / "queue.json").exists()
    resumed = EpochScheduler.resume(tmp_path, max_in_flight=2, device=CPU)
    resumed.drain()
    assert set(resumed.results) == {"a", "b", "c"}
    assert resumed.results["a"].tau == reference(WRS)[1].num


def test_resume_auto_ids_skip_restored_ids(tmp_path):
    s = sched(max_in_flight=1, checkpoint_dir=tmp_path)
    s.submit(WRS)
    s.tick()
    s.save_all()
    resumed = EpochScheduler.resume(tmp_path, max_in_flight=1, device=CPU)
    qid2 = resumed.submit(WRS)
    assert qid2 != "q000-wrs"
    resumed.drain()
    assert {"q000-wrs", qid2} <= set(resumed.results)


def test_scheduler_validation():
    with pytest.raises(ValueError):
        sched(max_in_flight=0)
    s = sched()
    s.submit(WRS, qid="dup")
    with pytest.raises(ValueError, match="duplicate"):
        s.submit(WRS, qid="dup")
    with pytest.raises(ValueError, match="never"):
        sched(pool=DevicePool(2)).submit(SHARED4)
    with pytest.raises(ValueError, match="pool"):
        sched(pressure=PressurePolicy())
    s = sched(max_in_flight=1, substrate="vmap")
    qid = s.submit(SessionSpec("wrs", "local", world=2))
    s.drain()
    assert s.results[qid].spec.substrate == "vmap"


# ------------------------------------------------------------------- pool

def test_admission_leases_disjoint_slots_and_releases_on_retire():
    pool = DevicePool(8)
    s = sched(max_in_flight=4, pool=pool)
    s.submit(SHARED4, qid="a")
    s.submit(dataclasses.replace(SHARED4, seed=1), qid="b")
    s.tick()
    leases = {qid: lease.ids for qid, lease in s._leases.items()}
    assert set(leases["a"]).isdisjoint(leases["b"]) and pool.free == 0
    s.drain()
    assert pool.free == 8
    assert s.results["a"].devices_leased == 4
    assert s.results["a"].tau == reference(SHARED4)[1].num
    np.testing.assert_array_equal(s.results["a"].estimate,
                                  reference(SHARED4)[0])


def test_placement_wait_is_accounted():
    s = sched(max_in_flight=8, pool=DevicePool(4))
    s.submit(SHARED4, qid="first")
    s.submit(WRS, qid="second")
    s.tick()
    assert s.in_flight == 1 and s.pending == 1
    s.drain()
    r = s.results["second"]
    assert 1 <= r.placement_wait_ticks <= r.wait_ticks


def test_pressure_shrink_admits_queued_query_bit_identical():
    est_ref, res_ref = reference(SHARED4)
    s = sched(max_in_flight=4, pool=DevicePool(4),
              pressure=PressurePolicy(min_world=1))
    s.submit(SHARED4, qid="A")
    s.submit(WRS, qid="B")
    events = s.drain()
    reshards = [e for ev in events for e in ev.resharded]
    assert ("A", 4, 2) in reshards
    admit = {q: ev.tick for ev in events for q in ev.admitted}
    assert admit["B"] == next(ev.tick for ev in events if ev.resharded)
    rA = s.results["A"]
    assert rA.spec.world == 2 and rA.devices_leased == 4
    assert rA.tau == res_ref.num
    np.testing.assert_array_equal(rA.estimate, est_ref)


def test_pressure_respects_min_world_and_strategy():
    s = sched(max_in_flight=4, pool=DevicePool(4),
              pressure=PressurePolicy(min_world=4))
    s.submit(SHARED4, qid="A")
    s.submit(WRS, qid="B")
    events = s.drain()
    assert not any(ev.resharded for ev in events)
    assert s.results["B"].placement_wait_ticks >= 1


@pytest.mark.parametrize("regrow", [True, False])
def test_pressure_regrow_on_drained_queue_bit_identical(regrow):
    est_ref, res_ref = reference(SHARED4)
    pool = DevicePool(4)
    s = sched(max_in_flight=4, pool=pool,
              pressure=PressurePolicy(min_world=1, regrow=regrow))
    s.submit(SHARED4, qid="A")
    s.tick()
    assert not s._active["A"].done
    s._resize("A", 2)
    assert pool.free == 2
    events = s.drain()
    reshards = [e for ev in events for e in ev.resharded]
    assert (("A", 2, 4) in reshards) == regrow
    rA = s.results["A"]
    assert rA.spec.world == (4 if regrow else 2)
    assert rA.tau == res_ref.num
    np.testing.assert_array_equal(rA.estimate, est_ref)


def test_resume_with_pool_releases_and_reacquires(tmp_path):
    est_ref, res_ref = reference(SHARED4)
    s = sched(max_in_flight=2, pool=DevicePool(8), checkpoint_dir=tmp_path)
    s.submit(SHARED4, qid="A")
    s.submit(WRS, qid="B")
    s.tick()
    s.save_all()
    resumed = EpochScheduler.resume(tmp_path, max_in_flight=2,
                                    pool=DevicePool(8), device=CPU)
    resumed.drain()
    assert set(resumed.results) == {"A", "B"}
    rA = resumed.results["A"]
    assert rA.tau == res_ref.num and rA.devices_leased == 4
    np.testing.assert_array_equal(rA.estimate, est_ref)
    assert resumed.pool.free == 8
    with pytest.warns(UserWarning, match="A"):
        narrow = EpochScheduler.resume(tmp_path, pool=DevicePool(2),
                                       device=CPU)
    assert narrow.unresumed == ["A"]


def test_pool_cli_drains_and_resumes(tmp_path, capsys):
    from repro_torch.launch.serve import main
    args = ["--pool", "--device", "cpu", "--topology", "4",
            "--pressure-policy", "shrink-regrow", "--checkpoint-dir",
            str(tmp_path), "--checkpoint-every", "1"]
    assert main(args) == 0
    first = capsys.readouterr().out
    assert "pool drained: 2 queries" in first
    assert main(args + ["--resume"]) == 0
    second = capsys.readouterr().out
    assert "resumed 2 session(s)" in second
    def retired(out):
        return sorted(line.split("retired ", 1)[1]
                      for line in out.splitlines() if "retired" in line)

    assert retired(first) == retired(second)
    assert main(["--pool", "--device", "cpu", "--pressure-policy",
                 "shrink"]) == 2
