"""The pool's process-group sessions: shard_map sessions on a persistent
pool of gloo CPU ranks (``RankPool``), against the port's VMAP and
SEQUENTIAL sessions of the same spec and against the reference.

* Every strategy at W ∈ {1, 2, 4} (and SHARED at F = 2 < W = 4): τ,
  estimate and ``stop_epoch`` bit-equal to VMAP (and SEQUENTIAL at W = 1),
  each estimate within ε of the reference's oracle.
* The reference's three placement checks (``tests/test_serve_placement.py``
  ``_CHECKS_8DEV``) at half width: disjoint placements (0, 1) and (2, 3)
  with two cache entries, a pressure shrink W 2 → 1 that keeps (0,), and a
  resume that re-leases equivalent ranks.
* A shard_map checkpoint equals a VMAP session's leaf for leaf (generators
  included) and restores on either substrate; ``pull(push(t)) == t``.
* The failure contract: a rank that raises or dies fails the call within
  the timeout, and every rank is reaped.
* The ``--pool --substrate shard_map`` CLI and its ``--resume``.
* ``optim/compress.py`` against the reference's: the shared scale bit for
  bit (the reference's ``pmax`` read under ``jax.vmap``), the bounds, error
  feedback, and the collectives each leaf issues.
"""

import pytest

torch = pytest.importorskip("torch")

import dataclasses
import functools
import re
import time

import jax
import jax.numpy as jnp
import numpy as np

from repro.core import instances as jinstances
from repro.optim import compress as jcompress
from repro_torch.checkpoint.manager import load_checkpoint, read_meta
from repro_torch.core.epoch import held_tree, join_held, map_tree
from repro_torch.core.frames import FrameStrategy
from repro_torch.launch import serve as serve_cli
from repro_torch.launch import spawn
from repro_torch.launch.spawn import RankPool
from repro_torch.optim.compress import (compress_on_rank, dequantize_int8,
                                        quantize_int8)
from repro_torch.serve import (AdaptiveSession, DevicePool, EpochScheduler,
                               PressurePolicy, SessionSpec, StepperCache,
                               reshard_session)
from repro_torch.serve.ranks import held_by_ranks, make_groups

CPU = torch.device("cpu")
N_RANKS = 4
TIMEOUT = 120.0
INSTANCES = ("reachability", "wrs")
CELLS = [(s.value, w, 0) for s in FrameStrategy for w in (1, 2, 4)] + \
    [("shared", 4, 2)]
VMAP = StepperCache(CPU)
SHARED2 = SessionSpec("reachability", "shared", world=2, substrate="shard_map")


@pytest.fixture(scope="module")
def ranks(request):
    pool = RankPool(N_RANKS, backend="gloo", device="cpu", timeout=TIMEOUT)
    request.addfinalizer(pool.close)
    return pool


@pytest.fixture(scope="module")
def cache(ranks):
    return StepperCache(CPU, ranks=ranks)


def vmap_spec(spec: SessionSpec, substrate="vmap") -> SessionSpec:
    return dataclasses.replace(spec, substrate=substrate, placement=None)


@functools.lru_cache(maxsize=None)
def solo(spec: SessionSpec):
    """The uninterrupted VMAP session of a spec: (estimate, result)."""
    return AdaptiveSession.create(vmap_spec(spec), cache=VMAP).start().run() \
        .result()


@functools.lru_cache(maxsize=None)
def reference_oracle(name: str):
    built = jinstances.get_instance(name).build(world=1)
    return np.asarray(built.oracle), float(built.eps)


def assert_same(got, ref):
    (est, res), (ref_est, ref_res) = got, ref
    assert (res.num, res.stop_epoch, res.epochs, res.stopped) == \
        (ref_res.num, ref_res.stop_epoch, ref_res.epochs, ref_res.stopped)
    np.testing.assert_array_equal(est, ref_est)


def leaves(tree) -> list:
    out = []
    map_tree(lambda x: out.append(np.asarray(x)), tree)
    return out


def assert_same_tree(a, b):
    la, lb = leaves(a), leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        np.testing.assert_array_equal(x, y)


# ------------------------------------------------------------- equivalence


@pytest.mark.parametrize("instance", INSTANCES)
@pytest.mark.parametrize("strategy,world,shards", CELLS)
def test_pool_session_equals_vmap(ranks, cache, instance, strategy, world,
                                  shards):
    spec = SessionSpec(instance, strategy, world=world, frame_shards=shards,
                       substrate="shard_map")
    session = AdaptiveSession.create(spec, cache=cache)
    assert session.on_ranks and session.built is None
    got = session.start().run().result()
    session.close()
    assert_same(got, solo(spec))
    if world == 1:
        seq = AdaptiveSession.create(vmap_spec(spec, "sequential"),
                                     cache=VMAP).start().run().result()
        assert_same(got, seq)
    oracle, eps = reference_oracle(instance)
    assert abs(float(got[0][0]) - float(oracle[0])) <= eps


def test_step_replies_carry_done_epoch_and_tau(ranks, cache):
    session = AdaptiveSession.create(SHARED2, cache=cache).start()
    sent = []
    real = ranks.send

    def counted(*a, **kw):
        sent.append(a[0].__name__)
        return real(*a, **kw)

    ranks.send = counted
    try:
        while not session.done:
            session.step()
            assert session.epoch >= 2 and session.tau > 0
    finally:
        ranks.send = real
    assert set(sent) == {"step"}
    assert session.tau == solo(SHARED2)[1].num
    session.close()


def test_retired_sessions_free_their_rank_state(ranks, cache):
    before = held_by_ranks(ranks)
    sched = EpochScheduler(max_in_flight=2, pool=DevicePool(N_RANKS),
                           device=CPU, ranks=ranks)
    sched.submit(SHARED2)
    sched.submit(dataclasses.replace(SHARED2, strategy="local", seed=1))
    sched.drain()
    assert held_by_ranks(ranks) == before


# ----------------------------------------- the reference's placement checks


def test_concurrent_disjoint_placements(ranks):
    sched = EpochScheduler(max_in_flight=4, pool=DevicePool(N_RANKS),
                           device=CPU, ranks=ranks)
    sched.submit(SHARED2, qid="a")
    sched.submit(SHARED2, qid="b")      # same shape, same seed — same answer
    sched.tick()
    assert sched._active["a"].spec.placement == (0, 1)
    assert sched._active["b"].spec.placement == (2, 3)
    assert len(sched.cache) == 2, "same shape, disjoint placements: two " \
        "entries"
    sched.drain()
    for qid in ("a", "b"):
        r = sched.results[qid]
        assert (r.tau, r.stop_epoch) == (solo(SHARED2)[1].num,
                                         solo(SHARED2)[1].stop_epoch)
        np.testing.assert_array_equal(r.estimate, solo(SHARED2)[0])
        assert r.devices_leased == 2


def test_pressure_shrink_keeps_the_leading_rank(ranks):
    sched = EpochScheduler(max_in_flight=4, pool=DevicePool(N_RANKS),
                           pressure=PressurePolicy(min_world=1), device=CPU,
                           ranks=ranks)
    sched.submit(SHARED2, qid="A")
    # another W=2 session so the pool stays full when C arrives
    sched.submit(dataclasses.replace(SHARED2, seed=1), qid="B")
    sched.submit(SessionSpec("wrs", "local", world=1, substrate="shard_map"),
                 qid="C")
    events = sched.drain()
    reshards = [e for ev in events for e in ev.resharded]
    assert ("A", 2, 1) in reshards, reshards
    rA = sched.results["A"]
    assert rA.spec.world == 1 and rA.spec.placement == (0,)
    assert rA.tau == solo(SHARED2)[1].num
    np.testing.assert_array_equal(rA.estimate, solo(SHARED2)[0])
    assert sched.results["C"].placement_wait_ticks >= 1


def test_resume_releases_equivalent_ranks(ranks, tmp_path):
    sched = EpochScheduler(max_in_flight=4, pool=DevicePool(N_RANKS),
                           checkpoint_dir=tmp_path, device=CPU, ranks=ranks)
    sched.submit(SHARED2, qid="x")
    sched.submit(SHARED2, qid="y")
    sched.tick()
    assert sched._active["y"].spec.placement == (2, 3)
    sched.save_all()
    # a fresh pool with rank 2 taken: y cannot get its recorded ranks back
    # and is re-leased equivalent ones
    pool2 = DevicePool(N_RANKS)
    blocker = pool2.lease(1, prefer=(2,))
    resumed = EpochScheduler.resume(tmp_path, max_in_flight=4, pool=pool2,
                                    device=CPU, ranks=ranks)
    resumed.drain()
    for qid in ("x", "y"):
        r = resumed.results[qid]
        assert r.tau == solo(SHARED2)[1].num
        np.testing.assert_array_equal(r.estimate, solo(SHARED2)[0])
    py = resumed.results["y"].spec.placement
    assert py is not None and set(py).isdisjoint(blocker.ids), py
    assert resumed.results["x"].spec.placement == (0, 1)


def test_shrink_regrow_with_checkpoints_matches_solo(ranks, tmp_path):
    wide = SessionSpec("reachability", "shared", world=4,
                       substrate="shard_map")
    narrow = SessionSpec("wrs", "local", world=2, substrate="shard_map")
    sched = EpochScheduler(max_in_flight=2, pool=DevicePool(N_RANKS),
                           pressure=PressurePolicy.parse("shrink-regrow"),
                           checkpoint_dir=tmp_path, checkpoint_every=1,
                           device=CPU, ranks=ranks)
    sched.submit(wide, qid="w")
    sched.submit(narrow, qid="n")
    events = sched.drain()
    assert ("w", 4, 2) in [e for ev in events for e in ev.resharded]
    for qid, spec in (("w", wide), ("n", narrow)):
        r, (est, res) = sched.results[qid], solo(spec)
        assert (r.tau, r.stop_epoch, r.epochs) == \
            (res.num, res.stop_epoch, res.epochs)
        np.testing.assert_array_equal(r.estimate, est)


# ------------------------------------------------ checkpoints, pull / push


@pytest.mark.parametrize("strategy,world,shards",
                         [("shared", 4, 2), ("local", 2, 0),
                          ("indexed", 4, 0), ("lock", 1, 0)])
def test_checkpoint_equals_vmap_and_restores_on_either(cache, tmp_path,
                                                       strategy, world,
                                                       shards):
    spec = SessionSpec("reachability", strategy, world=world,
                       frame_shards=shards, substrate="shard_map")
    s = AdaptiveSession.create(spec, cache=cache).start()
    v = AdaptiveSession.create(vmap_spec(spec), cache=VMAP).start()
    s.step()
    v.step()
    e = s.epoch
    assert e == v.epoch and not s.done
    s.save(tmp_path / "s")
    v.save(tmp_path / "v")
    ts, _ = load_checkpoint(s.state_template(), tmp_path / "s", e)
    tv, _ = load_checkpoint(v.state_template(), tmp_path / "v", e)
    assert_same_tree(ts, tv)            # generators included
    ms, mv = read_meta(tmp_path / "s", e), read_meta(tmp_path / "v", e)
    assert set(ms) == set(mv)
    assert (ms["tau"], ms["device_type"]) == (mv["tau"], mv["device_type"])
    on_vmap = AdaptiveSession.restore(tmp_path / "s", cache=VMAP,
                                      substrate="vmap")
    on_ranks = AdaptiveSession.restore(tmp_path / "v", cache=cache,
                                       substrate="shard_map")
    assert not on_vmap.on_ranks and on_ranks.on_ranks
    for session in (on_vmap, on_ranks, s):
        assert_same(session.run().result(), solo(spec))
    on_ranks.close()
    s.close()


def test_pull_of_push_is_the_identity(cache):
    spec = SessionSpec("reachability", "shared", world=4, frame_shards=2,
                       substrate="shard_map")
    s = AdaptiveSession.create(spec, cache=cache).start()
    s.step()
    tree = s.tree()
    assert tree.gens.shape[0] == 4 and tree.pending.num.shape == (4,)
    s.load_tree(tree)
    assert_same_tree(s.tree(), tree)
    assert_same(s.run().result(), solo(spec))
    s.close()


@pytest.mark.parametrize("strategy,fold", [("shared", 2), ("local", None),
                                           ("indexed", None)])
def test_held_rows_join_back_into_the_tree(strategy, fold):
    """join_held ∘ held_tree is the identity on a VMAP tree, folded
    streams included (each worker's k generators stay together)."""
    spec = SessionSpec("reachability", strategy, world=2,
                       logical_world=4 if fold else 0, substrate="vmap")
    v = AdaptiveSession.create(spec, cache=VMAP).start()
    v.step()
    tree = v.tree()
    shared = strategy == "shared"
    assert tree.gens.shape[0] == 2 * (fold or 1)
    parts = [held_tree(tree, (w,), fold, shared) for w in range(2)]
    assert parts[1].gens.shape[0] == (fold or 1)
    assert_same_tree(join_held(parts, fold, shared), tree)


@pytest.mark.parametrize("placement", [(2, 3), (3,), None])
def test_reshard_onto_other_ranks_matches_uninterrupted(cache, placement):
    spec = SessionSpec("reachability", "shared", world=4,
                       substrate="shard_map")
    s = AdaptiveSession.create(spec, cache=cache).start()
    s.step()
    new_world = 2 if placement is None else len(placement)
    r = reshard_session(s, new_world, cache=cache, placement=placement,
                        substrate="shard_map")
    s.close()
    assert r.on_ranks and r.spec.world == new_world
    est, res = r.run().result()
    assert (res.num, res.stop_epoch) == (solo(spec)[1].num,
                                         solo(spec)[1].stop_epoch)
    np.testing.assert_array_equal(est, solo(spec)[0])
    r.close()


def test_rebind_moves_the_state_to_other_ranks(cache):
    spec = dataclasses.replace(SHARED2, placement=(0, 1))
    s = AdaptiveSession.create(spec, cache=cache).start()
    s.step()
    s.rebind_placement((3, 1), cache=cache)
    assert s.spec.placement == (3, 1) and s.stepper.ids == (1, 3)
    assert_same(s.run().result(), solo(SHARED2))
    s.close()


def test_without_a_rank_pool_shard_map_raises_saying_how_to_start_one():
    with pytest.raises(RuntimeError, match="RankPool"):
        AdaptiveSession.create(SHARED2, cache=StepperCache(CPU))


# ----------------------------------------------------- the failure contract


def _reaped(pool) -> list:
    procs = list(pool._procs)
    return procs


def test_a_rank_that_raises_fails_the_call_and_kills_the_pool():
    pool = RankPool(2, device="cpu", timeout=30)
    procs = _reaped(pool)
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised"):
        pool.call(spawn.raise_on, 1)
    assert pool.closed and not any(p.is_alive() for p in procs)
    with pytest.raises(RuntimeError, match="closed"):
        pool.call(spawn.rank_info)


def test_a_rank_killed_mid_call_fails_it_before_the_timeout():
    pool = RankPool(2, device="cpu", timeout=60)
    procs = _reaped(pool)
    ticket = pool.send(spawn.sleep, 30.0)
    procs[1].kill()
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 exited"):
        pool.wait(ticket)
    assert time.monotonic() - t0 < 20
    assert not any(p.is_alive() for p in procs)


def test_a_session_on_a_killed_rank_raises():
    pool = RankPool(2, device="cpu", timeout=60)
    procs = _reaped(pool)
    cache = StepperCache(CPU, ranks=pool)
    s = AdaptiveSession.create(SHARED2, cache=cache).start()
    procs[0].kill()
    procs[0].join()
    with pytest.raises(RuntimeError, match=r"rank\(s\) \[0\] of 2 exited"):
        s.step()
    assert pool.closed and not any(p.is_alive() for p in procs)


def test_a_reply_past_the_timeout_kills_every_rank():
    pool = RankPool(2, device="cpu", timeout=2)
    procs = _reaped(pool)
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="no reply"):
        pool.call(spawn.sleep, 30.0)
    assert time.monotonic() - t0 < 10
    assert not any(p.is_alive() for p in procs)


def test_close_reaps_every_rank_and_the_context_sets_the_current_pool():
    with RankPool(2, device="cpu", timeout=30) as pool:
        assert spawn.current_rank_pool() is pool
        procs = _reaped(pool)
        assert pool.call(spawn.rank_info, ranks=(1,)) == \
            [(1, 2, "gloo", "cpu")]
    assert spawn.current_rank_pool() is None
    assert not any(p.is_alive() for p in procs)


# ------------------------------------------------------------------- CLI


def test_cli_shard_map_pool_then_resume(tmp_path, capsys):
    argv = ["--pool", "--substrate", "shard_map", "--topology", "4",
            "--device", "cpu", "--pressure-policy", "shrink-regrow",
            "--queries", "reachability:shared:4,wrs:local:2",
            "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "1"]
    assert serve_cli.main(argv) == 0
    first = capsys.readouterr().out
    assert "rank pool: 4 gloo rank(s) on cpu" in first
    assert serve_cli.main(argv + ["--resume", "--queries", ""]) == 0
    second = capsys.readouterr().out

    def retired(out):
        return {m.group(1): (m.group(2), m.group(3)) for m in re.finditer(
            r"retired (\S+) τ=(\d+) .* est=(.*)", out)}

    assert retired(first) and retired(second) == retired(first)
    assert spawn.current_rank_pool() is None


# ------------------------------------------------------------- compress


def _rows(world, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": (rng.standard_normal((world, 256)) * 3).astype(np.float32),
            "b": rng.standard_normal((world, 8, 4)).astype(np.float32)}


def test_int8_quantization_bounded_error():
    x = np.asarray(jax.random.normal(jax.random.key(0), (1000,)) * 3.0)
    gen = torch.Generator().manual_seed(1)
    q, scale = quantize_int8(torch.from_numpy(x.copy()), gen)
    assert q.dtype == torch.int8
    err = np.abs(dequantize_int8(q, scale).numpy() - x)
    assert err.max() <= float(scale) * 1.01
    _, jscale = jcompress.quantize_int8(jnp.asarray(x), jax.random.key(1))
    assert np.float32(scale) == np.float32(jscale)     # bit for bit


@functools.lru_cache(maxsize=None)
def on_ranks(pool, world, steps=1):
    ids = tuple(range(N_RANKS - world, N_RANKS))    # not the leading ranks
    pool.call(make_groups, ids, 0)
    return pool.call(compress_on_rank, ids, _rows(world), None, 7, steps,
                     ranks=ids)


def _reference_scales(rows, monkeypatch):
    """The reference's shared scales (its ``pmax`` over 127, per leaf)
    from ``compressed_psum`` under ``jax.vmap``."""
    seen = []
    pmax = jax.lax.pmax

    def recording(x, axis_name, **kw):
        out = pmax(x, axis_name, **kw)
        jax.debug.callback(lambda v: seen.append(np.asarray(v)), out)
        return out

    monkeypatch.setattr(jax.lax, "pmax", recording)
    world = rows["a"].shape[0]
    grads = {k: jnp.asarray(v) for k, v in rows.items()}
    ef = {k: jnp.zeros_like(v) for k, v in grads.items()}
    keys = jax.random.split(jax.random.key(0), world)
    jax.vmap(lambda g, e, k: jcompress.compressed_psum(g, e, k, "w"),
             axis_name="w")(grads, ef, keys)
    return [np.float32(m) / np.float32(127.0) for m in seen]


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_shared_scale_equals_reference(ranks, world,
                                                      monkeypatch):
    outs = on_ranks(ranks, world)
    ref = _reference_scales(_rows(world), monkeypatch)
    assert len(ref) == 2                    # one pmax per leaf: a, b
    for out in outs:
        got = [np.float32(s) for s in out["scale"][0]]
        assert got == ref, (got, ref)


@pytest.mark.parametrize("world", [2, 4])
def test_compressed_psum_bounds(ranks, world):
    rows = _rows(world)
    for out in on_ranks(ranks, world):
        for leaf, scale in zip(("a", "b"), out["scale"][0]):
            exact = rows[leaf].mean(0)
            assert np.abs(out["mean"][leaf] - exact).max() <= scale * 1.001
            assert np.abs(out["ef"][leaf]).max() <= scale * 1.001
    # every rank holds the same mean
    first = on_ranks(ranks, world)[0]["mean"]
    for out in on_ranks(ranks, world)[1:]:
        for leaf in ("a", "b"):
            np.testing.assert_array_equal(out["mean"][leaf], first[leaf])


def test_compressed_psum_error_feedback_converges(ranks):
    """EF makes the *averaged* compression error vanish over steps."""
    steps = 30
    rows = _rows(4)
    out = on_ranks(ranks, 4, steps)[0]
    for leaf in ("a", "b"):
        np.testing.assert_allclose(out["mean_over_steps"][leaf],
                                   rows[leaf].mean(0), atol=5e-3)
    one = on_ranks(ranks, 4, 1)[0]
    for leaf in ("a", "b"):
        err1 = np.abs(one["mean"][leaf] - rows[leaf].mean(0)).max()
        err30 = np.abs(out["mean_over_steps"][leaf] - rows[leaf].mean(0)).max()
        assert err30 < err1


def test_compressed_psum_issues_one_max_and_one_int32_sum_a_leaf(ranks):
    for world in (2, 4):
        for out in on_ranks(ranks, world):
            assert out["calls"] == [
                ("all_reduce", world, 1, "cpu", "MAX", "torch.float32"),
                ("all_reduce", world, 256, "cpu", "SUM", "torch.int32"),
                ("all_reduce", world, 1, "cpu", "MAX", "torch.float32"),
                ("all_reduce", world, 32, "cpu", "SUM", "torch.int32")]
