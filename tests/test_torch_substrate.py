"""The port's SHARD_MAP substrate: W gloo ranks on the CPU, started by
``spawn_workers``, against the reference's collectives and against the
port's own vmap and sequential substrates.

* ``process_collectives`` in W ranks equals the reference's
  ``axis_collectives`` under ``jax.vmap`` bit for bit on the same numpy
  frames, and its F < W path is the grouped reduce-scatter + cross-group
  all-reduce (the torch.distributed calls recorded in the ranks).
* The substrate-equivalence grid: every (instance, strategy, W, F) cell
  gives the same τ, trimmed data and estimate on shard_map as on vmap (and
  on sequential at W = 1), computed once per module, one spawn per W.
* The errors: NCCL beyond the cards, shard_map outside a group, a rank
  that raises, ranks that run past the timeout, ranks that disagree.
"""

import dataclasses
import functools
import time

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
import torch.distributed as dist

from repro.core import frames as jf
from repro_torch.core.conformance import (equivalence_grid,
                                          run_substrate_equivalence,
                                          run_substrate_equivalence_all)
from repro_torch.core.distributed import init_worker_group
from repro_torch.core.epoch import EpochConfig, make_program
from repro_torch.core.frames import (FrameStrategy, collectives_on_rank,
                                     virtual_collectives)
from repro_torch.core.instances import get_instance, run_instance
from repro_torch.core.substrate import (Substrate, available_substrates,
                                        make_stepper, unavailable_reason)
from repro_torch.launch import spawn
from repro_torch.launch.mesh import make_worker_group
from repro_torch.launch.spawn import spawn_workers

INSTANCES = ("kadabra", "triangles", "reachability", "wrs", "diameter",
             "gradvar")
WORLDS = (1, 2, 4)
EXTRA_SEEDS = (1, 2)
TIMEOUT = 120.0
N = 24


@functools.lru_cache(maxsize=None)
def grid(worlds=WORLDS, seed=0):
    """Every instance's equivalence grid, one spawn per W (gloo, CPU)."""
    return run_substrate_equivalence_all(INSTANCES, worlds=worlds, seed=seed,
                                         require_all=True, backend="gloo",
                                         device="cpu", timeout=TIMEOUT)


# ------------------------------------------------------------ collectives


def _frames(world):
    rng = np.random.default_rng(world)
    return (rng.integers(0, 7, (world,)).astype(np.int32),
            {"counts": rng.integers(0, 1000, (world, N)).astype(np.int32),
             "s1": rng.integers(0, 1000, (world,)).astype(np.int32)})


@functools.lru_cache(maxsize=None)
def rank_collectives(world, shards):
    num, data = _frames(world)
    return spawn_workers(collectives_on_rank, world, backend="gloo",
                         device="cpu", args=(num, data, shards),
                         timeout=TIMEOUT)


def _reference(world, F, op):
    """The reference's vmap collectives on the same frames → (W, ...)."""
    num, data = _frames(world)
    colls = jf.axis_collectives("w", world, F, grouped=False)

    def fn(n, d):
        return getattr(colls, op)(jf.StateFrame(num=n, data=d))

    out = jax.vmap(fn, axis_name="w")(
        jnp.asarray(num), {k: jnp.asarray(v) for k, v in data.items()})
    return np.asarray(out.num), {k: np.asarray(v) for k, v in out.data.items()}


SHARDS = {2: (2,), 4: (4, 2, 1)}


@pytest.mark.parametrize("op", ["reduce_frames", "scatter_frames",
                                "all_frames"])
@pytest.mark.parametrize("world,F", [(2, 2), (4, 4), (4, 2), (4, 1)])
def test_process_collectives_equal_reference(world, F, op):
    ranks = rank_collectives(world, SHARDS[world])
    ref_num, ref_data = _reference(world, F, op)
    for r, out in enumerate(ranks):
        num, data, _ = out[F][op]
        np.testing.assert_array_equal(num, ref_num[r])
        for k in ref_data:
            # scatter_frames keeps the held worker's stacked row (1, ...)
            got = data[k][0] if op == "scatter_frames" else data[k]
            np.testing.assert_array_equal(got, ref_data[k][r])


@pytest.mark.parametrize("world,F", [(4, 2), (4, 1)])
def test_grouped_scatter_is_reduce_scatter_then_all_reduce(world, F):
    """The counterpart of the reference's lowering proof: F < W issues one
    reduce-scatter on a group of F, one all-reduce on a group of W/F over
    n/F elements, and no other collective over more than one element."""
    for r, out in enumerate(rank_collectives(world, SHARDS[world])):
        calls = out[F]["scatter_frames"][2]
        rs = [c for c in calls if c[0].startswith("reduce_scatter")]
        big = [c for c in calls if c[2] > 1 and c not in rs]
        assert [(size, n) for _, size, n, _ in rs] == [(F, N)], (r, calls)
        assert [(op, size, n) for op, size, n, _ in big] == \
            [("all_reduce", world // F, N // F)], (r, calls)
        assert {c[3] for c in calls} == {"cpu"}
        assert all(c[2] == 1 for c in calls if c not in rs + big), calls


def test_full_width_scatter_is_one_reduce_scatter():
    for out in rank_collectives(4, SHARDS[4]):
        big = [c for c in out[4]["scatter_frames"][2] if c[2] > 1]
        assert len(big) == 1 and big[0][0].startswith("reduce_scatter")
        assert big[0][1:] == (4, N, "cpu")


def test_float_frames_are_refused():
    from repro_torch.core.frames import _int_leaf
    with pytest.raises(TypeError, match="integer"):
        _int_leaf(torch.zeros(3))


# ------------------------------------------------------- equivalence grid


def test_equivalence_grid_shape():
    cells = equivalence_grid((1, 2, 4, 8))
    assert len(cells) == len(FrameStrategy) * 4 + 3  # + SHARED F=W/2 cells
    assert (FrameStrategy.SHARED_FRAME, 8, 4) in cells
    assert (FrameStrategy.SHARED_FRAME, 1, 0) in cells


def _check_cells(rep, strategy, world):
    cells = [c for c in rep.cells
             if c.strategy == strategy and c.world == world]
    assert cells, "grid must cover the cell"
    for cell in cells:  # includes the SHARED F=W/2 cell where it exists
        assert cell.ok, "\n".join(cell.failures)
        assert "shard_map" in cell.ran and "vmap" in cell.ran
        assert cell.compared >= 1


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("strategy", list(FrameStrategy),
                         ids=lambda s: s.name)
@pytest.mark.parametrize("instance", INSTANCES)
def test_cell_bit_identical_across_substrates(instance, strategy, world):
    _check_cells(grid()[instance], strategy, world)


@pytest.mark.parametrize("instance", INSTANCES)
def test_w1_oracle_joins_comparison(instance):
    """At W = 1 all three substrates ran and agree."""
    for cell in grid()[instance].cells:
        if cell.world == 1:
            assert set(cell.ran) == {"sequential", "vmap", "shard_map"}
            assert cell.ok, "\n".join(cell.failures)


def test_grouped_cells_ran_on_shard_map():
    for rep in grid().values():
        grouped = [c for c in rep.cells if c.frame_shards and
                   c.frame_shards < c.world]
        assert {(c.world, c.frame_shards) for c in grouped} == {(2, 1), (4, 2)}
        assert all("shard_map" in c.ran and c.ok for c in grouped)


@pytest.mark.slow
@pytest.mark.parametrize("strategy", list(FrameStrategy),
                         ids=lambda s: s.name)
@pytest.mark.parametrize("instance", INSTANCES)
def test_cell_bit_identical_at_w8(instance, strategy):
    _check_cells(grid(worlds=(8,))[instance], strategy, 8)


@pytest.mark.slow
@pytest.mark.parametrize("seed", EXTRA_SEEDS)
@pytest.mark.parametrize("instance", INSTANCES)
def test_equivalence_at_other_seeds(instance, seed):
    rep = grid(seed=seed)[instance]
    assert rep.ok, rep.summary()
    assert len(rep.cells) == len(equivalence_grid(WORLDS))


def test_single_instance_entry_point():
    rep = run_substrate_equivalence(
        "wrs", strategies=[FrameStrategy.LOCAL_FRAME], worlds=(2,),
        backend="gloo", device="cpu", require_all=True)
    assert rep.ok and [c.ran for c in rep.cells] == [["shard_map", "vmap"]]


@pytest.mark.parametrize("strategy", [FrameStrategy.LOCAL_FRAME,
                                      FrameStrategy.SHARED_FRAME,
                                      FrameStrategy.INDEXED_FRAME],
                         ids=lambda s: s.name)
def test_a_rank_samples_its_vmap_rows(strategy):
    """Rank r of W holds worker r: with fold = k its streams are VMAP's
    r·k … r·k+k−1 at W·k (INDEXED: the global frames epoch·W + r), so its
    primed pending row is the sum of those VMAP rows.  In-process: the
    priming epoch issues no collective."""
    world, rank = 2, 1
    k = 1 if strategy == FrameStrategy.INDEXED_FRAME else 2  # INDEXED: no fold
    built = get_instance("wrs").build(world=world * k, strategy=strategy,
                                      device="cpu")
    cfg = EpochConfig(strategy=strategy, rounds_per_epoch=2)

    def program(colls, fold):
        return make_program(built.sample_fn, built.check_fn, built.template,
                            cfg, colls, fold=fold)

    vmap = program(virtual_collectives(world * k), None).init(None, 3)
    held = dataclasses.replace(virtual_collectives(world), workers=(rank,))
    mine = program(held, k if k > 1 else None).init(None, 3)
    rows = slice(rank * k, rank * k + k)
    for key, x in mine.pending.data.items():
        assert x.shape[0] == 1
        assert torch.equal(x[0], vmap.pending.data[key][rows].sum(0,
                                                                 dtype=x.dtype))
    assert len(mine.gens) == k


# ------------------------------------------------------------- the errors


def test_nccl_beyond_the_cards_raises_before_init():
    with pytest.raises(RuntimeError, match="gloo"):
        init_worker_group(0, torch.cuda.device_count() + 1, backend="nccl",
                          init_method="file:///nonexistent/rendezvous")
    with pytest.raises(ValueError, match="gloo"):
        init_worker_group(0, 1, backend="nccl", device="cpu",
                          init_method="file:///nonexistent/rendezvous")
    assert not dist.is_initialized()
    rep = run_substrate_equivalence(
        "wrs", strategies=[FrameStrategy.LOCAL_FRAME], worlds=(2,),
        substrates=[Substrate.VMAP, Substrate.SHARD_MAP], backend="nccl",
        device="cpu", require_all=True)
    assert "gloo" in rep.cells[0].skipped["shard_map"]
    assert not rep.ok


def test_shard_map_outside_a_group_raises():
    assert "spawn_workers" in unavailable_reason(Substrate.SHARD_MAP, 2)
    assert Substrate.SHARD_MAP not in available_substrates(2)
    with pytest.raises(RuntimeError, match="spawn_workers"):
        run_instance("wrs", world=2, substrate="shard_map", device="cpu")
    with pytest.raises(RuntimeError, match="spawn_workers"):
        make_stepper(None, None, torch.zeros(4, dtype=torch.int32), None, 2,
                     None, substrate="shard_map")
    with pytest.raises(RuntimeError, match="worker group"):
        make_worker_group(2)


def test_ranks_report_their_group():
    assert spawn_workers(spawn.rank_info, 2, backend="gloo", device="cpu",
                         timeout=TIMEOUT) == \
        [(0, 2, "gloo", "cpu"), (1, 2, "gloo", "cpu")]


def test_ranks_that_disagree_raise():
    with pytest.raises(RuntimeError, match="disagree"):
        spawn_workers(spawn.vote, 2, backend="gloo", device="cpu",
                      args=([True, False],), timeout=TIMEOUT)
    assert spawn_workers(spawn.vote, 2, backend="gloo", device="cpu",
                         args=([False, False],), timeout=TIMEOUT) == \
        [False, False]


def test_a_rank_that_raises_raises_with_its_traceback():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="rank 1 of 2 raised") as err:
        spawn_workers(spawn.raise_on, 2, backend="gloo", device="cpu",
                      args=(1,), timeout=60.0)
    assert "asked to raise" in str(err.value)
    assert "Traceback" in str(err.value)
    assert time.monotonic() - t0 < 60.0


def test_ranks_past_the_timeout_are_killed():
    t0 = time.monotonic()
    with pytest.raises(TimeoutError, match="killed"):
        spawn_workers(spawn.sleep, 2, backend="gloo", device="cpu",
                      args=(600.0,), timeout=4.0)
    assert time.monotonic() - t0 < 30.0
