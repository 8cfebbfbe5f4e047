"""Cross-strategy conformance and substrate-equivalence harnesses.  Port
of :mod:`repro.core.conformance`.

Runs one registered instance under every (or a chosen subset of)
:class:`~repro_torch.core.frames.FrameStrategy` × virtual world size on one
device and checks the paper's invariants.  Per cell (strategy, W):

1. **Termination** — the engine stops before ``max_epochs``.
2. **Sample-count consistency** (Prop. 1) — ``total.num`` is a whole number
   of epoch frames (× W, except under INDEXED_FRAME).
3. **(ε, δ) accuracy** — the estimate is within ε of the exact oracle and
   within 2ε of the W=1 BARRIER run.

Across cells:

4. **INDEXED_FRAME determinism** — bit-identical τ and trimmed data for
   every W.
5. **SHARED_FRAME reassembly** — the shards glued back together equal the
   LOCAL_FRAME total at the same (seed, W).

Substrate equivalence (:func:`run_substrate_equivalence`): every
(strategy × W × F) cell must give **bit-identical** τ, trimmed data and
estimate on the sequential, vmap and shard_map substrates, so that the
collectives of W worker processes — the grouped F < W reduce-scatter in
particular — can never drift from the one-process semantics the rest of
the suite runs on.  Shard_map's cells run in W spawned ranks
(:func:`repro_torch.launch.spawn.spawn_workers`), one spawn for every cell
of a W.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import hashlib
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from .distributed import DEFAULT_TIMEOUT_S
from .frames import FrameStrategy, leaves
from .instances import (AdaptiveInstance, available_instances, get_instance,
                        run_instance)
from .substrate import Substrate, unavailable_reason

DEFAULT_WORLDS = (1, 2, 4)
EQUIVALENCE_WORLDS = (1, 2, 4, 8)


@dataclasses.dataclass
class CellResult:
    instance: str
    strategy: FrameStrategy
    world: int
    num: int
    stopped: bool
    err_oracle: float
    err_sequential: float
    failures: List[str]
    estimate: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    @property
    def ok(self) -> bool:
        return not self.failures


@dataclasses.dataclass
class ConformanceReport:
    instance: str
    cells: List[CellResult]
    cross_failures: List[str]

    @property
    def ok(self) -> bool:
        return not self.cross_failures and all(c.ok for c in self.cells)

    @property
    def failures(self) -> List[str]:
        out = [f for c in self.cells for f in c.failures]
        return out + list(self.cross_failures)

    def summary(self) -> str:
        lines = [f"conformance[{self.instance}]: "
                 f"{sum(c.ok for c in self.cells)}/{len(self.cells)} cells ok"]
        for c in self.cells:
            tag = "ok " if c.ok else "FAIL"
            lines.append(f"  {tag} {c.strategy.name:13s} W={c.world} "
                         f"τ={c.num:6d} err={c.err_oracle:.4f}"
                         + ("" if c.ok else f"  <- {'; '.join(c.failures)}"))
        lines += [f"  CROSS FAIL: {f}" for f in self.cross_failures]
        return "\n".join(lines)


def _tree_equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def run_conformance(instance: "str | AdaptiveInstance", *,
                    strategies: Optional[Sequence[FrameStrategy]] = None,
                    worlds: Sequence[int] = DEFAULT_WORLDS,
                    seed: int = 0, device=None) -> ConformanceReport:
    """Sweep one instance over strategies × worlds on ``device`` (``None`` →
    the CUDA card) and check all invariants."""
    device = resolve_device(device)
    inst = get_instance(instance) if isinstance(instance, str) else instance
    strategies = list(strategies) if strategies is not None \
        else list(FrameStrategy)

    # W=1 sequential oracle: BARRIER at W=1 checks after every epoch — the
    # reference Algorithm 1 execution.
    ref_est, _, _ = run_instance(inst, strategy=FrameStrategy.BARRIER, world=1,
                                 seed=seed, device=device)

    cells: List[CellResult] = []
    indexed: Dict[int, Tuple[int, object]] = {}
    local: Dict[int, Tuple[int, object]] = {}
    shared: Dict[int, Tuple[int, object]] = {}

    for strat in strategies:
        for world in worlds:
            est, res, built = run_instance(inst, strategy=strat, world=world,
                                           seed=seed, device=device)
            failures: List[str] = []
            where = f"{built.name}/{strat.name}/W={world}"

            if not res.stopped:
                failures.append(f"{where}: did not stop "
                                f"within {built.max_epochs} epochs")

            # Prop. 1: τ = Σ over integral per-worker frame prefixes.
            spf = built.samples_per_round * (
                1 if strat == FrameStrategy.LOCK else built.rounds_per_epoch)
            unit = spf if strat == FrameStrategy.INDEXED_FRAME \
                else spf * world
            if res.num <= 0 or res.num % unit != 0:
                failures.append(f"{where}: τ={res.num} is not a whole number "
                                f"of {unit}-sample frame sets")

            err_o = float(np.max(np.abs(est - built.oracle)))
            if err_o > built.eps:
                failures.append(f"{where}: oracle error {err_o:.4f} "
                                f"> ε={built.eps:.4f}")
            err_s = float(np.max(np.abs(est - ref_est)))
            if err_s > 2.0 * built.eps:
                failures.append(f"{where}: deviates from W=1 sequential "
                                f"oracle by {err_s:.4f} > 2ε")

            trimmed = built.trim(res.data)
            if strat == FrameStrategy.INDEXED_FRAME:
                indexed[world] = (res.num, trimmed)
            elif strat == FrameStrategy.LOCAL_FRAME:
                local[world] = (res.num, trimmed)
            elif strat == FrameStrategy.SHARED_FRAME:
                shared[world] = (res.num, trimmed)

            cells.append(CellResult(
                instance=built.name, strategy=strat, world=world,
                num=res.num, stopped=res.stopped, err_oracle=err_o,
                err_sequential=err_s, failures=failures, estimate=est))

    cross: List[str] = []
    if len(indexed) > 1:
        w0 = min(indexed)
        num0, data0 = indexed[w0]
        for w, (num, data) in sorted(indexed.items()):
            if num != num0:
                cross.append(f"INDEXED_FRAME τ differs across worlds: "
                             f"W={w0}→{num0}, W={w}→{num}")
            if not _tree_equal(data, data0):
                cross.append(f"INDEXED_FRAME data differs: W={w0} vs W={w}")
    for w in sorted(set(local) & set(shared)):
        num_l, data_l = local[w]
        num_s, data_s = shared[w]
        if num_l != num_s:
            cross.append(f"W={w}: SHARED τ={num_s} ≠ LOCAL τ={num_l}")
        if not _tree_equal(data_l, data_s):
            cross.append(f"W={w}: SHARED shard reassembly ≠ LOCAL total")

    return ConformanceReport(instance=inst.name, cells=cells,
                             cross_failures=cross)


def run_all(*, strategies: Optional[Sequence[FrameStrategy]] = None,
            worlds: Sequence[int] = DEFAULT_WORLDS, seed: int = 0,
            device=None) -> Dict[str, ConformanceReport]:
    """Conformance across every registered instance; ``seed`` flows into
    every cell and each sweep's W=1 reference run."""
    device = resolve_device(device)
    return {name: run_conformance(name, strategies=strategies, worlds=worlds,
                                  seed=seed, device=device)
            for name in available_instances()}


# ---------------------------------------------------------------------------
# Substrate equivalence: sequential / vmap / shard_map must agree bit for bit.
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class SubstrateCell:
    """One (strategy, W, F) cell compared across execution substrates."""

    instance: str
    strategy: FrameStrategy
    world: int
    frame_shards: int             # paper's F (0 → W)
    num: int                      # reference (vmap) τ
    ran: List[str]                # substrate values that executed
    skipped: Dict[str, str]       # substrate value -> why it could not run
    failures: List[str]

    @property
    def ok(self) -> bool:
        return not self.failures

    @property
    def compared(self) -> int:
        """How many substrates were actually cross-checked against vmap."""
        return max(0, len(self.ran) - 1)


@dataclasses.dataclass
class SubstrateReport:
    """One instance's cells; ``rank_reports`` holds, by W, what the
    ``rank_probe`` of :func:`run_substrate_equivalence_all` reported from
    each rank of the spawn that ran the shard_map cells of that W (one
    spawn serves every instance of a sweep)."""

    instance: str
    cells: List[SubstrateCell]
    rank_reports: Dict[int, List[Any]] = dataclasses.field(
        default_factory=dict)

    @property
    def ok(self) -> bool:
        return all(c.ok for c in self.cells)

    @property
    def failures(self) -> List[str]:
        return [f for c in self.cells for f in c.failures]

    def summary(self) -> str:
        lines = [f"substrate-equivalence[{self.instance}]: "
                 f"{sum(c.ok for c in self.cells)}/{len(self.cells)} cells ok"]
        for c in self.cells:
            tag = "ok " if c.ok else "FAIL"
            F = c.frame_shards or c.world
            lines.append(
                f"  {tag} {c.strategy.name:13s} W={c.world} F={F} "
                f"τ={c.num:6d} ran={','.join(c.ran)}"
                + (f" skipped={sorted(c.skipped)}" if c.skipped else "")
                + ("" if c.ok else f"  <- {'; '.join(c.failures)}"))
        return "\n".join(lines)


def equivalence_grid(worlds: Sequence[int] = EQUIVALENCE_WORLDS,
                     strategies: Optional[Sequence[FrameStrategy]] = None,
                     ) -> List[Tuple[FrameStrategy, int, int]]:
    """The (strategy, W, F) cells of the substrate-equivalence suite: the
    full strategy × W grid at F = W, plus the SHARED_FRAME F = W/2 cells
    that exercise the grouped reduce-scatter + cross-group all-reduce."""
    strategies = list(strategies) if strategies is not None \
        else list(FrameStrategy)
    cells = [(s, w, 0) for s in strategies for w in worlds]
    if FrameStrategy.SHARED_FRAME in strategies:
        cells += [(FrameStrategy.SHARED_FRAME, w, w // 2)
                  for w in worlds if w >= 2]
    return cells


Run = Tuple[int, Any, np.ndarray]   # (τ, trimmed data, estimate)


def _digest(runs: Dict[tuple, Run]) -> str:
    h = hashlib.sha256()
    for key in sorted(runs):
        num, data, est = runs[key]
        h.update(repr((key, num)).encode())
        for leaf in leaves(data):
            a = np.ascontiguousarray(leaf)
            h.update(repr((a.dtype.str, a.shape)).encode() + a.tobytes())
        h.update(np.ascontiguousarray(est).tobytes())
    return h.hexdigest()


def shard_map_cells(group, instances: Sequence[AdaptiveInstance],
                    cells: Sequence[Tuple[FrameStrategy, int, int]],
                    seed: int, rank_probe: Optional[Callable] = None):
    """A rank's side of the sweep: every (instance, cell) on SHARD_MAP in
    ``group``.  Every rank checks that all ranks hold the same results (a
    digest, all-gathered), and rank 0 returns them; with ``rank_probe``
    each rank runs the cells inside ``rank_probe(group)`` and returns what
    it yields too."""
    import torch.distributed as dist
    probe = rank_probe(group) if rank_probe is not None \
        else contextlib.nullcontext()
    runs: Dict[tuple, Run] = {}
    with probe as report:
        for inst in instances:
            for strat, world, F in cells:
                est, res, built = run_instance(
                    inst, strategy=strat, world=world, seed=seed,
                    substrate=Substrate.SHARD_MAP.value, frame_shards=F,
                    group=group)
                runs[(inst.name, strat.value, F)] = (
                    res.num, built.trim(res.data), est)
    digest = _digest(runs)
    digests = [None] * group.world
    dist.all_gather_object(digests, digest, group=group.pg)
    if any(d != digest for d in digests):
        raise AssertionError(f"rank {group.rank}: the ranks' shard_map "
                             f"results differ (digests {digests})")
    return (runs if group.rank == 0 else None), report


def _spawn_unavailable(world: int, backend: Optional[str],
                       device: torch.device) -> Optional[str]:
    """Why W ranks cannot be spawned here (None = they can)."""
    nccl = backend == "nccl" or (backend is None and device.type == "cuda")
    if nccl and world > torch.cuda.device_count():
        return (f"NCCL puts one rank on each card: W={world} > "
                f"{torch.cuda.device_count()} CUDA device(s); pass "
                f"backend='gloo' to share cards")
    return None


def run_substrate_equivalence_all(
        instances: Optional[Sequence["str | AdaptiveInstance"]] = None, *,
        strategies: Optional[Sequence[FrameStrategy]] = None,
        worlds: Sequence[int] = EQUIVALENCE_WORLDS,
        substrates: Optional[Sequence[Substrate]] = None,
        seed: int = 0, require_all: bool = False, backend: Optional[str] = None,
        device=None, rank_probe: Optional[Callable] = None,
        timeout: float = DEFAULT_TIMEOUT_S) -> Dict[str, SubstrateReport]:
    """:func:`run_substrate_equivalence` for several instances (``None`` →
    every registered one), with ONE spawn of W ranks for all the
    instances' shard_map cells of each W, the spawns running beside this
    process's cells; each is bounded by ``timeout`` seconds.
    ``rank_probe`` — a module-level function ``probe(group)`` returning a
    context manager — wraps each rank's cells; what it yields comes back
    in the reports' ``rank_reports``."""
    from ..launch.spawn import spawn_workers
    device = resolve_device(device)
    names = instances if instances is not None else available_instances()
    insts = [get_instance(i) if isinstance(i, str) else i for i in names]
    subs = list(substrates) if substrates is not None else list(Substrate)

    # the spawns (one per W) run beside the one-process cells below
    skipped_shard: Dict[int, str] = {}
    spawns: Dict[int, Any] = {}
    pool = concurrent.futures.ThreadPoolExecutor(max_workers=len(worlds))
    with pool:
        if Substrate.SHARD_MAP in subs:
            for world in worlds:
                reason = _spawn_unavailable(world, backend, device)
                if reason is not None:
                    skipped_shard[world] = reason
                    continue
                spawns[world] = pool.submit(
                    spawn_workers, shard_map_cells, world, backend=backend,
                    device=device.type, timeout=timeout,
                    args=(insts, equivalence_grid([world], strategies), seed,
                          rank_probe))
        local = {(inst.name, strat.value, world, F, sub.value):
                 run_instance(inst, strategy=strat, world=world, seed=seed,
                              substrate=sub.value, frame_shards=F,
                              device=device)
                 for inst in insts
                 for strat, world, F in equivalence_grid(worlds, strategies)
                 for sub in subs if sub != Substrate.SHARD_MAP
                 and unavailable_reason(sub, world) is None}
        outs = {world: spawn.result() for world, spawn in spawns.items()}
    sharded = {world: out[0][0] for world, out in outs.items()}
    rank_reports = {world: [report for _, report in out]
                    for world, out in outs.items()}

    reports = {}
    for inst in insts:
        cells: List[SubstrateCell] = []
        for strat, world, F in equivalence_grid(worlds, strategies):
            runs: Dict[str, Run] = {}
            skipped: Dict[str, str] = {}
            failures: List[str] = []
            where = f"{inst.name}/{strat.name}/W={world}/F={F or world}"
            for sub in subs:
                if sub == Substrate.SHARD_MAP:
                    reason = skipped_shard.get(world)
                else:
                    reason = unavailable_reason(sub, world)
                if reason is not None:
                    skipped[sub.value] = reason
                    if require_all and sub != Substrate.SEQUENTIAL:
                        failures.append(f"{where}: required substrate "
                                        f"{sub.value} unavailable: {reason}")
                    continue
                if sub == Substrate.SHARD_MAP:
                    runs[sub.value] = sharded[world][
                        (inst.name, strat.value, F)]
                    continue
                est, res, built = local[
                    (inst.name, strat.value, world, F, sub.value)]
                runs[sub.value] = (res.num, built.trim(res.data), est)

            ref_key = Substrate.VMAP.value
            if ref_key not in runs:
                failures.append(f"{where}: reference substrate {ref_key} did "
                                f"not run")
                num0 = -1
            else:
                num0, data0, est0 = runs[ref_key]
                for key, (num, data, est) in runs.items():
                    if key == ref_key:
                        continue
                    if num != num0:
                        failures.append(f"{where}: τ differs — {key}={num}, "
                                        f"{ref_key}={num0}")
                    if not _tree_equal(data, data0):
                        failures.append(f"{where}: trimmed data differs — "
                                        f"{key} vs {ref_key}")
                    if not np.array_equal(est, est0):
                        failures.append(f"{where}: estimate differs — "
                                        f"{key} vs {ref_key}")

            cells.append(SubstrateCell(
                instance=inst.name, strategy=strat, world=world,
                frame_shards=F, num=num0, ran=sorted(runs), skipped=skipped,
                failures=failures))
        reports[inst.name] = SubstrateReport(instance=inst.name, cells=cells,
                                             rank_reports=rank_reports)
    return reports


def run_substrate_equivalence(
        instance: "str | AdaptiveInstance", *,
        strategies: Optional[Sequence[FrameStrategy]] = None,
        worlds: Sequence[int] = EQUIVALENCE_WORLDS,
        substrates: Optional[Sequence[Substrate]] = None,
        seed: int = 0, require_all: bool = False, backend: Optional[str] = None,
        device=None) -> SubstrateReport:
    """Run one instance's (strategy × W × F) grid on every substrate that
    can execute here and demand bit-identical τ, trimmed data and
    estimate.

    VMAP, on ``device`` (``None`` → the CUDA card), is the reference;
    SEQUENTIAL joins at W = 1; SHARD_MAP runs in W spawned ranks over
    ``backend`` on ``device``'s type (NCCL by default on CUDA, which runs
    at most one rank a card; gloo on the CPU and for ranks that share a
    card).  A substrate that cannot run is recorded in ``cell.skipped`` —
    or failed outright with ``require_all=True``.
    """
    inst = get_instance(instance) if isinstance(instance, str) else instance
    return run_substrate_equivalence_all(
        [inst], strategies=strategies, worlds=worlds, substrates=substrates,
        seed=seed, require_all=require_all, backend=backend,
        device=device)[inst.name]
