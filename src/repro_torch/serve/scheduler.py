"""Epoch-granular continuous-batching scheduler for adaptive queries.
Port of :mod:`repro.serve.scheduler`; its sessions run on one device,
the scheduler's ``device`` (``None`` → the CUDA card).

The paper's loop only synchronizes at epoch boundaries, so an epoch is the
natural scheduling quantum.  :meth:`EpochScheduler.tick` is three stages:

1. **Pressure** (:mod:`repro_torch.serve.placement`, optional): when the
   queue's head cannot be placed, shrink the widest in-flight SHARED_FRAME
   session W → W/2 through :func:`repro_torch.serve.elastic.reshard_session` — the
   paper's Θ(n) ↔ Θ(n/W) memory/width trade-off driven by load instead of
   by hand (the resized session's (τ, estimate) trajectory is bit-identical
   to never having been resized).  When the queue is drained, re-grow
   shrunk sessions toward their logical width.
2. **Admission**: pop queued queries into free slots, bounded by
   ``max_in_flight`` and — when a :class:`~repro_torch.serve.placement.DevicePool`
   is attached — by a **disjoint submesh lease** per query
   (:exc:`PlacementWait` keeps the query queued; the pool accounts in
   worker slots, which are physical devices for ``shard_map`` sessions).
3. **Epoch step + retirement**: advance every in-flight session one epoch
   (one batched device step per session; the built instance and stepper
   of each shape come from the shared
   :class:`~repro_torch.serve.session.StepperCache`), retire the sessions
   whose stopping condition fired, and release their leases.

A long-running query therefore never blocks a short one — there is no
run-to-completion head-of-line, only admission policy.

Per-query accounting: submitted/admitted/retired tick, epochs run, final τ,
host wall time, peak ``devices_leased`` and ``placement_wait_ticks``.

Preemption safety: with ``checkpoint_dir`` set, every in-flight session is
checkpointed every ``checkpoint_every`` ticks (epoch boundaries — the only
points where a session state exists at all), the not-yet-admitted queue is
persisted as ``queue.json`` on every submit/tick, and
:meth:`EpochScheduler.resume` rebuilds a scheduler from whatever the
directory holds — restored sessions continue bit-identically (their
recorded placement is re-leased through the pool: the same device ids when
free, an equivalent submesh otherwise), queued queries are resubmitted
fresh.
"""

from __future__ import annotations

import dataclasses
import json
import os
from collections import deque
from pathlib import Path
from typing import Deque, Dict, List, Optional, Tuple

import numpy as np

from .elastic import reshard_session
from .placement import DevicePool, Lease, PlacementWait, PressurePolicy
from .session import AdaptiveSession, SessionSpec, StepperCache

_QUEUE_FILE = "queue.json"


@dataclasses.dataclass(frozen=True)
class _Restore:
    """A checkpointed session awaiting admission: restored lazily so its
    placement can be re-leased through the pool *before* the stepper is
    built (the recorded devices may be taken or gone)."""

    path: Path
    spec: SessionSpec


@dataclasses.dataclass
class QueryResult:
    """Final accounting record of one retired query."""

    qid: str
    spec: SessionSpec
    estimate: np.ndarray
    tau: int
    epochs: int
    stopped: bool                 # False only on the max_epochs safety net
    submitted_tick: int
    admitted_tick: int
    retired_tick: int
    wall_s: float                 # host time spent stepping this query
    devices_leased: int = 0      # peak lease width (0: scheduler had no pool)
    placement_wait_ticks: int = 0  # ticks queued *because the pool was full*
    stop_epoch: int = 0          # epoch at which the verdict first fired

    @property
    def wait_ticks(self) -> int:
        """Ticks spent queued before admission (the latency cost of the
        admission policy, in scheduling quanta)."""
        return self.admitted_tick - self.submitted_tick


@dataclasses.dataclass
class TickEvents:
    tick: int
    admitted: List[str]
    retired: List[str]
    # (qid, old_world, new_world) pressure-driven reshards this tick
    resharded: List[Tuple[str, int, int]] = \
        dataclasses.field(default_factory=list)


class EpochScheduler:
    """Continuous batching over a pool of heterogeneous adaptive queries.

    ``max_in_flight`` bounds concurrently-stepped sessions (device memory is
    dominated by the in-flight frame totals: Θ(n) per LOCAL query, Θ(n/F)
    per SHARED query per worker — the admission policy is the serving-side
    face of the paper's memory trade-off).  ``pool`` adds the placement
    dimension: admission additionally requires a disjoint submesh lease of
    ``spec.world`` slots, and ``pressure`` (requires ``pool``) lets the
    scheduler resize SHARED_FRAME sessions to relieve queue pressure.
    """

    def __init__(self, *, max_in_flight: int = 4,
                 substrate: Optional[str] = None,
                 pool: Optional[DevicePool] = None,
                 pressure: Optional[PressurePolicy] = None,
                 checkpoint_dir: "str | Path | None" = None,
                 checkpoint_every: int = 0, device=None):
        if max_in_flight < 1:
            raise ValueError("max_in_flight must be >= 1")
        if pressure is not None and pool is None:
            raise ValueError("a pressure policy needs a device pool")
        self.max_in_flight = max_in_flight
        self.substrate = substrate
        self.pool = pool
        self.pressure = pressure
        self.checkpoint_dir = Path(checkpoint_dir) if checkpoint_dir else None
        self.checkpoint_every = checkpoint_every
        self.cache = StepperCache(device)
        self._queue: Deque[Tuple[str,
                                 "SessionSpec | AdaptiveSession | _Restore"]]
        self._queue = deque()
        self._active: Dict[str, AdaptiveSession] = {}
        self._leases: Dict[str, Lease] = {}
        self._admitted_tick: Dict[str, int] = {}
        self._submitted_tick: Dict[str, int] = {}
        self._placement_wait: Dict[str, int] = {}
        self._devices_peak: Dict[str, int] = {}
        self.results: Dict[str, QueryResult] = {}
        # checkpointed queries resume() could not re-enqueue (e.g. recorded
        # world wider than the pool) — skipped loudly, never silently
        self.unresumed: List[str] = []
        self.tick_count = 0
        self._n_submitted = 0

    # ------------------------------------------------------------ admission
    @staticmethod
    def _spec_of(item) -> SessionSpec:
        return item.spec if isinstance(item, (AdaptiveSession, _Restore)) \
            else item

    def submit(self, spec: "SessionSpec | AdaptiveSession",
               qid: Optional[str] = None) -> str:
        """Enqueue a query (a spec, or an already-restored session)."""
        inner = self._spec_of(spec)
        if qid is None:
            # skip over ids already taken (e.g. restored from a checkpoint
            # directory whose numbering this counter has not seen)
            while True:
                qid = f"q{self._n_submitted:03d}-{inner.instance}"
                self._n_submitted += 1
                if qid not in self._submitted_tick:
                    break
        elif qid in self._submitted_tick:
            raise ValueError(f"duplicate query id {qid!r}")
        if self.pool is not None and inner.world > self.pool.capacity:
            raise ValueError(
                f"query {qid!r} needs {inner.world} worker slot(s) but the "
                f"pool holds only {self.pool.capacity} — it could never be "
                f"admitted")
        if self.substrate is not None and isinstance(spec, SessionSpec) \
                and spec.substrate is None:
            spec = dataclasses.replace(spec, substrate=self.substrate)
        self._submitted_tick[qid] = self.tick_count
        self._placement_wait[qid] = 0
        self._queue.append((qid, spec))
        self._persist_queue()
        return qid

    @property
    def pending(self) -> int:
        return len(self._queue)

    @property
    def in_flight(self) -> int:
        return len(self._active)

    @property
    def idle(self) -> bool:
        return not self._queue and not self._active

    def _note_lease(self, qid: str, lease: Optional[Lease]) -> None:
        if lease is None:
            return
        self._leases[qid] = lease
        self._devices_peak[qid] = max(self._devices_peak.get(qid, 0),
                                      lease.width)

    def _materialize(self, item, lease: Optional[Lease]) -> AdaptiveSession:
        """Turn a queue entry into a started session bound to its lease."""
        ids = None if lease is None else lease.ids
        if isinstance(item, _Restore):
            spec = item.spec
            if spec.substrate == "shard_map" and ids is not None \
                    and ids != spec.placement:
                return AdaptiveSession.restore(item.path, cache=self.cache,
                                               placement=ids)
            return AdaptiveSession.restore(item.path, cache=self.cache)
        if isinstance(item, AdaptiveSession):
            if item.spec.substrate == "shard_map" and ids is not None \
                    and ids != item.spec.placement:
                item.rebind_placement(ids, cache=self.cache)
            return item               # restored mid-run; already started
        spec = item
        if spec.substrate == "shard_map" and ids is not None:
            spec = dataclasses.replace(spec, placement=ids)
        return AdaptiveSession.create(spec, cache=self.cache).start()

    def _admit(self) -> Tuple[List[str], bool]:
        """Admission stage: lease a submesh per queued query (FIFO) until
        the pool or the in-flight budget blocks.  Returns the admitted ids
        and whether admission stopped on placement (vs max_in_flight)."""
        admitted: List[str] = []
        blocked_on_placement = False
        while self._queue and len(self._active) < self.max_in_flight:
            qid, item = self._queue[0]
            spec = self._spec_of(item)
            lease = None
            if self.pool is not None:
                try:
                    lease = self.pool.lease(spec.world,
                                            prefer=spec.placement)
                except PlacementWait:
                    blocked_on_placement = True
                    break            # FIFO: the head waits for capacity
            self._queue.popleft()
            self._note_lease(qid, lease)
            self._active[qid] = self._materialize(item, lease)
            self._admitted_tick[qid] = self.tick_count
            admitted.append(qid)
        return admitted, blocked_on_placement

    # ------------------------------------------------------------- pressure
    def _shrink_candidates(self) -> List[str]:
        assert self.pressure is not None
        floor = max(1, self.pressure.min_world)
        cands = [
            qid for qid, s in self._active.items()
            if s.spec.strategy == "shared" and not s.done
            and s.spec.world % 2 == 0 and s.spec.world // 2 >= floor]
        # widest first (frees the most slots); qid tiebreak for determinism
        return sorted(cands,
                      key=lambda q: (-self._active[q].spec.world, q))

    def _resize(self, qid: str, new_world: int) -> Tuple[int, int]:
        """Reshard one in-flight session to ``new_world`` and resize its
        lease to match.  Returns (old_world, new_world)."""
        session = self._active[qid]
        old_world = session.spec.world
        lease = self._leases.get(qid)
        placement = None
        if lease is not None:
            lease = self.pool.resize(lease, new_world)
            self._note_lease(qid, lease)
            if session.spec.substrate == "shard_map":
                placement = lease.ids
        self._active[qid] = reshard_session(
            session, new_world, cache=self.cache, placement=placement,
            substrate=None if placement is not None
            else session.spec.substrate)
        return old_world, new_world

    def _apply_pressure(self) -> List[Tuple[str, int, int]]:
        """Pressure stage: shrink under queue pressure, re-grow on drain."""
        if self.pressure is None or self.pool is None:
            return []
        events: List[Tuple[str, int, int]] = []
        if self._queue and len(self._active) < self.max_in_flight:
            # queued demand exceeds free devices → halve the widest
            # SHARED_FRAME session until the head fits (or nothing shrinks)
            head_spec = self._spec_of(self._queue[0][1])
            while self.pool.free < head_spec.world:
                cands = self._shrink_candidates()
                if not cands:
                    break
                qid = cands[0]
                old, new = self._resize(
                    qid, self._active[qid].spec.world // 2)
                events.append((qid, old, new))
        elif not self._queue and self.pressure.regrow and self.pool.free:
            # drained queue + free devices → give width back (one doubling
            # step per session per tick keeps re-grow gentle)
            for qid in sorted(self._active):
                session = self._active[qid]
                spec = session.spec
                lw = spec.logical_world or spec.world
                target = spec.world * 2
                if spec.strategy != "shared" or session.done \
                        or target > lw or lw % target != 0 \
                        or self.pool.free < target - spec.world:
                    continue
                old, new = self._resize(qid, target)
                events.append((qid, old, new))
        return events

    # ----------------------------------------------------------- the tick
    def tick(self) -> TickEvents:
        """One scheduling quantum: relieve placement pressure → admit (lease
        worker slots per query) → step every in-flight query one epoch →
        retire at the epoch boundary (releasing leases)."""
        resharded = self._apply_pressure()
        admitted, blocked_on_placement = self._admit()

        retired: List[str] = []
        for qid, session in list(self._active.items()):
            session.step()
            if session.done:
                retired.append(qid)

        for qid in retired:
            session = self._active.pop(qid)
            lease = self._leases.pop(qid, None)
            if lease is not None:
                self.pool.release(lease)
            est, res = session.result()
            self.results[qid] = QueryResult(
                qid=qid, spec=session.spec, estimate=np.asarray(est),
                tau=res.num, epochs=res.epochs, stopped=res.stopped,
                submitted_tick=self._submitted_tick[qid],
                admitted_tick=self._admitted_tick[qid],
                retired_tick=self.tick_count, wall_s=session.wall_s,
                devices_leased=self._devices_peak.get(qid, 0),
                placement_wait_ticks=self._placement_wait.get(qid, 0),
                stop_epoch=res.stop_epoch)
            if self.checkpoint_dir is not None:
                # final state persists too — a restore after drain sees the
                # query as done instead of re-running it.
                session.save(self.checkpoint_dir / qid)

        if blocked_on_placement:
            # the queue spent this tick waiting on devices, not on the
            # in-flight budget — that is placement latency
            # (`placement_wait_ticks`).
            for qid, _ in self._queue:
                self._placement_wait[qid] += 1

        self.tick_count += 1
        if self.checkpoint_dir is not None:
            self._persist_queue()
            if self.checkpoint_every and \
                    self.tick_count % self.checkpoint_every == 0:
                self.save_all()
        return TickEvents(tick=self.tick_count - 1, admitted=admitted,
                          retired=retired, resharded=resharded)

    def drain(self, max_ticks: int = 100_000) -> List[TickEvents]:
        """Tick until queue and pool are empty (every query retired)."""
        events = []
        while not self.idle:
            if self.tick_count >= max_ticks:
                raise RuntimeError(f"scheduler did not drain in {max_ticks} "
                                   f"ticks ({self.in_flight} in flight)")
            events.append(self.tick())
        return events

    # -------------------------------------------------------- checkpointing
    def _persist_queue(self) -> None:
        """Atomically mirror every unretired query (queued AND in-flight)
        to disk, so a preemption cannot silently drop queries that never
        got a session checkpoint of their own.  On resume, a per-query
        checkpoint subdirectory wins (bit-identical continuation); entries
        with no checkpoint are resubmitted fresh — at-least-once execution,
        never silent loss."""
        if self.checkpoint_dir is None:
            return
        self.checkpoint_dir.mkdir(parents=True, exist_ok=True)
        entries = [{"qid": qid, "spec": self._spec_of(item).as_meta()}
                   for qid, item in self._queue]
        entries += [{"qid": qid, "spec": session.spec.as_meta()}
                    for qid, session in self._active.items()]
        tmp = self.checkpoint_dir / (_QUEUE_FILE + ".tmp")
        tmp.write_text(json.dumps(entries))
        os.rename(tmp, self.checkpoint_dir / _QUEUE_FILE)

    def save_all(self) -> None:
        assert self.checkpoint_dir is not None
        for qid, session in self._active.items():
            session.save(self.checkpoint_dir / qid)
        self._persist_queue()

    @classmethod
    def resume(cls, checkpoint_dir: "str | Path", *,
               max_in_flight: int = 4, substrate: Optional[str] = None,
               pool: Optional[DevicePool] = None,
               pressure: Optional[PressurePolicy] = None,
               checkpoint_every: int = 0, device=None) -> "EpochScheduler":
        """Rebuild a scheduler from a checkpoint directory: every per-query
        subdirectory with a complete checkpoint is resubmitted as a pending
        restore — materialized at admission, so its recorded placement is
        first re-leased through ``pool`` (the same device ids when free, an
        equivalent submesh otherwise); done sessions retire on their first
        tick without stepping (``step()`` is a no-op once stopped) — and
        queries persisted in ``queue.json`` that never earned a checkpoint
        of their own are resubmitted fresh under their original ids.

        Entries that can *never* be placed on ``pool`` (recorded world wider
        than the pool's capacity) are left out rather than aborting the
        whole restore: their ids land in ``sched.unresumed``, a warning
        names them, and their checkpoints stay on disk untouched (resume
        them on an adequate pool, or re-shard by hand)."""
        import warnings

        from ..checkpoint.manager import latest_step, read_meta
        sched = cls(max_in_flight=max_in_flight, substrate=substrate,
                    pool=pool, pressure=pressure,
                    checkpoint_dir=checkpoint_dir,
                    checkpoint_every=checkpoint_every, device=device)
        root = Path(checkpoint_dir)

        def try_submit(item, qid):
            try:
                sched.submit(item, qid=qid)
            except ValueError as e:
                sched.unresumed.append(qid)
                warnings.warn(f"resume skipped {qid!r}: {e}", stacklevel=3)

        # read the queue before submitting anything: every submit rewrites
        # queue.json (the reference reads it after, and so loses the
        # queries queued behind checkpointed sessions)
        queue_file = root / _QUEUE_FILE
        queued = json.loads(queue_file.read_text()) \
            if queue_file.exists() else []
        for sub in sorted(p for p in root.iterdir() if p.is_dir()):
            step = latest_step(sub)
            if step is None:
                continue
            spec = SessionSpec.from_meta(read_meta(sub, step)["spec"])
            try_submit(_Restore(path=sub, spec=spec), sub.name)
        for entry in queued:
            if entry["qid"] not in sched._submitted_tick \
                    and entry["qid"] not in sched.unresumed:
                try_submit(SessionSpec.from_meta(entry["spec"]), entry["qid"])
        return sched
