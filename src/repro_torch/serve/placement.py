"""Placement: a device-topology pool that carves disjoint submeshes.
Port of :mod:`repro.serve.placement` (pure Python but for
:meth:`DeviceTopology.from_host` and :func:`lease_devices`, which read
torch's CUDA devices).

The paper's almost-no-synchronization property means workers only coordinate
at epoch boundaries, *within* one session — two sessions never coordinate at
all.  A machine's devices can therefore be partitioned into **disjoint
submeshes** that each run an independent session with zero cross-session
synchronization (the same property the MPI follow-up, van der Grinten &
Meyerhenke 2019, exploits across hosts).  This module models that:

* :class:`DeviceTopology` — the machine: device ids grouped into locality
  domains (hosts/processes).  Built from the host's CUDA devices
  (:meth:`DeviceTopology.from_host`) or parsed from a CLI spec
  (:meth:`DeviceTopology.parse`, e.g. ``"8"`` or ``"2x4"``).
* :class:`DevicePool` — lease/release bookkeeping over a topology.
  :meth:`DevicePool.lease` carves a width-``n`` submesh whose device ids are
  **pairwise disjoint** from every live lease, preferring whole aligned
  blocks inside a single locality group (so a W=4 lease on an 8-device host
  is ``[0..3]`` and the next one ``[4..7]``); it raises
  :exc:`PlacementWait` when demand exceeds free capacity — the scheduler's
  signal to queue the query rather than contend.
* :class:`PressurePolicy` — when/how the scheduler trades the paper's
  Θ(n) ↔ Θ(n/W) memory/width trade-off *by load*: shrink a SHARED_FRAME
  session W → W/2 when queued demand exceeds free devices, re-grow toward
  its logical width when the queue drains.

The pool accounts in **worker slots**: a session's footprint is its
``world``.  Under ``shard_map`` each slot is a rank of the rank pool
(:class:`~repro_torch.launch.spawn.RankPool`), slot i being rank i on
``cuda:(i % device_count)`` (``lease_devices``), and the lease's ranks
hold the session's workers; under ``vmap`` the W virtual workers
timeshare one device, but the lease still reserves W slots so admission
and pressure behave identically across substrates (and are testable on a
1-device host with an abstract topology).
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Iterable, List, Optional, Sequence, Tuple


class PlacementWait(RuntimeError):
    """Demand exceeds the pool's free capacity *right now* — the caller
    should queue and retry at a later tick, not treat this as fatal."""

    def __init__(self, width: int, free: int):
        super().__init__(f"placement wait: need {width} device(s), "
                         f"{free} free")
        self.width = width
        self.free = free


@dataclasses.dataclass(frozen=True)
class DeviceTopology:
    """Device ids grouped by locality domain (host/process).

    ``groups`` is a tuple of id-tuples; ids are globally unique.  A lease
    prefers to fit inside one group (cross-group submeshes are the
    multi-host regime — allowed, but only after single-group placement
    fails).
    """

    groups: Tuple[Tuple[int, ...], ...]

    def __post_init__(self):
        ids = list(itertools.chain.from_iterable(self.groups))
        if not ids:
            raise ValueError("topology has no devices")
        if len(set(ids)) != len(ids):
            raise ValueError(f"duplicate device ids in topology: {ids}")

    @property
    def ids(self) -> Tuple[int, ...]:
        return tuple(itertools.chain.from_iterable(self.groups))

    @property
    def num_devices(self) -> int:
        return sum(len(g) for g in self.groups)

    @classmethod
    def from_host(cls) -> "DeviceTopology":
        """The slots of this process's rank pool when one is open (the
        shard_map sessions' slots: one H100 holds as many ranks as the
        pool has), else the host's CUDA devices
        (``torch.cuda.device_count()``), in one group; one slot on a host
        without a card."""
        from ..launch.spawn import current_rank_pool
        pool = current_rank_pool()
        if pool is not None:
            return cls(groups=(tuple(range(pool.world)),))
        import torch
        return cls(groups=(tuple(range(max(torch.cuda.device_count(), 1))),))

    @classmethod
    def parse(cls, spec: str) -> "DeviceTopology":
        """CLI grammar: ``"auto"`` → :meth:`from_host`; ``"N"`` → one group
        of N abstract ids; ``"GxN"`` → G groups of N (e.g. ``"2x4"``)."""
        spec = spec.strip().lower()
        if spec in ("auto", "host"):
            return cls.from_host()
        if "x" in spec:
            g_s, n_s = spec.split("x", 1)
            g, n = int(g_s), int(n_s)
        else:
            g, n = 1, int(spec)
        if g < 1 or n < 1:
            raise ValueError(f"topology spec {spec!r} must be positive")
        return cls(groups=tuple(tuple(range(i * n, (i + 1) * n))
                                for i in range(g)))


@dataclasses.dataclass(frozen=True)
class Lease:
    """A carved submesh: ``width`` device ids, disjoint from every other
    live lease of the pool that issued it."""

    lid: int
    ids: Tuple[int, ...]

    @property
    def width(self) -> int:
        return len(self.ids)


class DevicePool:
    """Lease/release bookkeeping over a :class:`DeviceTopology`.

    Invariants (property-tested for the reference in
    ``tests/test_placement.py``; the port agrees with it call for call):

    * live leases are pairwise disjoint;
    * ``free + in_use == capacity`` at all times, and lease → release
      round-trips restore ``free`` exactly;
    * no lease is ever carved outside the topology's ids.
    """

    def __init__(self, topology: "DeviceTopology | int | Sequence[int]"):
        if isinstance(topology, int):
            topology = DeviceTopology(groups=(tuple(range(topology)),))
        elif not isinstance(topology, DeviceTopology):
            topology = DeviceTopology(groups=(tuple(topology),))
        self.topology = topology
        self._free: List[int] = list(topology.ids)
        self._leases: Dict[int, Lease] = {}
        self._next_lid = 0

    # ------------------------------------------------------------- queries
    @property
    def capacity(self) -> int:
        return self.topology.num_devices

    @property
    def free(self) -> int:
        return len(self._free)

    @property
    def in_use(self) -> int:
        return self.capacity - self.free

    @property
    def leases(self) -> Tuple[Lease, ...]:
        return tuple(self._leases.values())

    def free_ids(self) -> Tuple[int, ...]:
        return tuple(sorted(self._free))

    # ------------------------------------------------------------- leasing
    def _take(self, ids: Sequence[int]) -> Lease:
        for i in ids:
            self._free.remove(i)
        lease = Lease(lid=self._next_lid, ids=tuple(ids))
        self._next_lid += 1
        self._leases[lease.lid] = lease
        return lease

    def _carve(self, width: int) -> Optional[List[int]]:
        """Pick ``width`` free ids: aligned block in one group → contiguous
        run in one group → any free ids in one group → span groups."""
        free = set(self._free)
        for group in self.topology.groups:
            # whole aligned blocks first (keeps halves of a host intact)
            for i in range(0, len(group) - width + 1, width):
                block = group[i:i + width]
                if free.issuperset(block):
                    return list(block)
        for group in self.topology.groups:
            for i in range(len(group) - width + 1):
                block = group[i:i + width]
                if free.issuperset(block):
                    return list(block)
        for group in self.topology.groups:
            avail = sorted(free.intersection(group))
            if len(avail) >= width:
                return avail[:width]
        if len(free) >= width:        # cross-group (multi-host) fallback
            return sorted(free)[:width]
        return None

    def lease(self, width: int,
              prefer: Optional[Iterable[int]] = None) -> Lease:
        """Carve a disjoint width-``width`` submesh; raises
        :exc:`PlacementWait` when fewer than ``width`` ids are free.

        ``prefer`` re-leases an exact id set when every id is free (how a
        resumed session gets *equivalent* devices back — same ids if
        available, same width otherwise)."""
        if width < 1:
            raise ValueError(f"lease width must be >= 1, got {width}")
        if width > self.capacity:
            raise ValueError(f"lease width {width} exceeds pool capacity "
                             f"{self.capacity}")
        if prefer is not None:
            ids = tuple(prefer)
            if len(ids) == width and set(ids) <= set(self._free):
                return self._take(ids)
        picked = self._carve(width)
        if picked is None:
            raise PlacementWait(width, self.free)
        return self._take(picked)

    def release(self, lease: Lease) -> None:
        stored = self._leases.pop(lease.lid, None)
        if stored is None:
            raise ValueError(f"lease {lease.lid} is not live in this pool")
        # free the POOL's record of the lease, not the caller's argument — a
        # stale pre-resize Lease object must not double-free resized-away
        # ids (that would hand the same device to two "disjoint" leases).
        self._free.extend(stored.ids)

    def resize(self, lease: Lease, new_width: int) -> Lease:
        """Shrink or grow a live lease in place (same lid namespace).

        Shrinking keeps the lease's **leading** ids and frees the tail —
        exactly the submesh a W → W′ elastic re-shard keeps running on.
        Growing claims additional free ids (contiguous after the lease when
        possible) and raises :exc:`PlacementWait` when the pool cannot
        supply them."""
        if lease.lid not in self._leases:
            raise ValueError(f"lease {lease.lid} is not live in this pool")
        lease = self._leases[lease.lid]   # stale args resolve to live state
        if new_width < 1:
            raise ValueError(f"new_width must be >= 1, got {new_width}")
        if new_width == lease.width:
            return lease
        if new_width < lease.width:
            keep, drop = lease.ids[:new_width], lease.ids[new_width:]
            self._free.extend(drop)
            new = Lease(lid=lease.lid, ids=keep)
            self._leases[lease.lid] = new
            return new
        extra = new_width - lease.width
        free = set(self._free)
        tail = lease.ids[-1]
        contiguous = [i for i in range(tail + 1, tail + 1 + extra)
                      if i in free]
        picked = contiguous if len(contiguous) == extra else \
            sorted(free)[:extra]
        if len(picked) < extra:
            raise PlacementWait(extra, self.free)
        for i in picked:
            self._free.remove(i)
        new = Lease(lid=lease.lid, ids=lease.ids + tuple(picked))
        self._leases[lease.lid] = new
        return new


def lease_devices(ids: Iterable[int], ranks=None) -> list:
    """The device of each leased id, in lease order: on a rank pool
    (``ranks``, else the current one) slot i is rank i, on
    ``cuda:(i % device_count)`` or the CPU for a CPU pool; without one,
    ``torch.device("cuda:i")``.

    Raises with the available ids when a leased id is not present — the
    placement was recorded for a differently-provisioned machine (e.g. a
    checkpoint resumed without re-leasing through the pool)."""
    import torch
    from ..launch.spawn import current_rank_pool
    pool = ranks if ranks is not None else current_rank_pool()
    ids = list(ids)
    if pool is not None:
        missing = [i for i in ids if not 0 <= i < pool.world]
        if missing:
            raise RuntimeError(
                f"leased slot ids {missing} are not ranks of the rank pool "
                f"(ranks 0..{pool.world - 1}) — re-lease through the "
                f"DevicePool instead of reusing a recorded placement verbatim")
        return [pool.slot_device(i) for i in ids]
    have = range(torch.cuda.device_count())
    missing = [i for i in ids if i not in have]
    if missing:
        raise RuntimeError(
            f"leased device ids {missing} not present on this host "
            f"(available: {list(have)}) — re-lease through the "
            f"DevicePool instead of reusing a recorded placement verbatim")
    return [torch.device("cuda", i) for i in ids]


@dataclasses.dataclass(frozen=True)
class PressurePolicy:
    """When the scheduler trades session width for admission throughput.

    *Shrink*: while the queue's head cannot be placed and some in-flight
    SHARED_FRAME session is wider than ``min_world``, halve the widest one
    (W → W/2 keeps W′ dividing the logical width, so the re-shard is always
    legal) — per-worker memory rises Θ(n/W) → Θ(n/W′) but ``W/2`` devices
    free up for the queued query.

    *Regrow*: when the queue is drained and devices sit free, grow shrunk
    sessions back toward their logical width (doubling steps), reclaiming
    the parallelism the shrink gave away.

    Both transformations go through :func:`repro_torch.serve.elastic.
    reshard_session`, so the session's (τ, estimate) trajectory is
    **bit-identical** to never having been resized at all.
    """

    min_world: int = 1
    regrow: bool = True

    @classmethod
    def parse(cls, spec: str) -> "Optional[PressurePolicy]":
        """CLI grammar: ``"none"`` → None; ``"shrink"`` (no regrow);
        ``"shrink-regrow"``; optional ``":min=N"`` suffix."""
        spec = spec.strip().lower()
        if spec in ("", "none", "off"):
            return None
        base, _, opt = spec.partition(":")
        if base not in ("shrink", "shrink-regrow"):
            raise ValueError(f"unknown pressure policy {spec!r} "
                             f"(none | shrink | shrink-regrow[:min=N])")
        min_world = 1
        if opt:
            key, _, val = opt.partition("=")
            if key != "min":
                raise ValueError(f"unknown pressure option {opt!r}")
            min_world = int(val)
        return cls(min_world=min_world, regrow=base == "shrink-regrow")
