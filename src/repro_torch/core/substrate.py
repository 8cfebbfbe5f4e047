"""Execution substrates — where the epoch engine's W workers run.

Port of :mod:`repro.core.substrate`:

SEQUENTIAL   W = 1, identity collectives — the correctness oracle.
VMAP         W virtual workers on one device, as a leading W dimension;
             the sums over W go through the ``frame_accum`` kernel.
SHARD_MAP    W worker processes on ``torch.distributed``, rank r holding
             worker r (:mod:`repro_torch.core.distributed`): all-reduce for
             LOCK, BARRIER and LOCAL_FRAME, reduce-scatter for
             SHARED_FRAME (grouped reduce-scatter + cross-group all-reduce
             when F < W), all-gather for INDEXED_FRAME, one all-reduce a
             verdict (:func:`~repro_torch.core.frames.process_collectives`).

Worker streams and INDEXED_FRAME frame indices do not depend on the
substrate, and frames are integer, so every substrate gives bit-identical
τ, data and estimate at the same (instance, strategy, W, F, seed)
(:func:`repro_torch.core.conformance.run_substrate_equivalence`).

SHARD_MAP runs inside a worker group: every rank calls the same entry
point with the same arguments, and gets the final state gathered into
VMAP's layout.  Start the ranks with
:func:`repro_torch.launch.spawn.spawn_workers` (or join a group with
:func:`repro_torch.core.distributed.init_worker_group`) — NCCL for one rank
a card, gloo for CPU ranks and for ranks that share a card.

:class:`EpochStepper` drives the engine one epoch at a time from the host
(the serving path); :func:`run_on_substrate` is its run to the end.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

from .distributed import WorkerGroup, current_worker_group
from .epoch import (EpochConfig, EpochProgram, EpochState, make_program,
                    state_to_tree)
from .frames import (process_collectives, sequential_collectives,
                     virtual_collectives)

WORKER_AXIS = "workers"


class Substrate(enum.Enum):
    SEQUENTIAL = "sequential"
    VMAP = "vmap"
    SHARD_MAP = "shard_map"


def resolve_substrate(substrate, world: int = 1) -> Substrate:
    """Normalize a substrate spec; ``None`` → sequential at W=1, vmap
    otherwise."""
    if substrate is None:
        return Substrate.SEQUENTIAL if world == 1 else Substrate.VMAP
    return Substrate(substrate) if isinstance(substrate, str) else substrate


_LAUNCH = ("start W ranks with repro_torch.launch.spawn.spawn_workers(fn, W, "
           "backend=..., device=...) and call the entry point in each, or "
           "join one with repro_torch.core.distributed.init_worker_group")


def unavailable_reason(substrate, world: int,
                       group: Optional[WorkerGroup] = None) -> Optional[str]:
    """Why ``substrate`` cannot run ``world`` workers here (None = it can).
    SHARD_MAP runs in a worker group of exactly ``world`` ranks: ``group``,
    or else this process's current one."""
    sub = resolve_substrate(substrate, world)
    if sub == Substrate.SEQUENTIAL and world != 1:
        return f"sequential substrate is the W=1 oracle (got W={world})"
    if sub == Substrate.SHARD_MAP:
        group = group or current_worker_group()
        if group is None:
            return f"shard_map runs in a worker group of {world} ranks and " \
                   f"this process holds none: {_LAUNCH}"
        if group.world != world:
            return f"shard_map with W={world} needs a worker group of " \
                   f"{world} ranks; this one has {group.world}: {_LAUNCH}"
    return None


def available_substrates(world: int,
                         group: Optional[WorkerGroup] = None) -> tuple:
    """The substrates that can execute ``world`` workers here."""
    return tuple(s for s in Substrate
                 if unavailable_reason(s, world, group) is None)


def worker_group(world: int,
                 group: Optional[WorkerGroup] = None) -> WorkerGroup:
    """The worker group SHARD_MAP runs ``world`` workers on: ``group`` or
    this process's current one, which must have ``world`` ranks (raises
    ``RuntimeError`` saying how to launch otherwise).  In place of the
    reference's ``worker_mesh``."""
    reason = unavailable_reason(Substrate.SHARD_MAP, world, group)
    if reason is not None:
        raise RuntimeError(reason)
    return group or current_worker_group()


def group_and_device(substrate, world: int, device=None,
                     group: Optional[WorkerGroup] = None) -> tuple:
    """(group, device) of a run: on SHARD_MAP the checked worker group and
    by default its rank's device; elsewhere no group and ``device``."""
    if resolve_substrate(substrate, world) != Substrate.SHARD_MAP:
        return None, device
    group = worker_group(world, group)
    return group, group.device if device is None else device


@dataclasses.dataclass(frozen=True)
class EpochStepper:
    """Single-epoch stepping of the engine on a substrate (serving path).

    ``init(seed)`` returns the primed epoch-0 state, ``step(state, seed)``
    advances it one epoch (consuming it: its generators move on),
    ``active(state)`` is the continuation predicate and ``run(seed)`` steps
    to the end.  The seed is an argument of ``init``/``step``, so one
    stepper serves every seed of a shape (instance × strategy × W × F ×
    substrate × fold).  ``state_template()`` is a state of the same layout
    that nothing has sampled into — the shape of a checkpoint.

    ``gathered(step^n(init(seed)))`` is :func:`run_on_substrate`'s result
    bit for bit: the run to the end is this loop.  On SHARD_MAP a state
    holds this rank's worker; ``gathered`` brings it into VMAP's layout
    (the identity on the other substrates).  ``pull`` gives the tree of
    the workers this process holds (a checkpoint's tree, VMAP's layout
    when it holds all W; on SHARD_MAP the ranks' trees join into it,
    :func:`~repro_torch.core.epoch.join_held`), and ``push`` the state
    from such rows (:func:`~repro_torch.core.epoch.held_tree`).
    """

    substrate: Substrate
    world: int
    cfg: EpochConfig
    fold: Optional[int]
    program: EpochProgram = dataclasses.field(repr=False)
    init_carry: Any = dataclasses.field(default=None, repr=False)

    def init(self, seed: int) -> EpochState:
        return self.program.init(self.init_carry, seed)

    def step(self, state: EpochState, seed: int) -> EpochState:
        return self.program.body(state, seed)

    def active(self, state: EpochState) -> bool:
        return self.program.cond(state)

    def run(self, seed: int) -> EpochState:
        st = self.init(seed)
        while self.active(st):
            st = self.step(st, seed)
        return st

    def gathered(self, state: EpochState) -> EpochState:
        return self.program.gather(state)

    def state_template(self) -> EpochState:
        return self.program.blank(self.init_carry)

    def pull(self, state: EpochState) -> EpochState:
        return state_to_tree(state)

    def push(self, part: EpochState) -> EpochState:
        return self.program.push(part)


def make_stepper(sample_fn, check_fn, template, init_carry, world: int,
                 cfg: EpochConfig, *, substrate=None, frame_shards: int = 0,
                 fold: Optional[int] = None,
                 group: Optional[WorkerGroup] = None) -> EpochStepper:
    """Build an :class:`EpochStepper` for one engine configuration.

    With ``fold = k`` the W physical workers carry W·k logical streams,
    physical worker p the streams p·k … p·k+k−1, seeded as the streams of
    an unfolded run with W·k workers (see :func:`make_program`).

    SHARD_MAP runs on ``group`` (else this process's current worker
    group), which must have ``world`` ranks; the template and the sampler
    live on the rank's device.
    """
    sub = resolve_substrate(substrate if substrate is not None
                            else cfg.substrate, world)
    if sub == Substrate.SHARD_MAP:
        colls = process_collectives(worker_group(world, group), frame_shards)
    elif sub == Substrate.SEQUENTIAL:
        if world != 1:
            raise ValueError(f"sequential substrate is the W=1 oracle "
                             f"(got W={world})")
        colls = sequential_collectives()
    else:
        colls = virtual_collectives(world, frame_shards)
    prog = make_program(sample_fn, check_fn, template, cfg, colls, fold=fold)
    return EpochStepper(substrate=sub, world=world, cfg=cfg, fold=fold,
                        program=prog, init_carry=init_carry)


def run_on_substrate(sample_fn, check_fn, template, init_carry, seed: int,
                     world: int, cfg: EpochConfig, *, substrate=None,
                     frame_shards: int = 0,
                     group: Optional[WorkerGroup] = None) -> EpochState:
    """Run the epoch engine to its end on the chosen substrate; the final
    state is in VMAP's layout on every substrate (on SHARD_MAP, on every
    rank)."""
    stepper = make_stepper(sample_fn, check_fn, template, init_carry, world,
                           cfg, substrate=substrate, frame_shards=frame_shards,
                           group=group)
    return stepper.gathered(stepper.run(seed))
