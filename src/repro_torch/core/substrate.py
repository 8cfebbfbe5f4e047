"""Execution substrates — where the epoch engine's W workers run.

Port of :mod:`repro.core.substrate`:

SEQUENTIAL   W = 1, identity collectives — the correctness oracle.
VMAP         W virtual workers on one device, as a leading W dimension;
             the sums over W go through the ``frame_accum`` kernel.
SHARD_MAP    W real devices — queued (``torch.distributed``), raises.

Worker streams and INDEXED_FRAME frame indices do not depend on the
substrate, so SEQUENTIAL and VMAP at W = 1 give bit-identical results.

:class:`EpochStepper` drives the engine one epoch at a time from the host
(the serving path); :func:`run_on_substrate` is its run to the end.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Any, Optional

from .epoch import EpochConfig, EpochProgram, EpochState, make_program
from .frames import sequential_collectives, virtual_collectives

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

    ``step^n(init(seed))`` is :func:`run_on_substrate`'s result bit for
    bit: the run to the end is this loop.
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

    def state_template(self) -> EpochState:
        return self.program.blank(self.init_carry)


def make_stepper(sample_fn, check_fn, template, init_carry, world: int,
                 cfg: EpochConfig, *, substrate=None, frame_shards: int = 0,
                 fold: Optional[int] = None) -> EpochStepper:
    """Build an :class:`EpochStepper` for one engine configuration.

    With ``fold = k`` the W physical workers carry W·k logical streams,
    physical worker p the streams p·k … p·k+k−1, seeded as the streams of
    an unfolded run with W·k workers (see :func:`make_program`).
    """
    sub = resolve_substrate(substrate if substrate is not None
                            else cfg.substrate, world)
    if sub == Substrate.SHARD_MAP:
        raise NotImplementedError("the shard_map substrate is queued: "
                                  "ROADMAP queue 1 item 8")
    if sub == Substrate.SEQUENTIAL:
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
                     frame_shards: int = 0) -> EpochState:
    """Run the epoch engine to its end on the chosen substrate."""
    return make_stepper(sample_fn, check_fn, template, init_carry, world, cfg,
                        substrate=substrate,
                        frame_shards=frame_shards).run(seed)
