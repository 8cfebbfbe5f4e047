"""Execution substrates — where the epoch engine's W workers run.

Port of :mod:`repro.core.substrate`:

SEQUENTIAL   W = 1, identity collectives — the correctness oracle.
VMAP         W virtual workers on one device, as a leading W dimension;
             the sums over W go through the ``frame_accum`` kernel.
SHARD_MAP    W real devices — queued (``torch.distributed``), raises.

Worker streams and INDEXED_FRAME frame indices do not depend on the
substrate, so SEQUENTIAL and VMAP at W = 1 give bit-identical results.
"""

from __future__ import annotations

import enum

from .epoch import EpochConfig, EpochState, make_program
from .frames import sequential_collectives, virtual_collectives


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


def run_on_substrate(sample_fn, check_fn, template, init_carry, seed: int,
                     world: int, cfg: EpochConfig, *, substrate=None,
                     frame_shards: int = 0) -> EpochState:
    """Run the epoch engine to its end on the chosen substrate."""
    sub = resolve_substrate(substrate if substrate is not None
                            else cfg.substrate, world)
    if sub == Substrate.SHARD_MAP:
        raise NotImplementedError("queued: ROADMAP queue 1 item 8")
    if sub == Substrate.SEQUENTIAL:
        if world != 1:
            raise ValueError(f"sequential substrate is the W=1 oracle "
                             f"(got W={world})")
        colls = sequential_collectives()
    else:
        colls = virtual_collectives(world, frame_shards)
    prog = make_program(sample_fn, check_fn, template, cfg, colls, seed=seed)
    st = prog.init(init_carry)
    while prog.cond(st):
        st = prog.body(st)
    return st
