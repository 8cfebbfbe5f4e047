"""Elastic re-sharding: resume a session at a different worker width.
Port of :mod:`repro.serve.elastic`.

A SHARED_FRAME session started at logical width W can go on on W′
physical workers for any W′ | W:

1. the consistent total is reassembled from the old shard layout
   (:func:`repro_torch.core.adaptive.reassemble_shared`) and re-scattered
   into W′ contiguous shards of n/W′ each;
2. the W logical generators keep their order and are folded k = W/W′ per
   physical worker (``core/epoch.make_program(fold=k)``), so every logical
   stream goes on where it left off; they are copies, so the old state and
   the new one share no generator;
3. the pending deltas are redistributed, sum-preservingly (⊕ is exact over
   integer frames, and the next reduce-scatter reads only their sum).

The global delta of each epoch and the verdict are unchanged, so the
resumed run's (τ, estimate) is bit-identical to the uninterrupted W-worker
run.

Also home to :func:`elastic_restore`, the restore of a checkpoint through a
:class:`~repro_torch.checkpoint.manager.CheckpointManager`.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.manager import CheckpointManager
from ..core.adaptive import reassemble_shared
from ..core.epoch import EpochState
from ..core.frames import FrameStrategy, StateFrame, tree_map
from .session import AdaptiveSession, SessionSpec, StepperCache

PyTree = Any


def elastic_restore(manager: CheckpointManager, tree_like: PyTree,
                    device=None) -> Optional[Tuple[int, PyTree, dict]]:
    """Restore the latest checkpoint onto ``device`` (each leaf on its
    tree_like leaf's device when None).  Returns (step, tree, meta) or
    None.  The chunks are keyed by global slices, so the world size may
    change between the save and the restore."""
    return manager.restore_latest(tree_like, device=device)


def clone_generator(gen: torch.Generator) -> torch.Generator:
    """A new generator at ``gen``'s position, sharing nothing with it."""
    out = torch.Generator(device=gen.device)
    out.set_state(gen.get_state())
    return out


def _redistribute(stacked: torch.Tensor, new_world: int) -> torch.Tensor:
    """Regroup per-worker leaves (P, ...) into (W′, ...) preserving the sum
    along axis 0 — old worker i's contribution lands on new worker i mod W′.
    Handles both down-scale (P > W′: fold-sum) and up-scale (P < W′:
    zero-pad)."""
    P = stacked.shape[0]
    pad = (-P) % new_world
    if pad:
        stacked = torch.cat([stacked, stacked.new_zeros((pad,
                                                         *stacked.shape[1:]))])
    return stacked.reshape(stacked.shape[0] // new_world, new_world,
                           *stacked.shape[1:]).sum(
        dim=0, dtype=stacked.dtype)


def _rescatter(x: torch.Tensor, world: int, frame_shards: int,
               new_world: int) -> torch.Tensor:
    """One leaf of a SHARED_FRAME total, stacked (W, n/F, ...), as W′
    contiguous shards (W′, n/W′, ...); a per-worker scalar leaf (W,) is
    tiled to (W′,)."""
    full = torch.from_numpy(np.asarray(reassemble_shared(
        x.cpu().numpy(), world, frame_shards))).to(x.device)
    if full.dim() == 0:
        return full.expand(new_world).clone()
    assert full.shape[0] % new_world == 0, (tuple(full.shape), new_world)
    return full.reshape(new_world, full.shape[0] // new_world,
                        *full.shape[1:])


def reshard_state(state: EpochState, *, old_spec: SessionSpec,
                  new_spec: SessionSpec, template_state: EpochState
                  ) -> EpochState:
    """A SHARED_FRAME state moved from the old physical layout to the new
    one (see the module docstring).  ``template_state`` (the new stepper's
    :meth:`~repro_torch.core.substrate.EpochStepper.state_template`) gives
    the new aux layout: aux is zeroed, the next check recomputes it."""
    P, W2 = old_spec.world, new_spec.world
    F_old = old_spec.frame_shards or P
    total = StateFrame(
        num=state.total.num.clone(),
        data=tree_map(lambda x: _rescatter(x, P, F_old, W2),
                      state.total.data))
    pending = StateFrame(
        num=_redistribute(state.pending.num, W2),
        data=tree_map(lambda x: _redistribute(x, W2), state.pending.data))
    return EpochState(gens=[clone_generator(g) for g in state.gens],
                      carry=state.carry, total=total, pending=pending,
                      stop=state.stop, aux=template_state.aux,
                      epoch=state.epoch, stop_epoch=state.stop_epoch)


def reshard_session(session: AdaptiveSession, new_world: int, *,
                    substrate: Optional[str] = None,
                    placement: Optional[tuple] = None,
                    cache: Optional[StepperCache] = None) -> AdaptiveSession:
    """Resume ``session`` on ``new_world`` physical workers (SHARED_FRAME).

    ``new_world`` must divide the session's logical width; the returned
    session continues the identical logical trajectory — per-worker shard
    memory becomes Θ(n/W′) — and its final (τ, estimate) is bit-identical
    to the uninterrupted original run.  ``placement`` pins it to device
    ids and implies ``substrate="shard_map"``, whose pool sessions wait for
    the pool's process-group sessions (ROADMAP queue 1 item 9).
    """
    spec = session.spec
    if spec.frame_strategy != FrameStrategy.SHARED_FRAME:
        raise ValueError("elastic re-sharding is defined for SHARED_FRAME "
                         f"sessions (got {spec.strategy!r})")
    if not session.started:
        raise ValueError("session has no state to reshard; start() it or "
                         "restore a checkpoint first")
    lw = spec.logical_world or spec.world
    if lw % new_world != 0:
        raise ValueError(f"new_world={new_world} must divide the session's "
                         f"logical world {lw}")
    if placement is not None:
        substrate = "shard_map"
    new_spec = dataclasses.replace(
        spec, world=new_world, logical_world=lw,
        frame_shards=0,            # one contiguous shard per new worker
        placement=None if placement is None else tuple(placement),
        substrate=substrate if substrate is not None else
        (None if new_world != spec.world else spec.substrate))
    resharded = AdaptiveSession.create(
        new_spec, cache=cache,
        device=session.device if cache is None else None)
    resharded.state = reshard_state(
        session.state, old_spec=spec, new_spec=new_spec,
        template_state=resharded.stepper.state_template())
    resharded.wall_s = session.wall_s
    return resharded
