"""Generic adaptive-sampling entry point — the public API of Algorithm 1/2.

Port of :mod:`repro.core.adaptive`::

    result = run_adaptive(sample_fn, check_fn, template=torch.zeros(n),
                          strategy="local", world=4, rounds_per_epoch=4)

With ``substrate="shard_map"`` every rank of a worker group of ``world``
ranks makes the same call (the group in place of the reference's
``mesh``/``mesh_axis``) and gets the same result.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

from ..device import resolve_device
from .epoch import EpochConfig, EpochState, rounds_for_world
from .frames import FrameStrategy, tree_map
from .substrate import group_and_device, resolve_substrate, run_on_substrate


@dataclasses.dataclass(frozen=True)
class AdaptiveResult:
    data: Any          # consistent accumulated data (full, unsharded), numpy
    num: int           # τ — samples in the checked state
    stopped: bool
    epochs: int
    stop_epoch: int
    aux: Any
    state: EpochState


def reassemble_shared(x, world: int, frame_shards: int) -> np.ndarray:
    """Glue the stacked ``(W, n/F, ...)`` SHARED_FRAME shards of one leaf back
    into the full ``(n, ...)`` vector, after checking that the W/F redundant
    groups agree; shard i is taken from group ``i % (W/F)``."""
    a = np.asarray(x)
    if a.ndim <= 1:  # per-worker scalar leaf — fully reduced
        return a[0] if a.ndim == 1 else a
    F = frame_shards or world
    groups = world // F
    shards = a.reshape(groups, F, *a.shape[1:])
    for g in range(1, groups):
        if not np.array_equal(shards[g], shards[0]):
            raise AssertionError(
                f"SHARED_FRAME redundant groups disagree (group {g} vs 0, "
                f"W={world}, F={F})")
    picked = np.stack([shards[i % groups, i] for i in range(F)])
    return picked.reshape(F * a.shape[1], *a.shape[2:])


def result_from_state(st: EpochState, *, strategy: FrameStrategy, world: int,
                      frame_shards: int = 0) -> AdaptiveResult:
    """The consistent :class:`AdaptiveResult` of a final engine state."""
    if strategy == FrameStrategy.SHARED_FRAME:
        data = tree_map(lambda x: reassemble_shared(x.cpu().numpy(), world,
                                                    frame_shards), st.total.data)
    else:
        data = tree_map(lambda x: x.cpu().numpy(), st.total.data)
    return AdaptiveResult(data=data, num=int(st.total.num.item()),
                          stopped=bool(st.stop), epochs=int(st.epoch),
                          stop_epoch=int(st.stop_epoch), aux=st.aux, state=st)


def run_adaptive(sample_fn, check_fn, template, *,
                 strategy="local", world: int = 1, seed: int = 0,
                 rounds_per_epoch: int = 4, max_epochs: int = 10_000,
                 xi: float = 0.0, round_batch: int = 1, init_carry=None,
                 substrate=None, frame_shards: int = 0,
                 device=None, group=None) -> AdaptiveResult:
    """Run the adaptive loop to its end.  ``template`` (a tensor or a dict
    of tensors) is moved to ``device`` (``None`` → the CUDA card, or on
    SHARD_MAP the rank's device).  SHARD_MAP runs on ``group``, else this
    process's current worker group."""
    sub = resolve_substrate(substrate, world)
    group, device = group_and_device(sub, world, device, group)
    device = resolve_device(device)
    template = tree_map(lambda x: x.to(device), template)
    strat = FrameStrategy(strategy) if isinstance(strategy, str) else strategy
    rounds = rounds_for_world(rounds_per_epoch * round_batch, round_batch,
                              world, xi) if xi else rounds_per_epoch
    cfg = EpochConfig(strategy=strat, rounds_per_epoch=rounds,
                      max_epochs=max_epochs, xi=xi, substrate=sub.value)
    st = run_on_substrate(sample_fn, check_fn, template, init_carry, seed,
                          world, cfg, substrate=sub, frame_shards=frame_shards,
                          group=group)
    return result_from_state(st, strategy=strat, world=world,
                             frame_shards=frame_shards)
