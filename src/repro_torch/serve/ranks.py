"""The pool's process-group sessions: shard_map sessions whose W workers
are held by W ranks of a :class:`~repro_torch.launch.spawn.RankPool`.

The reference's pool runs a shard_map session on the devices of its lease
from one process.  Here the pool (the controller) keeps each session's
state on the lease's ranks, worker p on the p-th smallest leased slot id,
and drives it with the entries below; the controller holds a
:class:`RankState` (the session id and what the last reply said) and
builds no instance itself.

Rank side (module-level entries, run by the ranks): ``make_groups`` (every
rank of the pool: the lease's process groups, and its block groups when
F < W), ``bind`` (the lease's ranks build the instance and the stepper
once per :meth:`~repro_torch.serve.session.SessionSpec.stepper_key`),
``start``, ``step``, ``result``, ``pull``, ``push``, ``template`` and
``drop``.  Every reply of ``start``, ``step`` and ``push`` carries
(active, stop, epoch, stop_epoch, τ), so the controller reads ``done``,
``epoch`` and ``tau`` without another round trip.

Controller side: :class:`RankStepper`, the stepper of one session shape
on one lease.  ``pull`` brings a state to the controller as the
checkpoint tree of a VMAP session of the same spec (each rank sends its
rows, generators included, and the controller joins them); ``push`` sends
each rank its rows of such a tree.  Checkpoints,
reshards and rebinds go through these two, so a shard_map session's
trajectory is a VMAP session's bit for bit.
"""

from __future__ import annotations

import dataclasses
import itertools
from typing import Dict, Tuple

import numpy as np
import torch

from ..core.adaptive import AdaptiveResult, result_from_state
from ..core.distributed import lease_group, process_group
from ..core.epoch import (EpochConfig, EpochState, held_tree, join_held,
                          map_tree)
from ..core.frames import FrameStrategy, shard_groups
from ..core.substrate import make_stepper

# -- rank side -------------------------------------------------------------

# stepper_key → (spec, built instance, stepper, lease group)
_STEPPERS: Dict[tuple, tuple] = {}
# session id → (stepper_key, state of the held worker)
_STATES: Dict[int, Tuple[tuple, EpochState]] = {}


def _numpy(tree):
    return map_tree(lambda x: x.cpu().numpy(), tree)


def _summary(stepper, st: EpochState) -> tuple:
    return (stepper.active(st), bool(st.stop), int(st.epoch),
            int(st.stop_epoch), int(st.total.num.item()))


def make_groups(group, ids, frame_shards: int) -> None:
    """Every rank of the pool: the process group of the lease ``ids`` and,
    for F = ``frame_shards`` < W, its within and across block groups."""
    ranks = tuple(sorted(ids))
    lease_group(ranks)
    W = len(ranks)
    F = frame_shards or W
    if F < W:
        within, across = shard_groups(W, F)
        for block in within + across:
            process_group([ranks[p] for p in block], group.timeout)


def bind(group, key, spec, instance, ids) -> None:
    """The lease's ranks: build ``instance`` for ``spec`` on the rank's
    device and its stepper on the lease's group (once per key)."""
    if key in _STEPPERS:
        return
    from ..launch.mesh import make_worker_group
    lease = make_worker_group(spec.world, devices=ids)
    lw = spec.logical_world or spec.world
    built = instance.build(world=lw, strategy=spec.frame_strategy,
                           device=lease.device)
    cfg = EpochConfig(strategy=spec.frame_strategy,
                      rounds_per_epoch=built.rounds_per_epoch,
                      max_epochs=built.max_epochs)
    stepper = make_stepper(built.sample_fn, built.check_fn, built.template,
                           built.init_carry, spec.world, cfg,
                           substrate="shard_map",
                           frame_shards=spec.frame_shards, fold=spec.fold,
                           group=lease)
    _STEPPERS[key] = (spec, built, stepper, lease)


def start(group, sid: int, key, seed: int) -> tuple:
    stepper = _STEPPERS[key][2]
    st = stepper.init(seed)
    _STATES[sid] = (key, st)
    return _summary(stepper, st)


def step(group, sid: int, seed: int) -> tuple:
    key, st = _STATES[sid]
    stepper = _STEPPERS[key][2]
    if stepper.active(st):
        st = stepper.step(st, seed)
        _STATES[sid] = (key, st)
    return _summary(stepper, st)


def result(group, sid: int):
    """(estimate, AdaptiveResult) of the session's consistent state, from
    the lease's first rank (``None`` from the others)."""
    key, st = _STATES[sid]
    spec, built, stepper, lease = _STEPPERS[key]
    res = result_from_state(stepper.gathered(st),
                            strategy=spec.frame_strategy, world=spec.world,
                            frame_shards=spec.frame_shards)
    if lease.rank != 0:
        return None
    est = built.estimate(built.trim(res.data), float(max(res.num, 1)))
    return np.asarray(est), dataclasses.replace(res, aux=_numpy(res.aux),
                                                state=None)


def pull(group, sid: int):
    """The rank's rows of the session's checkpoint tree, as numpy."""
    key, st = _STATES[sid]
    return _numpy(_STEPPERS[key][2].pull(st))


def template(group, key):
    """The rank's rows of a blank state's tree (the checkpoint's layout)."""
    stepper = _STEPPERS[key][2]
    return _numpy(stepper.pull(stepper.state_template()))


def push(group, sid: int, key, part) -> tuple:
    """Hold the rank's rows ``part`` of a tree (:func:`held_tree`) as the
    state of session ``sid``."""
    stepper = _STEPPERS[key][2]
    st = stepper.push(part)
    _STATES[sid] = (key, st)
    return _summary(stepper, st)


def drop(group, sid: int) -> None:
    _STATES.pop(sid, None)


def held_sessions(group) -> int:
    """How many session states this rank holds."""
    return len(_STATES)


# -- controller side -------------------------------------------------------

_SIDS = itertools.count()


@dataclasses.dataclass(frozen=True)
class RankState:
    """The controller's handle on a state held by ranks, with what the
    last reply said of it."""

    sid: int
    active: bool
    stop: bool
    epoch: int
    stop_epoch: int
    tau: int


def _torch(tree):
    return map_tree(lambda x: torch.from_numpy(np.array(x)), tree)


class RankStepper:
    """The stepper of one shard_map session shape on one lease of a rank
    pool, driven from the controller: the ``EpochStepper`` calls the
    session makes (``init``, ``step``, ``active``, ``state_template``,
    ``pull``, ``push``), each a round trip to the lease's ranks, plus
    ``send_step``/``finish_step`` (a step sent, its reply read later) and
    ``result`` and ``drop``.  ``spec.placement`` is the lease (``None``:
    the pool's leading ``world`` ranks)."""

    def __init__(self, pool, spec):
        from ..core.instances import get_instance
        from .placement import lease_devices
        ids = spec.placement if spec.placement is not None \
            else tuple(range(spec.world))
        lease_devices(ids, ranks=pool)  # raises on ids the pool lacks
        self.pool = pool
        self.spec = spec
        self.key = spec.stepper_key()
        self.ids = tuple(sorted(ids))
        self.world = spec.world
        self.fold = spec.fold
        self.device = torch.device(pool.device_type)
        self._template = None
        pool.call(make_groups, self.ids, spec.frame_shards)
        pool.call(bind, self.key, spec, get_instance(spec.instance), self.ids,
                  ranks=self.ids)

    def _state(self, sid: int, replies) -> RankState:
        return RankState(sid, *replies[0])

    def _call(self, fn, *args, **kw):
        return self.pool.call(fn, *args, ranks=self.ids, **kw)

    def init(self, seed: int) -> RankState:
        sid = next(_SIDS)
        return self._state(sid, self._call(start, sid, self.key, seed))

    def send_step(self, state: RankState, seed: int):
        return self.pool.send(step, state.sid, seed, ranks=self.ids)

    def finish_step(self, state: RankState, ticket) -> RankState:
        return self._state(state.sid, self.pool.wait(ticket))

    def step(self, state: RankState, seed: int) -> RankState:
        return self.finish_step(state, self.send_step(state, seed))

    def active(self, state: RankState) -> bool:
        return state.active

    def result(self, state: RankState) -> Tuple[np.ndarray, AdaptiveResult]:
        return self._call(result, state.sid)[0]

    def _join(self, parts) -> EpochState:
        shared = self.spec.frame_strategy == FrameStrategy.SHARED_FRAME
        return _torch(join_held(parts, self.fold, shared))

    def state_template(self) -> EpochState:
        """The checkpoint tree's layout: a VMAP session's of the spec."""
        if self._template is None:
            self._template = self._join(self._call(template, self.key))
        return self._template

    def pull(self, state: RankState) -> EpochState:
        """The state's checkpoint tree in VMAP's layout, on the host: the
        ranks' rows, joined."""
        return self._join(self._call(pull, state.sid))

    def push(self, tree: EpochState) -> RankState:
        """A new state on the lease's ranks, each holding its rows of
        ``tree`` (a checkpoint tree in VMAP's layout)."""
        shared = self.spec.frame_strategy == FrameStrategy.SHARED_FRAME
        host = map_tree(lambda x: x.cpu().numpy(), tree)
        parts = [(held_tree(host, (p,), self.fold, shared),)
                 for p in range(self.world)]
        sid = next(_SIDS)
        return self._state(sid, self._call(push, sid, self.key, each=parts))

    def drop(self, state: RankState) -> None:
        """Free the state on the ranks."""
        if not self.pool.closed:
            self._call(drop, state.sid)


def pool_for(ranks=None):
    """``ranks``, or this process's current rank pool (raises, saying how
    to start one, when there is none)."""
    from ..launch.spawn import current_rank_pool
    pool = ranks if ranks is not None else current_rank_pool()
    if pool is None or pool.closed:
        raise RuntimeError(
            "shard_map sessions run on a rank pool and none is open: start "
            "one with `with repro_torch.launch.spawn.RankPool(n, "
            "backend=..., device=...):` (or pass it as StepperCache(ranks=))")
    return pool


def held_by_ranks(pool) -> list:
    """How many session states each rank of ``pool`` holds."""
    return pool.call(held_sessions)

