"""Checkpointable adaptive-sampling sessions.  Port of
:mod:`repro.serve.session`.

An :class:`AdaptiveSession` is one running query against the epoch engine,
driven one epoch at a time from the host
(:func:`repro_torch.core.substrate.make_stepper`).  Its resumable state is
the :class:`~repro_torch.core.epoch.EpochState` — epoch index, τ, the
consistent total (shards under SHARED_FRAME), the pending per-worker
deltas, the workers' generators, the verdict — plus the frozen
:class:`SessionSpec`.

save → restore → run ≡ run, bit for bit, for every strategy: a
checkpoint at an epoch boundary holds the whole cross-worker contract (the
consistent total, each worker's pending delta and each generator's state),
so the resumed run replays the same samples and reductions.

The checkpoint tree is the state with its generators replaced by their
states, a ``uint8`` (W·k, state bytes) leaf.  A CPU generator's state
(mt19937) is not a CUDA one's (Philox), so a checkpoint restores onto the
device type it was written on (``meta["device_type"]``) and raises
otherwise.  The device is an argument (``None`` → the CUDA card), not a
field of the spec.
"""

from __future__ import annotations

import dataclasses
import time
from pathlib import Path
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..checkpoint.manager import (latest_step, load_checkpoint, read_meta,
                                  save_checkpoint)
from ..core.adaptive import AdaptiveResult, result_from_state
from ..core.epoch import EpochConfig, EpochState
from ..core.frames import FrameStrategy
from ..core.instances import BuiltInstance, get_instance
from ..core.substrate import WORKER_AXIS, EpochStepper, make_stepper
from ..device import resolve_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class SessionSpec:
    """Frozen description of one query — everything needed to (re)build its
    engine program.  ``instance`` must be a registered workload name so a
    restore can rebuild the sampler from the manifest alone.

    ``logical_world`` is the worker count the sampling streams were seeded
    for; it differs from ``world`` only after an elastic re-shard
    (``world`` physical workers each fold ``logical_world/world`` logical
    streams — see :mod:`repro_torch.serve.elastic`).  0 means "same as
    world".

    ``placement`` pins a ``shard_map`` session to specific device ids — the
    devices the placement pool leased it (:mod:`repro_torch.serve.placement`).
    """

    instance: str
    strategy: str = "local"
    world: int = 1
    seed: int = 0
    substrate: Optional[str] = None
    frame_shards: int = 0
    logical_world: int = 0
    placement: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        FrameStrategy(self.strategy)  # validate early
        lw = self.logical_world or self.world
        if lw % self.world != 0:
            raise ValueError(
                f"world={self.world} must divide logical_world={lw}")
        if lw != self.world and \
                FrameStrategy(self.strategy) != FrameStrategy.SHARED_FRAME:
            raise ValueError("folded execution (logical_world != world) is "
                             "an elastic SHARED_FRAME feature")
        if self.placement is not None:
            object.__setattr__(self, "placement", tuple(self.placement))
            if self.substrate != "shard_map":
                raise ValueError("placement pins devices and is only "
                                 "meaningful for substrate='shard_map' "
                                 f"(got {self.substrate!r})")
            if len(self.placement) != self.world:
                raise ValueError(
                    f"placement names {len(self.placement)} device(s) for "
                    f"world={self.world}")

    @property
    def fold(self) -> Optional[int]:
        lw = self.logical_world or self.world
        return None if lw == self.world else lw // self.world

    @property
    def frame_strategy(self) -> FrameStrategy:
        return FrameStrategy(self.strategy)

    def stepper_key(self) -> tuple:
        """Cache key for built steppers: everything that changes the
        program or the devices it is bound to.  The seed is absent — it is
        an argument of the stepper's ``init``/``step``, so differently
        seeded queries of one shape share one stepper."""
        return (self.instance, self.strategy, self.world, self.frame_shards,
                self.substrate, self.logical_world, self.placement,
                WORKER_AXIS)

    def as_meta(self) -> Dict[str, Any]:
        return dataclasses.asdict(self)

    @classmethod
    def from_meta(cls, meta: Dict[str, Any]) -> "SessionSpec":
        fields = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in meta.items() if k in fields})

    @classmethod
    def parse(cls, spec: str) -> "SessionSpec":
        """Parse the CLI grammar ``instance:strategy:world[:seed]``."""
        parts = spec.split(":")
        if not 2 <= len(parts) <= 4:
            raise ValueError(f"query spec {spec!r} is not "
                             f"instance:strategy:world[:seed]")
        return cls(instance=parts[0], strategy=parts[1],
                   world=int(parts[2]) if len(parts) > 2 else 1,
                   seed=int(parts[3]) if len(parts) > 3 else 0)


class StepperCache:
    """Shared (built instance, stepper) per session shape on one device.

    One scheduler owns one cache; all queries with the same
    :meth:`SessionSpec.stepper_key` reuse the same built instance (its
    graph or alias table) and stepper.
    """

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self._cache: Dict[tuple, Tuple[BuiltInstance, EpochStepper]] = {}

    def get(self, spec: SessionSpec) -> Tuple[BuiltInstance, EpochStepper]:
        key = spec.stepper_key()
        if key not in self._cache:
            self._cache[key] = _build(spec, self.device)
        return self._cache[key]

    def __len__(self) -> int:
        return len(self._cache)


def _build(spec: SessionSpec, device: torch.device
           ) -> Tuple[BuiltInstance, EpochStepper]:
    if spec.substrate == "shard_map":
        # the pool is one controller process; a session whose workers are
        # other processes needs a controller/worker protocol of its own
        raise NotImplementedError(
            "the pool's sessions run on the sequential and vmap substrates; "
            "shard_map sessions (workers in other processes) wait for the "
            "pool's process-group sessions: ROADMAP queue 1 item 9")
    inst = get_instance(spec.instance)
    lw = spec.logical_world or spec.world
    # build() pads SHARED frames for the LOGICAL world; every W' | lw then
    # divides the padded length, so any elastic width shards evenly.
    built = inst.build(world=lw, strategy=spec.frame_strategy, device=device)
    cfg = EpochConfig(strategy=spec.frame_strategy,
                      rounds_per_epoch=built.rounds_per_epoch,
                      max_epochs=built.max_epochs)
    stepper = make_stepper(built.sample_fn, built.check_fn, built.template,
                           built.init_carry, spec.world, cfg,
                           substrate=spec.substrate,
                           frame_shards=spec.frame_shards, fold=spec.fold)
    return built, stepper


def _state_to_tree(state: EpochState) -> EpochState:
    """Checkpoint form: the generators as their (W·k, bytes) uint8 states,
    the host scalars as 0-d tensors."""
    return dataclasses.replace(
        state, gens=torch.stack([g.get_state() for g in state.gens]),
        stop=torch.tensor(state.stop),
        epoch=torch.tensor(state.epoch, dtype=torch.int32),
        stop_epoch=torch.tensor(state.stop_epoch, dtype=torch.int32))


def _tree_to_state(tree: EpochState, device: torch.device) -> EpochState:
    gens = []
    for row in tree.gens:
        gen = torch.Generator(device=device)
        # set_state reads the storage from its start: give it a row of its own
        gen.set_state(row.cpu().clone())
        gens.append(gen)
    return dataclasses.replace(tree, gens=gens, stop=bool(tree.stop),
                               epoch=int(tree.epoch),
                               stop_epoch=int(tree.stop_epoch))


class AdaptiveSession:
    """One query: spec + engine state + the stepper that advances it.

    Lifecycle::

        s = AdaptiveSession.create(SessionSpec("kadabra", "shared", world=4))
        s.start()
        while not s.done:
            s.step()                  # one epoch (the scheduler's unit)
        estimate, result = s.result()

        s.save(ckpt_dir)              # any epoch boundary
        r = AdaptiveSession.restore(ckpt_dir)
        # r continues bit-identically to an uninterrupted s
    """

    def __init__(self, spec: SessionSpec, built: BuiltInstance,
                 stepper: EpochStepper, device: torch.device):
        self.spec = spec
        self.built = built
        self.stepper = stepper
        self.device = device
        self.state: Optional[EpochState] = None
        self.wall_s = 0.0             # host-measured time spent stepping

    @classmethod
    def create(cls, spec: SessionSpec, cache: Optional[StepperCache] = None,
               device=None) -> "AdaptiveSession":
        """A session of ``spec`` on ``device`` (``None`` → the cache's
        device, or the CUDA card without a cache)."""
        if cache is None:
            device = resolve_device(device)
            return cls(spec, *_build(spec, device), device)
        if device is not None and resolve_device(device) != cache.device:
            raise ValueError(f"device {device} is not the cache's "
                             f"{cache.device}")
        return cls(spec, *cache.get(spec), cache.device)

    def rebind_placement(self, placement: "Tuple[int, ...] | None",
                         cache: Optional[StepperCache] = None
                         ) -> "AdaptiveSession":
        """Re-bind this session to other leased devices (same shape); the
        state is kept, the stepper swapped."""
        placement = None if placement is None else tuple(placement)
        if placement == self.spec.placement:
            return self
        self.spec = dataclasses.replace(self.spec, placement=placement)
        self.built, self.stepper = cache.get(self.spec) \
            if cache is not None else _build(self.spec, self.device)
        return self

    # ------------------------------------------------------------- running
    def start(self) -> "AdaptiveSession":
        t0 = time.perf_counter()
        self.state = self.stepper.init(self.spec.seed)
        self.wall_s += time.perf_counter() - t0
        return self

    @property
    def started(self) -> bool:
        return self.state is not None

    @property
    def done(self) -> bool:
        return self.started and not self.stepper.active(self.state)

    @property
    def epoch(self) -> int:
        assert self.started
        return self.state.epoch

    @property
    def tau(self) -> int:
        """Samples in the checked consistent state (the paper's τ)."""
        assert self.started
        return int(self.state.total.num.item())

    def step(self) -> bool:
        """Advance one epoch; returns ``done``.  No-op once stopped."""
        assert self.started, "call start() (or restore) first"
        if self.done:
            return True
        t0 = time.perf_counter()
        self.state = self.stepper.step(self.state, self.spec.seed)
        self.wall_s += time.perf_counter() - t0
        return self.done

    def run(self) -> "AdaptiveSession":
        while not self.done:
            self.step()
        return self

    def result(self) -> Tuple[np.ndarray, AdaptiveResult]:
        """(estimate, AdaptiveResult) from the current consistent state."""
        assert self.started
        res = result_from_state(self.state, strategy=self.spec.frame_strategy,
                                world=self.spec.world,
                                frame_shards=self.spec.frame_shards)
        est = self.built.estimate(self.built.trim(res.data),
                                  float(max(res.num, 1)))
        return est, res

    # -------------------------------------------------------- checkpointing
    def state_template(self) -> EpochState:
        """The checkpoint tree's layout (zeros; nothing is sampled)."""
        return _state_to_tree(self.stepper.state_template())

    def save(self, directory: "str | Path") -> Path:
        """Atomic checkpoint at the current epoch boundary."""
        assert self.started, "nothing to save before start()"
        return save_checkpoint(
            _state_to_tree(self.state), directory, step=self.epoch,
            meta={"spec": self.spec.as_meta(), "kind": "adaptive-session",
                  "tau": self.tau, "wall_s": self.wall_s,
                  "device_type": self.device.type})

    @classmethod
    def restore(cls, directory: "str | Path", step: Optional[int] = None,
                cache: Optional[StepperCache] = None,
                placement: Any = "keep", device=None) -> "AdaptiveSession":
        """Rebuild from a checkpoint directory onto ``device`` (as in
        :meth:`create`).  ``placement`` overrides the manifest's recorded
        device ids (``None`` drops the pin); ``"keep"`` keeps them."""
        directory = Path(directory)
        if step is None:
            step = latest_step(directory)
            if step is None:
                raise FileNotFoundError(f"no complete checkpoint in "
                                        f"{directory}")
        meta = read_meta(directory, step)
        spec = SessionSpec.from_meta(meta["spec"])
        if not (isinstance(placement, str) and placement == "keep"):
            spec = dataclasses.replace(
                spec, placement=None if placement is None
                else tuple(placement))
        target = cache.device if cache is not None else resolve_device(device)
        written_on = meta.get("device_type")
        if written_on != target.type:
            raise ValueError(
                f"checkpoint {directory} holds {written_on} generator states; "
                f"they cannot seed the generators of a {target.type} session "
                f"(a CPU generator is mt19937, a CUDA one Philox) — restore "
                f"it on a {written_on} device")
        session = cls.create(spec, cache=cache, device=device)
        tree, _meta = load_checkpoint(session.state_template(), directory,
                                      step)
        session.state = _tree_to_state(tree, session.device)
        # stepping time before the preemption carries over
        session.wall_s = float(meta.get("wall_s", 0.0))
        return session
