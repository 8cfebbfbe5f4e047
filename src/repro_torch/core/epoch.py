"""Epoch-based adaptive-sampling engine (the paper's Algorithm 2).

Port of :mod:`repro.core.epoch`.  The reference builds a per-worker program
and runs it under ``while_loop`` inside ``vmap``/``shard_map``; here the W
virtual workers are a leading dimension of every per-worker frame and the
loop over epochs runs on the host: ``init`` primes the state, ``body``
advances one epoch, ``cond`` says whether to go on (one host read of the
verdict per check).

Randomness: worker w samples from its own ``torch.Generator``, seeded by a
fixed integer mix of (seed, w).  INDEXED_FRAME draws frame m = epoch·W +
worker from a generator seeded by a mix of (seed, m) alone, so its frames,
and hence its result, do not depend on W (the counterpart of
``repro/core/epoch.py:252-256``).  torch's generators give other bits than
JAX's threefry, so the port does not reproduce the reference's samples.

A ``sample_fn(gens, carry) -> (delta, carry)`` runs one round for all the
workers whose generators it is given and returns their deltas stacked
(len(gens), ...); worker w's random inputs come only from ``gens[w]``, so a
worker's samples do not depend on which other workers share its call.

A process holds the workers ``colls.workers`` of the W: all of them on the
sequential and vmap substrates, its rank's one on shard_map.  It builds
only their streams and samples only their frames; W stays global (seeds,
INDEXED_FRAME's frame indices, the reductions).

The seed is an argument of ``init`` and ``body``, not of the program, so
one program (and one :class:`~repro_torch.core.substrate.EpochStepper`)
serves every seed of a shape.  Generators are mutable: ``body`` advances
the generators of the state it is given and hands them on, so a state is
consumed by the step that advances it.  Whatever keeps a state beside its
successor (a checkpoint, a reshard) copies the generators' states.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional, Sequence, Tuple

import torch

from ..device import to_host
from .frames import (Collectives, FrameStrategy, StateFrame, combine,
                     fold_frames, frame_at, leaves, stacked_zeros, tree_map,
                     zeros_like_frame)

SampleFn = Callable[[Sequence[torch.Generator], Any], Tuple[StateFrame, Any]]
CheckFn = Callable[[StateFrame], Tuple[torch.Tensor, Any]]

_M64 = (1 << 64) - 1
_WORKER_STREAM = 0x5EED_0001
_INDEXED_STREAM = 0x5EED_0002


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def seed_mix(*xs: int) -> int:
    """A fixed 63-bit mix of integers — the port's ``fold_in``."""
    h = 0
    for x in xs:
        h = _splitmix64(h ^ (int(x) & _M64))
    return h >> 1


def make_generator(device: torch.device, *xs: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(seed_mix(*xs))
    return gen


def worker_generators(seed: int, streams: Sequence[int],
                      device: torch.device) -> List[torch.Generator]:
    """The sampling streams ``streams`` (stream w seeded by (seed, w)), the
    same on every substrate."""
    return [make_generator(device, _WORKER_STREAM, seed, w) for w in streams]


def frame_generator(seed: int, m: int, device: torch.device) -> torch.Generator:
    """INDEXED_FRAME: the stream of global frame m, whatever W is."""
    return make_generator(device, _INDEXED_STREAM, seed, m)


@dataclasses.dataclass(frozen=True)
class EpochConfig:
    strategy: FrameStrategy = FrameStrategy.LOCAL_FRAME
    rounds_per_epoch: int = 8     # K sampling rounds between checks (paper's N)
    max_epochs: int = 1_000
    xi: float = 0.0               # App. C.3 cadence heuristic
    substrate: Optional[str] = None


def rounds_for_world(n_samples_between_checks: int, round_batch: int,
                     world: int, xi: float) -> int:
    """Paper App. C.3: check after N₀ = N / W^ξ samples (per worker)."""
    n0 = n_samples_between_checks / max(1.0, float(world) ** xi)
    return max(1, int(round(n0 / max(1, round_batch))))


@dataclasses.dataclass
class EpochState:
    gens: List[torch.Generator]  # the held streams (unused by INDEXED)
    carry: Any
    total: StateFrame      # consistent reduced state: one frame, or the
                           # held workers' stacked (h, n/F) shards under
                           # SHARED_FRAME
    pending: StateFrame    # the held workers' stacked (h, ...) deltas of
                           # the epoch just sampled
    stop: bool
    aux: Any               # the check's aux (zeros before the first check)
    epoch: int
    stop_epoch: int        # epoch at which stop was first seen


def _sample_epoch(sample_fn: SampleFn, template, rounds: int,
                  gens: Sequence[torch.Generator], carry) -> Tuple[StateFrame, Any]:
    """K sampling rounds accumulated into fresh stacked delta frames."""
    frame = stacked_zeros(template, len(gens))
    for _ in range(rounds):
        delta, carry = sample_fn(gens, carry)
        frame = combine(frame, delta)
    return frame, carry


@dataclasses.dataclass(frozen=True)
class EpochProgram:
    """The engine as single-epoch pieces: ``init(carry, seed)`` builds the
    primed epoch-0 state, ``body(state, seed)`` advances one epoch,
    ``cond(state)`` is the keep-running predicate, ``blank(carry)`` is a
    state of the same layout that nothing has sampled into (zero frames
    and aux, unseeded generators), and ``gather(state)`` is a state in the
    layout of one process holding all W workers (the identity there)."""

    init: Callable[[Any, int], EpochState]
    body: Callable[[EpochState, int], EpochState]
    cond: Callable[[EpochState], bool]
    blank: Callable[[Any], EpochState]
    gather: Callable[[EpochState], EpochState]


def _shard_zeros(template, world: int, shards: int) -> StateFrame:
    """Zero stacked shards: worker w's 1/F share of every data leaf."""
    def shard(x):
        if x.dim() == 0:
            return torch.zeros((world,), dtype=x.dtype, device=x.device)
        if x.shape[0] % shards:
            raise ValueError(
                f"SHARED_FRAME needs leading dim divisible by F={shards}; pad "
                f"the frame (got {tuple(x.shape)}) — see frames.shard_frame_pad")
        return torch.zeros((world, x.shape[0] // shards, *x.shape[1:]),
                           dtype=x.dtype, device=x.device)
    dev = leaves(template)[0].device
    return StateFrame(num=torch.zeros((), dtype=torch.int32, device=dev),
                      data=tree_map(shard, template))


def _zero_aux(aux):
    """The check's aux with every tensor zeroed (dicts walked)."""
    if isinstance(aux, dict):
        return {k: _zero_aux(v) for k, v in aux.items()}
    return torch.zeros_like(aux) if isinstance(aux, torch.Tensor) else aux


def make_program(sample_fn: SampleFn, check_fn: CheckFn, template,
                 cfg: EpochConfig, colls: Collectives,
                 fold: Optional[int] = None) -> EpochProgram:
    """Build the epoch program of one strategy for ``colls.world`` workers,
    of which this process holds ``colls.workers``.

    ``template`` — the shape/dtype of ``frame.data`` (the full frame also
    for SHARED_FRAME; the engine keeps the sharded total).

    ``fold = k`` runs k logical workers per physical worker (elastic
    re-sharding, :mod:`repro_torch.serve.elastic`): the state holds k
    generators a held worker, physical worker p carrying the logical
    streams p·k … p·k+k−1; ``sample_fn`` gets all h·k of them and the
    (h·k, ...) deltas are summed per physical worker into (h, ...) with
    ``frame_accum``.
    ``∘`` is exact over integer frames, so (τ, estimate) equal the
    unfolded run's with W·k workers.  Every strategy but INDEXED_FRAME
    (whose frames do not depend on W) supports it.

    The run stops sampling once the verdict has fired: the reference's
    fused loop samples one more (discarded) epoch after a lagged check,
    this host loop does not, so a stopped state's ``pending`` is empty.
    """
    strat = cfg.strategy
    if fold is not None and strat == FrameStrategy.INDEXED_FRAME:
        raise ValueError("fold is not supported for INDEXED_FRAME (its "
                         "result is already worker-count independent)")
    W = colls.world
    F = colls.frame_shards or W
    k = fold or 1
    held = colls.workers
    h = len(held)
    device = leaves(template)[0].device

    def sample_epoch(gens, carry, rounds):
        frame, carry = _sample_epoch(sample_fn, template, rounds, gens, carry)
        return (frame if k == 1 else fold_frames(frame, k)), carry

    def sample_indexed(seed: int, epoch: int, carry):
        gens = [frame_generator(seed, epoch * W + w, device) for w in held]
        return sample_epoch(gens, carry, cfg.rounds_per_epoch)

    def check_full(total: StateFrame):
        stop, aux = check_fn(total)
        return colls.agree(bool(to_host(stop))), aux

    def shard_check(shards: StateFrame, j: int):
        return check_fn(StateFrame(
            num=shards.num, data=tree_map(lambda x: x[j], shards.data)))

    def check_sharded(shards: StateFrame):
        # per-shard verdicts of the held workers, AND-combined here and
        # across processes (repro/core/epoch.py:198-201); the aux reported
        # is the first held worker's (worker 0's in one process, as
        # result_from_state takes it; ``gather`` brings worker 0's).
        verdicts, aux0 = [], None
        for j in range(h):
            stop_j, aux_j = shard_check(shards, j)
            verdicts.append(stop_j)
            aux0 = aux_j if aux0 is None else aux0
        return colls.all_of(bool(to_host(torch.stack(verdicts).all()))), aux0

    def advance(st, carry, total, pending, stop, aux, epoch=None):
        e = st.epoch + 1 if epoch is None else epoch
        return EpochState(st.gens, carry, total, pending, stop, aux, e,
                          e if stop and not st.stop else st.stop_epoch)

    def empty_pending():
        return stacked_zeros(template, h)

    if strat in (FrameStrategy.LOCK, FrameStrategy.BARRIER):
        rounds = 1 if strat == FrameStrategy.LOCK else cfg.rounds_per_epoch

        def body(st: EpochState, seed: int = 0) -> EpochState:
            delta, carry = sample_epoch(st.gens, st.carry, rounds)
            total = combine(st.total, colls.reduce_frames(delta))  # barrier
            stop, aux = check_full(total)
            return advance(st, carry, total, delta, stop, aux)

    elif strat == FrameStrategy.LOCAL_FRAME:

        def body(st: EpochState, seed: int = 0) -> EpochState:
            # fold in the PREVIOUS epoch's deltas, check, then sample.
            total = combine(st.total, colls.reduce_frames(st.pending))
            stop, aux = check_full(total)
            delta, carry = (empty_pending(), st.carry) if stop else \
                sample_epoch(st.gens, st.carry, cfg.rounds_per_epoch)
            return advance(st, carry, total, delta, stop, aux)

    elif strat == FrameStrategy.SHARED_FRAME:

        def body(st: EpochState, seed: int = 0) -> EpochState:
            total = combine(st.total, colls.scatter_frames(st.pending))
            stop, aux = check_sharded(total)
            delta, carry = (empty_pending(), st.carry) if stop else \
                sample_epoch(st.gens, st.carry, cfg.rounds_per_epoch)
            return advance(st, carry, total, delta, stop, aux)

    elif strat == FrameStrategy.INDEXED_FRAME:

        def body(st: EpochState, seed: int = 0) -> EpochState:
            gathered = colls.all_frames(st.pending)  # (W, ...) frame deltas
            total, stop, aux, stop_epoch = st.total, st.stop, st.aux, st.stop_epoch
            # consume frames in index order; freeze at the FIRST stopping
            # prefix, which makes the result the same for every W.
            for j in range(W):
                if stop:
                    break
                total = combine(total, frame_at(gathered, j))
                s_j, aux_j = check_full(total)
                if s_j:
                    stop, aux, stop_epoch = True, aux_j, st.epoch + 1
            delta, carry = (empty_pending(), st.carry) if stop else \
                sample_indexed(seed, st.epoch, st.carry)
            return EpochState(st.gens, carry, total, delta, stop, aux,
                              st.epoch + 1, stop_epoch)

    else:  # pragma: no cover
        raise ValueError(f"unknown strategy {strat}")

    def cond(st: EpochState) -> bool:
        return (not st.stop) and st.epoch < cfg.max_epochs

    def total_zeros():
        return _shard_zeros(template, h, F) \
            if strat == FrameStrategy.SHARED_FRAME else zeros_like_frame(template)

    # the aux of a check before the first one: the check on a zero frame
    # (worker 0's zero shard under SHARED_FRAME), zeroed — the reference's
    # eval_shape of the check.
    z = total_zeros()
    if strat == FrameStrategy.SHARED_FRAME:
        z = StateFrame(num=z.num, data=tree_map(lambda x: x[0], z.data))
    zero_aux = _zero_aux(check_fn(z)[1])

    def blank(carry=None) -> EpochState:
        return EpochState(gens=[torch.Generator(device=device)
                                for _ in range(h * k)],
                          carry=carry, total=total_zeros(),
                          pending=empty_pending(), stop=False,
                          aux=_zero_aux(zero_aux), epoch=0, stop_epoch=0)

    def init(carry=None, seed: int = 0) -> EpochState:
        st = blank(carry)
        st.gens = worker_generators(
            seed, [w * k + j for w in held for j in range(k)], device)
        # Epoch 0 produces the first pending frame (Alg. 2 note on line 9).
        if strat == FrameStrategy.INDEXED_FRAME:
            st.pending, st.carry = sample_indexed(seed, 0, carry)
            st.epoch = 1
        elif strat in (FrameStrategy.LOCAL_FRAME, FrameStrategy.SHARED_FRAME):
            st.pending, st.carry = sample_epoch(st.gens, carry,
                                                cfg.rounds_per_epoch)
            st.epoch = 1
        return st

    def gather(st: EpochState) -> EpochState:
        """The held workers' state → the layout of one process holding all
        W: pending (W, ...) and, under SHARED_FRAME, the (W, n/F) shards,
        with worker 0's aux (recomputed from its shard once the state has
        been checked: the aux of the last check).  The generators stay the
        held ones."""
        if h == W:
            return st
        pending = colls.all_frames(st.pending)
        total, aux = st.total, st.aux
        if strat == FrameStrategy.SHARED_FRAME:
            total = StateFrame(num=total.num, data=colls.all_frames(
                StateFrame(num=total.num.reshape(1), data=total.data)).data)
            if st.epoch >= 2 and held[0] != 0:
                aux = shard_check(total, 0)[1]
        return dataclasses.replace(st, total=total, pending=pending, aux=aux)

    return EpochProgram(init=init, body=body, cond=cond, blank=blank,
                        gather=gather)
