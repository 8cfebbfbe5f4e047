"""State frames (the paper's core data structure) as dataclasses of tensors.

Port of :mod:`repro.core.frames`.  A frame holds ``num`` (samples
accumulated, an int32 tensor) and ``data`` (one tensor, or a dict of
tensors, holding the sampled data).  ``∘`` is elementwise ``+``.

Virtual workers: the W workers of one device are a leading W dimension on
the per-worker frames ("stacked" frames: ``num`` (W,), each data leaf
(W, ...)), in place of the reference's ``vmap`` over a named axis.  A
:class:`Collectives` turns the stacked deltas of an epoch into what each
strategy keeps: the full sum (``reduce_frames``), the per-worker shards of
the sum (``scatter_frames``) or the deltas themselves (``all_frames``).
The sums over W go through the ``frame_accum`` kernel.
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Union

import torch

from ..kernels import ops

Data = Union[torch.Tensor, Dict[str, torch.Tensor]]


def tree_map(fn: Callable, *datas: Data) -> Data:
    """Apply ``fn`` leafwise over frame data (a tensor or a dict of them)."""
    if isinstance(datas[0], dict):
        return {k: fn(*(d[k] for d in datas)) for k in datas[0]}
    return fn(*datas)


def leaves(data: Data) -> list:
    return list(data.values()) if isinstance(data, dict) else [data]


@dataclasses.dataclass(frozen=True)
class StateFrame:
    """One state frame (paper Fig. 1a)."""

    num: torch.Tensor  # int32 samples in this frame ((W,) when stacked)
    data: Data         # the sampled data


class FrameStrategy(enum.Enum):
    """Parallelization strategies from the paper (plus the two baselines)."""

    LOCK = "lock"
    BARRIER = "barrier"
    LOCAL_FRAME = "local"
    SHARED_FRAME = "shared"
    INDEXED_FRAME = "indexed"


def zeros_like_frame(template: Data) -> StateFrame:
    """A fresh (empty) frame for the given data template — Alg. 2 line 12."""
    dev = leaves(template)[0].device
    return StateFrame(num=torch.zeros((), dtype=torch.int32, device=dev),
                      data=tree_map(torch.zeros_like, template))


def stacked_zeros(template: Data, world: int) -> StateFrame:
    """W empty per-worker frames, stacked along a leading dim."""
    dev = leaves(template)[0].device
    return StateFrame(
        num=torch.zeros((world,), dtype=torch.int32, device=dev),
        data=tree_map(lambda x: torch.zeros((world, *x.shape), dtype=x.dtype,
                                            device=x.device), template))


def combine(a: StateFrame, b: StateFrame,
            op: Callable[[torch.Tensor, torch.Tensor], torch.Tensor] = torch.add
            ) -> StateFrame:
    """The associative ``∘`` of Algorithm 1 lifted to frames."""
    return StateFrame(num=a.num + b.num, data=tree_map(op, a.data, b.data))


def accumulate(frames: StateFrame, dim: int = 0) -> StateFrame:
    """Accumulate a stacked batch of frames along ``dim`` (Alg. 2 line 27),
    keeping each leaf's dtype (plain sum; the engine's reductions use the
    ``frame_accum`` kernel through :class:`Collectives`)."""
    return StateFrame(
        num=torch.sum(frames.num, dim=dim, dtype=frames.num.dtype),
        data=tree_map(lambda x: torch.sum(x, dim=dim, dtype=x.dtype),
                      frames.data))


def frame_at(stacked: StateFrame, w: int) -> StateFrame:
    """Worker ``w``'s frame out of a stacked frame."""
    return StateFrame(num=stacked.num[w],
                      data=tree_map(lambda x: x[w], stacked.data))


def shard_groups(world: int, frame_shards: int) -> tuple:
    """The ``within`` and ``across`` worker groups of the grouped
    SHARED_FRAME reduction (§3.2, Fig. 3b) for F = ``frame_shards``."""
    F = frame_shards
    if not (1 <= F <= world and world % F == 0):
        raise ValueError(f"need 1 ≤ F ≤ W and F | W, got W={world}, F={F}")
    within = [[g * F + i for i in range(F)] for g in range(world // F)]
    across = [[g * F + i for g in range(world // F)] for i in range(F)]
    return within, across


def shard_frame_pad(n: int, world: int) -> int:
    """Padded frame length so a length-``n`` data vector reduce-scatters
    evenly over ``world`` workers (shared-frame)."""
    return ((n + world - 1) // world) * world


@dataclasses.dataclass(frozen=True)
class Collectives:
    """How the stacked per-worker frames of an epoch are combined.

    ``reduce_frames``  — stacked (W, ...) → one frame holding ``⊕_t Δ_t``
                         (every worker's replicated copy, held once).
    ``scatter_frames`` — stacked → stacked shards: worker w holds shard
                         ``w % F`` of ``⊕_t Δ_t`` (``num`` fully reduced).
    ``all_frames``     — the per-worker deltas, stacked in worker order.
    """

    world: int
    frame_shards: int
    reduce_frames: Callable[[StateFrame], StateFrame]
    scatter_frames: Callable[[StateFrame], StateFrame]
    all_frames: Callable[[StateFrame], StateFrame]


def _identity(f: StateFrame) -> StateFrame:
    return f


def sequential_collectives() -> Collectives:
    """W = 1: the only worker's delta is the sum."""
    def reduce_frames(f: StateFrame) -> StateFrame:
        return frame_at(f, 0)

    def scatter_frames(f: StateFrame) -> StateFrame:
        return StateFrame(num=f.num[0], data=f.data)

    return Collectives(world=1, frame_shards=1, reduce_frames=reduce_frames,
                       scatter_frames=scatter_frames, all_frames=_identity)


def _accum_leaf(x: torch.Tensor) -> torch.Tensor:
    w = x.shape[0]
    return ops.frame_accum(x.reshape(w, -1).contiguous()).reshape(x.shape[1:])


def _fold_leaf(x: torch.Tensor, k: int) -> torch.Tensor:
    """(W·k, ...) → (W, ...): each run of k consecutive rows summed, as one
    ``frame_accum`` over the (k, W·n) matrix whose row j holds the j-th
    row of every group."""
    w = x.shape[0] // k
    groups = x.reshape(w, k, -1).transpose(0, 1).reshape(k, -1).contiguous()
    return ops.frame_accum(groups).reshape(w, *x.shape[1:])


def fold_frames(f: StateFrame, k: int) -> StateFrame:
    """Sum the stacked frames of k logical workers per physical worker:
    (W·k, ...) → (W, ...), worker p getting rows p·k … p·k+k−1."""
    return StateFrame(num=_fold_leaf(f.num, k),
                      data=tree_map(lambda x: _fold_leaf(x, k), f.data))


def virtual_collectives(world: int, frame_shards: int = 0) -> Collectives:
    """W virtual workers as a leading dim (the reference's vmap form).

    ``scatter_frames`` is the reference's psum+slice form
    (``repro/core/frames.py:210-217``): the full sum is formed with
    ``frame_accum`` and worker w keeps shard ``w % F``, so with F < W the
    W/F groups hold equal copies of every shard.
    """
    F = frame_shards or world
    shard_groups(world, F)  # validates F
    owner = torch.arange(world) % F

    def reduce_frames(f: StateFrame) -> StateFrame:
        return StateFrame(num=torch.sum(f.num, dtype=torch.int32),
                          data=tree_map(_accum_leaf, f.data))

    def scatter_frames(f: StateFrame) -> StateFrame:
        total = reduce_frames(f)

        def shard(x):
            if x.dim() == 0:  # scalar leaves are fully reduced
                return x.expand(world).clone()
            if x.shape[0] % F:
                raise ValueError(
                    f"SHARED_FRAME needs leading dim divisible by F={F}; pad "
                    f"the frame (got {tuple(x.shape)}) — see shard_frame_pad")
            parts = x.reshape(F, x.shape[0] // F, *x.shape[1:])
            return parts[owner.to(x.device)]

        return StateFrame(num=total.num, data=tree_map(shard, total.data))

    return Collectives(world=world, frame_shards=F, reduce_frames=reduce_frames,
                       scatter_frames=scatter_frames, all_frames=_identity)
