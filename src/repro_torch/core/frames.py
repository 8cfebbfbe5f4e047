"""State frames (the paper's core data structure) as dataclasses of tensors.

Port of :mod:`repro.core.frames`.  A frame holds ``num`` (samples
accumulated, an int32 tensor) and ``data`` (one tensor, or a dict of
tensors, holding the sampled data).  ``∘`` is elementwise ``+``.

Stacked frames: the workers a process holds are a leading dimension on
the per-worker frames (``num`` (h,), each data leaf (h, ...)).  One process
holds all W workers on the sequential and vmap substrates (in place of the
reference's ``vmap`` over a named axis), and one worker on each of W
processes on shard_map.  A :class:`Collectives` turns the stacked deltas of
an epoch into what each strategy keeps: the full sum (``reduce_frames``),
the held workers' shards of the sum (``scatter_frames``) or every worker's
delta (``all_frames``).  In one process the sums over W go through the
``frame_accum`` kernel; across processes they are ``torch.distributed``
collectives (:func:`process_collectives`).
"""

from __future__ import annotations

import dataclasses
import enum
from typing import Callable, Dict, Tuple, Union

import torch

from ..kernels import ops
from . import distributed

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

    ``workers``        — the worker ids this process holds, in stacking
                         order (all W in one process; ``(rank,)`` in a
                         worker process).
    ``reduce_frames``  — stacked (h, ...) → one frame holding ``⊕_t Δ_t``
                         over all W workers (replicated, held once).
    ``scatter_frames`` — stacked → stacked shards: held worker w holds
                         shard ``w % F`` of ``⊕_t Δ_t`` (``num`` fully
                         reduced).
    ``all_frames``     — every worker's delta, stacked (W, ...) in worker
                         order.
    ``agree``          — a verdict every process holds (raises if they
                         differ; the identity in one process).
    ``all_of``         — the AND of the processes' verdicts on their own
                         shards (the identity in one process).
    """

    world: int
    frame_shards: int
    reduce_frames: Callable[[StateFrame], StateFrame]
    scatter_frames: Callable[[StateFrame], StateFrame]
    all_frames: Callable[[StateFrame], StateFrame]
    workers: Tuple[int, ...]
    agree: Callable[[bool], bool] = bool
    all_of: Callable[[bool], bool] = bool


def _identity(f: StateFrame) -> StateFrame:
    return f


def sequential_collectives() -> Collectives:
    """W = 1: the only worker's delta is the sum."""
    def reduce_frames(f: StateFrame) -> StateFrame:
        return frame_at(f, 0)

    def scatter_frames(f: StateFrame) -> StateFrame:
        return StateFrame(num=f.num[0], data=f.data)

    return Collectives(world=1, frame_shards=1, reduce_frames=reduce_frames,
                       scatter_frames=scatter_frames, all_frames=_identity,
                       workers=(0,))


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
                       scatter_frames=scatter_frames, all_frames=_identity,
                       workers=tuple(range(world)))


def _int_leaf(x: torch.Tensor) -> torch.Tensor:
    if x.dtype.is_floating_point:
        raise TypeError(f"frames crossing processes must be integer (a sum "
                        f"in another order is then the same sum); got a "
                        f"{x.dtype} leaf of shape {tuple(x.shape)}")
    return x


def process_collectives(group: "distributed.WorkerGroup",
                        frame_shards: int = 0) -> Collectives:
    """Collectives of a worker process: rank r holds worker r, so stacked
    frames are (1, ...) and the sums run over ``group``.  Port of
    ``axis_collectives(..., grouped=True)`` (``repro/core/frames.py:147``).

    ``reduce_frames`` all-reduces the held frame.  ``scatter_frames`` with
    F = W reduce-scatters it over the world; with F < W it is the paper's
    grouped form (§3.2, Fig. 3b): a reduce-scatter within each group of F
    consecutive ranks, then an all-reduce of the n/F partial across the
    W/F groups, so that worker g·F + i holds shard i of the sum, as in
    :func:`virtual_collectives`; ``num`` is fully reduced.  ``all_frames``
    all-gathers the (W, ...) deltas in rank order.  Frame leaves must be
    integer: then no order of the sums can change a bit.

    The tensors stay on the rank's device with either backend: gloo takes
    CUDA tensors for all three collectives (torch 2.11 on an H100 host;
    gloo copies them through host memory itself), so no op is staged
    here.
    """
    W, rank = group.world, group.rank
    F = frame_shards or W
    within, across = shard_groups(W, F)
    g_within = group.block_group(within)
    g_across = group.block_group(across) if F < W else None

    def total(x):
        """(1, ...) → the (...) sum over the world."""
        y = _int_leaf(x).reshape(1, -1)[0].clone()
        distributed.all_reduce(y, group.pg)
        return y.reshape(x.shape[1:])

    def reduce_frames(f: StateFrame) -> StateFrame:
        return StateFrame(num=total(f.num), data=tree_map(total, f.data))

    def scatter_frames(f: StateFrame) -> StateFrame:
        def shard(x):
            if x.dim() == 1:  # scalar leaves are fully reduced
                return total(x).reshape(1)
            _int_leaf(x)
            if x.shape[1] % F:
                raise ValueError(
                    f"SHARED_FRAME needs leading dim divisible by F={F}; pad "
                    f"the frame (got {tuple(x.shape[1:])}) — see "
                    f"shard_frame_pad")
            flat = x[0].reshape(-1).contiguous()
            out = torch.empty(flat.numel() // F, dtype=x.dtype,
                              device=x.device)
            distributed.reduce_scatter(out, flat, g_within)
            if g_across is not None:
                distributed.all_reduce(out, g_across)
            return out.reshape(1, x.shape[1] // F, *x.shape[2:])

        return StateFrame(num=total(f.num), data=tree_map(shard, f.data))

    def all_frames(f: StateFrame) -> StateFrame:
        def gather(x):
            x = _int_leaf(x).contiguous()
            out = torch.empty((W, *x.shape[1:]), dtype=x.dtype,
                              device=x.device)
            distributed.all_gather(out, x, group.pg)
            return out
        return StateFrame(num=gather(f.num), data=tree_map(gather, f.data))

    return Collectives(world=W, frame_shards=F, reduce_frames=reduce_frames,
                       scatter_frames=scatter_frames, all_frames=all_frames,
                       workers=(rank,), agree=group.agree,
                       all_of=group.all_of)


def collectives_on_rank(group: "distributed.WorkerGroup", num, data,
                        frame_shards=(0,)) -> dict:
    """A check entry for :func:`repro_torch.launch.spawn.spawn_workers`:
    this rank's row of stacked numpy frames (``num`` (W,), ``data``
    leaves (W, ...)) through :func:`process_collectives` for each F of
    ``frame_shards``.  Returns ``{F: {op: (num, data, calls)}}`` for the
    ops ``reduce_frames``, ``scatter_frames`` and ``all_frames``, as numpy,
    with the ``torch.distributed`` collectives each op issued
    (:func:`~repro_torch.core.distributed.record_collectives`)."""
    r, dev = group.rank, group.device

    def row(a):
        return torch.from_numpy(a[r:r + 1].copy()).to(dev)

    held = StateFrame(num=row(num), data=tree_map(row, data))
    out = {}
    for F in frame_shards:
        colls = process_collectives(group, F)  # builds its groups first
        out[F] = {}
        for op in ("reduce_frames", "scatter_frames", "all_frames"):
            with distributed.record_collectives() as calls:
                f = getattr(colls, op)(held)
            out[F][op] = (f.num.cpu().numpy(),
                          tree_map(lambda x: x.cpu().numpy(), f.data),
                          list(calls))
    return out
