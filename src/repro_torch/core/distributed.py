"""Process groups of the SHARD_MAP substrate, on ``torch.distributed``.

The process-group half of what the reference gets from
:func:`repro.core.compat.shard_map` and :func:`repro.core.substrate.worker_mesh`:
W processes, rank r holding worker r, joined by one process group that
carries the engine's collectives.

Backends.  NCCL on CUDA tensors puts one rank on each card, so it runs at
most ``torch.cuda.device_count()`` ranks; gloo runs on CPU tensors (the
tests), and runs several ranks that share one card.  The caller names the
backend (default: NCCL on CUDA, gloo on the CPU); nothing here switches
backends on an error.

A rank's device is ``cuda:(rank % device_count)`` unless the caller asks for
the CPU.  :func:`init_worker_group` makes the group this process's current
one (:func:`current_worker_group`), which the substrate takes when it is
given no group; :func:`repro_torch.launch.spawn.spawn_workers` starts the W
processes.
"""

from __future__ import annotations

import contextlib
import dataclasses
import datetime
from typing import Any, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 120.0

# torch renamed the tensor forms of reduce-scatter and all-gather (the old
# names warn); the port calls whichever this torch has, by attribute at
# call time, so that ``record_collectives`` sees the call.
_REDUCE_SCATTER = "reduce_scatter_single" \
    if hasattr(dist, "reduce_scatter_single") else "reduce_scatter_tensor"
_ALL_GATHER = "all_gather_single" \
    if hasattr(dist, "all_gather_single") else "all_gather_into_tensor"

_CURRENT: Optional["WorkerGroup"] = None


@dataclasses.dataclass(frozen=True)
class WorkerGroup:
    """This process's place among the W worker processes: ``rank`` is the
    worker it holds, ``pg`` the world's process group."""

    rank: int
    world: int
    backend: str
    device: torch.device
    timeout: float                # seconds, for the init and every group
    pg: Any = dataclasses.field(repr=False)
    _blocks: Dict[tuple, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def block_group(self, blocks: Sequence[Sequence[int]]):
        """The process group of this rank's block of a partition of the
        ranks (``None`` if no block holds it).

        ``dist.new_group`` is collective over the world, groups that a rank
        is not in included, so every rank must ask for the same partitions
        in the same order.  Each partition's groups are built once, block
        by block, and cached; a block of the whole world is ``pg``."""
        key = tuple(tuple(int(r) for r in b) for b in blocks)
        if key not in self._blocks:
            mine = None
            for block in key:
                pg = self.pg if len(block) == self.world else dist.new_group(
                    list(block),
                    timeout=datetime.timedelta(seconds=self.timeout))
                if self.rank in block:
                    mine = pg
            self._blocks[key] = mine
        return self._blocks[key]

    def _min_max(self, flag) -> Tuple[bool, bool]:
        """The least and the greatest flag over the ranks: one all-reduce
        of (flag, −flag) as int32 under MIN (on the card for NCCL, which
        takes only CUDA tensors; on the CPU for gloo)."""
        f = int(bool(flag))
        dev = self.device if self.backend == "nccl" else torch.device("cpu")
        t = torch.tensor([f, -f], dtype=torch.int32, device=dev)
        dist.all_reduce(t, op=dist.ReduceOp.MIN, group=self.pg)
        return bool(int(t[0])), bool(-int(t[1]))

    def agree(self, flag) -> bool:
        """The flag that every rank holds, or raise if the ranks differ: a
        verdict that differed between ranks would send them down different
        paths and deadlock the next collective."""
        lo, hi = self._min_max(flag)
        if lo != hi:
            raise RuntimeError(f"ranks disagree on a verdict (rank {self.rank} "
                               f"of {self.world} holds {bool(flag)})")
        return lo

    def all_of(self, flag) -> bool:
        """The AND of the ranks' flags (verdicts on different shards)."""
        return self._min_max(flag)[0]


def init_worker_group(rank: int, world: int, *, backend: Optional[str] = None,
                      device=None, init_method: str,
                      timeout: float = DEFAULT_TIMEOUT_S) -> WorkerGroup:
    """Join the world of ``world`` worker processes as ``rank`` and make
    the group this process's current one.

    ``device`` — ``None`` or a CUDA device: ``cuda:(rank % device_count)``;
    ``"cpu"``: the CPU.  ``backend`` — ``None``: NCCL on CUDA, gloo on the
    CPU.  ``init_method`` is the rendezvous (``file://…`` or
    ``tcp://host:port``); ``timeout`` (seconds) bounds the init and every
    collective."""
    global _CURRENT
    if _CURRENT is not None:
        raise RuntimeError("this process already holds a worker group; "
                           "destroy_worker_group() first")
    cuda = device is None or torch.device(device).type == "cuda"
    backend = backend or ("nccl" if cuda else "gloo")
    if backend == "nccl":
        have = torch.cuda.device_count()
        if not cuda:
            raise ValueError("NCCL carries CUDA tensors only; run CPU ranks "
                             "over backend='gloo'")
        if world > have:
            raise RuntimeError(
                f"NCCL puts one rank on each card: world {world} > {have} "
                f"CUDA device(s); run ranks that share a card over "
                f"backend='gloo'")
    if cuda:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for the worker group; pass "
                               "device='cpu' to run the ranks on the CPU")
        dev = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(dev)
    else:
        dev = torch.device("cpu")
    dist.init_process_group(backend, init_method=init_method, rank=rank,
                            world_size=world,
                            timeout=datetime.timedelta(seconds=timeout))
    _CURRENT = WorkerGroup(rank=rank, world=world, backend=backend,
                           device=dev, timeout=timeout, pg=dist.group.WORLD)
    return _CURRENT


def current_worker_group() -> Optional[WorkerGroup]:
    """The group :func:`init_worker_group` made in this process, if any."""
    return _CURRENT


def destroy_worker_group() -> None:
    """Leave the worker group (and destroy the process group)."""
    global _CURRENT
    if _CURRENT is not None:
        _CURRENT = None
        dist.destroy_process_group()


# -- the collectives the port issues, by name at call time -----------------


def all_reduce(x: torch.Tensor, group) -> None:
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=group)


def reduce_scatter(out: torch.Tensor, x: torch.Tensor, group) -> None:
    getattr(dist, _REDUCE_SCATTER)(out, x, op=dist.ReduceOp.SUM, group=group)


def all_gather(out: torch.Tensor, x: torch.Tensor, group) -> None:
    getattr(dist, _ALL_GATHER)(out, x, group=group)


_RECORDED = ("all_reduce", "reduce_scatter_tensor", "reduce_scatter_single",
             "all_gather_into_tensor", "all_gather_single", "all_gather",
             "reduce_scatter", "broadcast", "reduce", "all_to_all_single")


@contextlib.contextmanager
def record_collectives():
    """Record every call of ``torch.distributed``'s collectives made by
    attribute while the block runs: yields a list of ``(op, group size,
    elements of the largest tensor argument, its device type)``, one a
    call."""
    calls: List[Tuple[str, int, int, str]] = []
    saved = {name: getattr(dist, name) for name in _RECORDED
             if hasattr(dist, name)}

    def wrap(name, fn):
        def call(*args, **kwargs):
            group = kwargs.get("group")
            size = dist.get_world_size(group) if group is not None \
                else dist.get_world_size()
            big = max((a for a in (*args, *kwargs.values())
                       if isinstance(a, torch.Tensor)),
                      key=torch.Tensor.numel, default=None)
            calls.append((name, size, 0 if big is None else big.numel(),
                          "" if big is None else big.device.type))
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)
