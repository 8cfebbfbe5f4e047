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

Lease groups.  A persistent pool of n ranks
(:class:`repro_torch.launch.spawn.RankPool`) runs sessions on subsets of
its ranks: :func:`lease_group` turns the slot ids of a lease into a
:class:`WorkerGroup` whose ``rank`` is the position in the lease (the ids
in ascending order, so that the process group's own ranks are the
positions) and whose ``world`` is its width.  ``dist.new_group`` is
collective over the whole pool, so every rank of the pool makes a lease's
groups, in the same order (:func:`process_group`, cached by rank tuple:
a long stream of queries makes a bounded number of groups).
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
# process groups by their global ranks (ascending): the pg, or None on a
# rank outside it; every rank of the world makes them in the same order
_PGS: Dict[Tuple[int, ...], Any] = {}
_LEASES: Dict[Tuple[int, ...], "WorkerGroup"] = {}


@dataclasses.dataclass(frozen=True)
class WorkerGroup:
    """This process's place among the W worker processes: ``rank`` is the
    worker it holds, ``pg`` the group's process group.  ``ranks`` are the
    global ranks of a lease group's positions (``None``: the world, rank r
    at position r)."""

    rank: int
    world: int
    backend: str
    device: torch.device
    timeout: float                # seconds, for the init and every group
    pg: Any = dataclasses.field(repr=False)
    ranks: Optional[Tuple[int, ...]] = None
    _blocks: Dict[tuple, Any] = dataclasses.field(
        default_factory=dict, repr=False, compare=False)

    def global_ranks(self, positions: Sequence[int]) -> Tuple[int, ...]:
        return tuple(int(p) if self.ranks is None else self.ranks[int(p)]
                     for p in positions)

    def block_group(self, blocks: Sequence[Sequence[int]]):
        """The process group of this rank's block of a partition of the
        positions (``None`` if no block holds it).

        ``dist.new_group`` is collective over the world, groups that a rank
        is not in included, so every rank must ask for the same partitions
        in the same order.  The world group makes each partition's groups
        on first use; a lease group only finds them, since the ranks
        outside the lease do not take part: every rank of the pool made
        them beforehand (:func:`process_group`).  A block of the whole
        group is ``pg``."""
        key = tuple(tuple(int(r) for r in b) for b in blocks)
        if key not in self._blocks:
            mine = None
            for block in key:
                pg = self.pg if len(block) == self.world else process_group(
                    self.global_ranks(block), self.timeout,
                    make=self.ranks is None)
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
        _PGS.clear()
        _LEASES.clear()
        dist.destroy_process_group()


def process_group(ranks: Sequence[int], timeout: float = DEFAULT_TIMEOUT_S,
                  make: bool = True):
    """The process group of the global ``ranks`` (any order), made once
    and cached; ``None`` on a rank outside it.  Making one is collective
    over the world: every rank asks for the same groups in the same order.
    With ``make=False`` a group not made yet raises instead, where only
    some ranks could ask for it."""
    key = tuple(sorted(int(r) for r in ranks))
    if key not in _PGS:
        if not make:
            raise RuntimeError(
                f"no process group of ranks {key} yet: every rank of the "
                f"pool makes a lease's groups first (serve.ranks.make_groups)")
        if len(key) == dist.get_world_size():
            pg = dist.group.WORLD
        else:
            pg = dist.new_group(list(key),
                                timeout=datetime.timedelta(seconds=timeout))
        _PGS[key] = pg if dist.get_rank() in key else None
    return _PGS[key]


def lease_group(ids: Sequence[int]) -> Optional[WorkerGroup]:
    """The worker group of a lease of the world's ranks ``ids``: position
    p holds the p-th smallest id.  Every rank of the world calls it with
    the same leases in the same order (it makes the lease's process group);
    ranks outside the lease get ``None``."""
    world = _CURRENT
    if world is None:
        raise RuntimeError("lease_group runs in a rank of a worker group")
    ranks = tuple(sorted(int(i) for i in ids))
    if len(set(ranks)) != len(ranks) or not all(
            0 <= r < world.world for r in ranks):
        raise ValueError(f"lease {tuple(ids)} is not a set of the world's "
                         f"ranks 0..{world.world - 1}")
    pg = process_group(ranks, world.timeout)
    if world.rank not in ranks:
        return None
    if len(ranks) == world.world:
        return world
    if ranks not in _LEASES:
        _LEASES[ranks] = WorkerGroup(
            rank=ranks.index(world.rank), world=len(ranks),
            backend=world.backend, device=world.device,
            timeout=world.timeout, pg=pg, ranks=ranks)
    return _LEASES[ranks]


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
def record_collectives(detail: bool = False):
    """Record every call of ``torch.distributed``'s collectives made by
    attribute while the block runs: yields a list of ``(op, group size,
    elements of the largest tensor argument, its device type)``, one a
    call; with ``detail``, each tuple adds the reduce op's name (``""``
    when the call takes none) and the largest tensor's dtype."""
    calls: List[tuple] = []
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
            call = (name, size, 0 if big is None else big.numel(),
                    "" if big is None else big.device.type)
            if detail:
                red = type(dist.ReduceOp.SUM)
                op = kwargs.get("op", next(
                    (a for a in args if isinstance(a, red)), None))
                call += ("" if op is None else str(op).split(".")[-1],
                         None if big is None else big.dtype)
            calls.append(call)
            return fn(*args, **kwargs)
        return call

    for name, fn in saved.items():
        setattr(dist, name, wrap(name, fn))
    try:
        yield calls
    finally:
        for name, fn in saved.items():
            setattr(dist, name, fn)


# -- CUDA tensors on gloo, staged through the host --------------------------

# collectives and point-to-point messages of CUDA tensors carried as host
# copies on gloo groups (``stage_through_host``).  gloo's point-to-point
# calls take host memory only; and on torch 2.11 a DTensor collective
# (``_c10d_functional``) of a CUDA tensor over gloo crashed the rank in
# ``wait_tensor`` where the same collectives called directly took CUDA
# tensors: so DTensor's collectives on the card go through the host too.
host_staged = 0
STAGED_DEVICE = "cuda"
_FUNCOL_STAGED = ("all_reduce", "all_gather_into_tensor", "reduce_scatter_tensor",
                  "all_to_all_single", "broadcast")


def p2p_exchange(pg, send: Optional[tuple], recv: Optional[tuple]) -> None:
    """``send`` = (tensor, group rank) and ``recv`` = (buffer, group rank),
    either None, posted at once with ``dist.batch_isend_irecv`` and waited.
    gloo's point-to-point calls take host memory only: on a gloo group a
    CUDA tensor goes through a host copy (``stage_through_host``)."""
    gloo = dist.get_backend(pg) == "gloo"
    ops: List[dist.P2POp] = []
    back = None

    def peer(r):
        return dist.get_global_rank(pg, r) if pg is not None else r

    if send is not None:
        t, r = send
        if gloo and t.device.type == STAGED_DEVICE:
            t = stage_through_host(t)
        ops.append(dist.P2POp(dist.isend, t, peer(r), group=pg))
    if recv is not None:
        buf, r = recv
        if gloo and buf.device.type == STAGED_DEVICE:
            back, buf = buf, stage_through_host(buf, copy=False)
        ops.append(dist.P2POp(dist.irecv, buf, peer(r), group=pg))
    if ops:
        for w in dist.batch_isend_irecv(ops):
            w.wait()
    if back is not None:
        back.copy_(buf)


def stage_through_host(t: torch.Tensor, copy: bool = True) -> torch.Tensor:
    """A host tensor standing in for the CUDA tensor ``t`` in a gloo
    message (its values with ``copy``, else a buffer of its shape);
    counted in ``host_staged``."""
    global host_staged
    host_staged += 1
    if not copy:
        return torch.empty(t.shape, dtype=t.dtype)
    return t.detach().to("cpu", copy=True).contiguous()


@contextlib.contextmanager
def staged_collectives():
    """While the block runs, every ``_c10d_functional`` collective (the ones
    DTensor issues) of a CUDA tensor runs on a host copy, waited at once,
    and its result comes back to the card: the computation stays on the
    card, only the message goes through host memory.  For gloo groups (the
    ranks that share a card)."""
    from torch.distributed.tensor import DTensor
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils._pytree import tree_map

    funcol = torch.ops._c10d_functional

    class _Staged(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            if any(issubclass(t, DTensor) for t in types):
                return NotImplemented
            name = getattr(func, "_overloadpacket", None)
            name = getattr(name, "__name__", "")
            t = args[0] if args else None
            if func.namespace == "_c10d_functional" and name in _FUNCOL_STAGED \
                    and isinstance(t, torch.Tensor) \
                    and t.device.type == STAGED_DEVICE:
                dev = t.device
                out = func(*tree_map(lambda a: stage_through_host(a)
                                     if isinstance(a, torch.Tensor) else a,
                                     args), **kwargs)
                return funcol.wait_tensor(out).to(dev)
            return func(*args, **kwargs)

    with _Staged():
        yield


def staged_if_shared():
    """:func:`staged_collectives` where DTensor's collectives would carry
    CUDA tensors over gloo (ranks sharing a card), else a null context."""
    if torch.cuda.is_available() and dist.is_initialized() and \
            dist.get_backend() == "gloo":
        return staged_collectives()
    return contextlib.nullcontext()


def broadcast(t: torch.Tensor, src: int, pg=None) -> None:
    """``t`` from group rank ``src`` to every rank of ``pg``, in place; on
    gloo a CUDA tensor goes through a host copy."""
    root = dist.get_global_rank(pg, src) if pg is not None else src
    if dist.get_backend(pg) == "gloo" and t.device.type == STAGED_DEVICE:
        h = stage_through_host(t)
        dist.broadcast(h, src=root, group=pg)
        t.copy_(h)
        return
    dist.broadcast(t, src=root, group=pg)
