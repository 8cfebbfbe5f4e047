"""Start W worker processes joined by one process group.

    results = spawn_workers(fn, 4, backend="gloo", device="cpu", args=(x,))

runs ``fn(group, *args)`` in ranks 0 … 3, each holding its
:class:`~repro_torch.core.distributed.WorkerGroup`, and returns their
return values in rank order.

- Processes start by the ``spawn`` method (CUDA cannot be forked), so
  ``fn``, ``args`` and the results are pickled: ``fn`` is a module-level
  function of an importable module (the ranks import it, and nothing of
  the module that called ``spawn_workers``), and results are best host
  values (numpy, numbers).
- The rendezvous is a file in a fresh temporary directory, so concurrent
  callers (test workers) cannot collide on a port.
- Each rank runs one intra-op CPU thread (``torch.set_num_threads(1)``),
  as ``torchrun`` does for several processes on a host.
- A rank that raises makes ``spawn_workers`` raise with that rank's
  traceback; a rank that dies without a result, or ranks still running
  after ``timeout`` seconds, make it kill every rank and raise.  It never
  waits past ``timeout`` (plus the start of the processes).
"""

from __future__ import annotations

import os
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, List, Sequence

from ..core.distributed import (DEFAULT_TIMEOUT_S, destroy_worker_group,
                                init_worker_group)


def _rank_main(fn, rank, world, backend, device, init_method, timeout, args,
               conn) -> None:
    import torch
    # W ranks share the host's cores: one intra-op thread each (torchrun's
    # default for several processes a host)
    torch.set_num_threads(1)
    try:
        group = init_worker_group(rank, world, backend=backend, device=device,
                                  init_method=init_method, timeout=timeout)
        try:
            out = ("ok", fn(group, *args))
        finally:
            destroy_worker_group()
    except Exception:  # the rank's failure goes to the parent, which raises
        out = ("error", traceback.format_exc())
    try:
        conn.send(out)
    except Exception:  # an unpicklable result
        conn.send(("error", traceback.format_exc()))
    conn.close()


def spawn_workers(fn: Callable, world: int, *, backend=None, device=None,
                  args: Sequence[Any] = (),
                  timeout: float = DEFAULT_TIMEOUT_S) -> List[Any]:
    """Run ``fn(group, *args)`` in ``world`` new processes, rank r on its
    :class:`~repro_torch.core.distributed.WorkerGroup` (``backend`` and
    ``device`` as in :func:`~repro_torch.core.distributed.init_worker_group`),
    and return the ranks' results in rank order."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    tmp = tempfile.mkdtemp(prefix="repro_torch_group_")
    init_method = "file://" + os.path.join(tmp, "rendezvous")
    procs, conns = [], []
    try:
        for rank in range(world):
            recv, send = ctx.Pipe(duplex=False)
            proc = ctx.Process(
                target=_rank_main, daemon=True,
                args=(fn, rank, world, backend, device, init_method, timeout,
                      tuple(args), send))
            proc.start()
            send.close()
            procs.append(proc)
            conns.append(recv)
        results: List[Any] = [None] * world
        waiting = set(range(world))
        deadline = time.monotonic() + timeout
        while waiting:
            left = deadline - time.monotonic()
            if left <= 0:
                raise TimeoutError(
                    f"spawn_workers: rank(s) {sorted(waiting)} of {world} "
                    f"still running after {timeout} s; every rank killed")
            wait([conns[r] for r in waiting] +
                 [procs[r].sentinel for r in waiting], timeout=left)
            for rank in sorted(waiting):
                if conns[rank].poll():
                    try:
                        status, value = conns[rank].recv()
                    except EOFError:
                        status, value = "died", None
                elif not procs[rank].is_alive():
                    status, value = "died", None
                else:
                    continue
                if status == "error":
                    raise RuntimeError(f"rank {rank} of {world} raised:\n"
                                       f"{value}")
                if status == "died":
                    raise RuntimeError(
                        f"rank {rank} of {world} exited with code "
                        f"{procs[rank].exitcode} without a result")
                results[rank] = value
                waiting.discard(rank)
        for proc in procs:
            proc.join(timeout=max(1.0, deadline - time.monotonic()))
        return results
    finally:
        for proc in procs:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
        for conn in conns:
            conn.close()
        shutil.rmtree(tmp, ignore_errors=True)


# -- entries for checking a worker group: picklable by reference ----------


def rank_info(group) -> tuple:
    """(rank, world, backend, device) of the rank that runs it."""
    return group.rank, group.world, group.backend, str(group.device)


def vote(group, flags: Sequence[bool]) -> bool:
    """Rank r holds ``flags[r]``; all agree on it or every rank raises."""
    return group.agree(flags[group.rank])


def raise_on(group, rank: int) -> int:
    """Raise on ``rank``; the others return their rank."""
    if group.rank == rank:
        raise ValueError(f"rank {rank} was asked to raise")
    return group.rank


def sleep(group, seconds: float) -> int:
    time.sleep(seconds)
    return group.rank
