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

:class:`RankPool` keeps n such ranks alive across calls: each runs a
command loop, and the controller sends it module-level entries
(``entry(group, *args)``, picklable by reference as above) and gets their
results back in rank order::

    with RankPool(4, backend="gloo", device="cpu") as ranks:
        ranks.call(vote, (True,) * 4)              # every rank, in order
        t = ranks.send(rank_info, ranks=(2, 3))    # returns at once
        ranks.wait(t)                              # ranks 2 and 3's results

Entries run on each rank in the order they were sent, so two sends to
overlapping ranks never cross.  Messages are pickled; each numpy array of
``SPILL_BYTES`` or more in them goes through a ``.npy`` file in the pool's
temporary directory instead of the pipe: one large write and read, where
a pipe moves at most 64 KB a system call (on a sandboxed host many times
slower than the file).  The failure contract is
``spawn_workers``'s: an entry that raises, a rank that dies, or a reply
later than ``timeout`` after its send makes the call raise, and every
rank is killed (the pool is closed from then on).  ``close()`` always
reaps the ranks.
"""

from __future__ import annotations

import io
import itertools
import os
import pickle
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

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


SPILL_BYTES = 1 << 20


class _Pickler(pickle.Pickler):
    """Pickles numpy arrays of ``SPILL_BYTES`` or more as ``.npy`` files in
    ``spill_dir``, by path."""

    def __init__(self, f, spill_dir: str):
        super().__init__(f, protocol=pickle.HIGHEST_PROTOCOL)
        self.spill_dir = spill_dir

    def persistent_id(self, obj):
        import numpy as np
        if isinstance(obj, np.ndarray) and obj.nbytes >= SPILL_BYTES \
                and not obj.dtype.hasobject:
            fd, path = tempfile.mkstemp(suffix=".npy", dir=self.spill_dir)
            with os.fdopen(fd, "wb") as f:
                np.save(f, obj, allow_pickle=False)
            return path
        return None


class _Unpickler(pickle.Unpickler):
    def persistent_load(self, path):
        import numpy as np
        a = np.load(path, allow_pickle=False)
        os.unlink(path)
        return a


def _send(conn, obj, spill_dir: str) -> None:
    buf = io.BytesIO()
    _Pickler(buf, spill_dir).dump(obj)
    conn.send_bytes(buf.getbuffer())


def _recv(conn):
    return _Unpickler(io.BytesIO(conn.recv_bytes())).load()


def _rank_loop(rank, world, backend, device, init_method, timeout,
               conn, spill_dir) -> None:
    """A rank of a :class:`RankPool`: join the group, then run the entries
    the controller sends, one at a time, until it sends ``None``."""
    import torch
    torch.set_num_threads(1)
    try:
        group = init_worker_group(rank, world, backend=backend, device=device,
                                  init_method=init_method, timeout=timeout)
    except Exception:
        _send(conn, (-1, "error", traceback.format_exc()), spill_dir)
        return
    try:
        while True:
            msg = _recv(conn)
            if msg is None:
                break
            seq, fn, args = msg
            try:
                out = (seq, "ok", fn(group, *args))
            except Exception:  # the controller raises it and kills the pool
                out = (seq, "error", traceback.format_exc())
            try:
                _send(conn, out, spill_dir)
            except Exception:  # an unpicklable result
                _send(conn, (seq, "error", traceback.format_exc()), spill_dir)
    finally:
        destroy_worker_group()
        conn.close()


_CURRENT_POOL: Optional["RankPool"] = None
START_S = 120.0   # a pool's ranks may take this long to start, past timeout


def current_rank_pool() -> Optional["RankPool"]:
    """The open :class:`RankPool` entered last in this process, if any."""
    return _CURRENT_POOL


class RankPool:
    """n long-lived ranks joined by one process group (see the module
    docstring).  ``device`` and ``backend`` are as in
    :func:`~repro_torch.core.distributed.init_worker_group`: rank i runs
    on ``cuda:(i % device_count)`` unless ``device="cpu"``.  The
    constructor returns once every rank has joined (``spawn_s`` seconds).
    Entering it as a context manager makes it this process's current
    pool (:func:`current_rank_pool`), which the serving layer's shard_map
    sessions run on.  Starting it may take ``START_S`` seconds past
    ``timeout`` (the processes import torch and join the group)."""

    def __init__(self, n: int, *, backend=None, device=None,
                 timeout: float = DEFAULT_TIMEOUT_S):
        import torch
        import torch.multiprocessing as mp
        if n < 1:
            raise ValueError(f"a rank pool needs n >= 1 ranks, got {n}")
        self.world = n
        self.timeout = timeout
        cuda = device is None or torch.device(device).type == "cuda"
        self.device_type = "cuda" if cuda else "cpu"
        self.backend = backend or ("nccl" if cuda else "gloo")
        self.closed = False
        self._seq = itertools.count()
        self._replies: List[Dict[int, Any]] = [
            {} for _ in range(n)]
        self._procs, self._conns = [], []
        self._tmp = tempfile.mkdtemp(prefix="repro_torch_pool_")
        init_method = "file://" + os.path.join(self._tmp, "rendezvous")
        ctx = mp.get_context("spawn")
        t0 = time.monotonic()
        try:
            for rank in range(n):
                here, there = ctx.Pipe(duplex=True)
                proc = ctx.Process(
                    target=_rank_loop, daemon=True,
                    # the ranks' own group timeout leaves the start its
                    # room; the controller holds each call to ``timeout``
                    args=(rank, n, self.backend, device, init_method,
                          timeout + START_S, there, self._tmp))
                proc.start()
                there.close()
                self._procs.append(proc)
                self._conns.append(here)
            # the first reply also waits for the ranks to start and join
            self.wait(self.send(rank_info, start_s=START_S))
        except BaseException:
            self.close()
            raise
        self.spawn_s = time.monotonic() - t0

    def slot_device(self, i: int):
        """The device rank ``i`` runs on."""
        import torch
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", i % torch.cuda.device_count())

    # ------------------------------------------------------------ calling
    def send(self, fn: Callable, *args,
             ranks: Optional[Sequence[int]] = None,
             each: Optional[Sequence[tuple]] = None,
             start_s: float = 0.0) -> tuple:
        """Send ``fn(group, *args)`` to ``ranks`` (default: all) without
        waiting; returns the ticket :meth:`wait` takes, whose deadline is
        ``timeout`` (+ ``start_s``) from now.  ``each[i]``, when given, adds
        arguments of the i-th rank's own after ``args``."""
        self._check_open()
        ranks = tuple(range(self.world)) if ranks is None else tuple(ranks)
        if each is not None and len(each) != len(ranks):
            raise ValueError(f"{len(each)} argument tuples for "
                             f"{len(ranks)} ranks")
        seq = next(self._seq)
        try:
            for i, r in enumerate(ranks):
                _send(self._conns[r], (seq, fn, args if each is None
                                       else (*args, *each[i])), self._tmp)
        except Exception as e:  # a rank that is gone: its pipe is broken
            dead = [r for r, p in enumerate(self._procs) if not p.is_alive()]
            self._fail(f"rank(s) {dead} of {self.world} exited; sending "
                       f"{getattr(fn, '__name__', fn)} failed ({e!r})")
        return seq, ranks, time.monotonic() + self.timeout + start_s

    def wait(self, ticket: tuple) -> List[Any]:
        """The results of a :meth:`send`, in the order of its ranks.  Any
        rank of the pool that dies while it waits fails the call at once
        (its peers may be blocked in a collective with it)."""
        seq, ranks, deadline = ticket
        missing = [r for r in ranks if seq not in self._replies[r]]
        while missing:
            left = deadline - time.monotonic()
            if left <= 0:
                self._fail(f"rank(s) {missing} of {self.world} gave no reply "
                           f"to call {seq} within {self.timeout} s")
            wait([self._conns[r] for r in missing] +
                 [p.sentinel for p in self._procs], timeout=left)
            for r in missing:
                while self._conns[r].poll():
                    self._receive(r)
            for r, proc in enumerate(self._procs):
                if not proc.is_alive() and not self._conns[r].poll():
                    self._fail(f"rank {r} of {self.world} exited with code "
                               f"{proc.exitcode}")
            missing = [r for r in ranks if seq not in self._replies[r]]
        return [self._replies[r].pop(seq) for r in ranks]

    def call(self, fn: Callable, *args,
             ranks: Optional[Sequence[int]] = None,
             each: Optional[Sequence[tuple]] = None) -> List[Any]:
        """``wait(send(fn, *args, ranks=ranks, each=each))``."""
        return self.wait(self.send(fn, *args, ranks=ranks, each=each))

    def _receive(self, r: int) -> None:
        try:
            seq, status, value = _recv(self._conns[r])
        except (EOFError, OSError):  # its end of the pipe closed with it
            self._fail(f"rank {r} of {self.world} exited with code "
                       f"{self._procs[r].exitcode}")
        if status == "error":
            self._fail(f"rank {r} of {self.world} raised:\n{value}")
        self._replies[r][seq] = value

    def _fail(self, message: str):
        self.close(kill=True)
        raise RuntimeError(f"{message}; every rank of the pool killed")

    def _check_open(self) -> None:
        if self.closed:
            raise RuntimeError("the rank pool is closed")

    # ------------------------------------------------------------ closing
    def close(self, kill: bool = False) -> None:
        """Stop and reap every rank: each is asked to leave its loop and
        killed if it has not within a few seconds (at once with
        ``kill``)."""
        global _CURRENT_POOL
        if _CURRENT_POOL is self:
            _CURRENT_POOL = None
        if self.closed and not self._procs:
            return
        self.closed = True
        if not kill:
            for conn in self._conns:
                try:
                    _send(conn, None, self._tmp)
                except Exception:
                    pass
            end = time.monotonic() + 5.0
            for proc in self._procs:
                proc.join(timeout=max(0.0, end - time.monotonic()))
        for proc in self._procs:
            if proc.is_alive():
                proc.kill()
            proc.join(timeout=10)
        for conn in self._conns:
            conn.close()
        self._procs, self._conns = [], []
        shutil.rmtree(self._tmp, ignore_errors=True)

    def __enter__(self) -> "RankPool":
        global _CURRENT_POOL
        self._check_open()
        self._outer = _CURRENT_POOL
        _CURRENT_POOL = self
        return self

    def __exit__(self, *exc) -> None:
        global _CURRENT_POOL
        self.close()
        _CURRENT_POOL = getattr(self, "_outer", None)

    def __del__(self):
        if getattr(self, "_procs", None):
            try:
                self.close(kill=True)
            except Exception:
                pass


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


def foreign_modules(group, tops: Sequence[str] = ("jax", "jaxlib", "repro")
                    ) -> List[str]:
    """The modules the rank has imported from the packages ``tops``."""
    import sys
    return sorted(m for m in sys.modules if m.split(".")[0] in tops)
