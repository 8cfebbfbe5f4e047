"""Fault-tolerance runtime for the host training loop.  Port of
:mod:`repro.runtime.failures`.

* **fail-stop** — a worker dies: the loop restores from the last checkpoint
  and replays the data cursor (the pipeline is stateless, so replay is
  exactly-once).
* **stragglers** — a slow worker: ``Heartbeat`` flags steps past a
  deadline.
* **preemption** — checkpoint and exit; the next run resumes.

The injector simulates the events so that the recovery path runs end to
end (``launch/train.py --inject-failures``); it draws from numpy's
``default_rng`` with the reference's calls, so a seed gives the
reference's event sequence.
"""

from __future__ import annotations

import dataclasses
import enum
import time
from typing import Callable, Optional

import numpy as np


class FailureEvent(enum.Enum):
    NONE = "none"
    WORKER_CRASH = "worker_crash"      # fail-stop → restore + replay
    STRAGGLER = "straggler"            # slow worker → smaller frame
    PREEMPTION = "preemption"          # planned eviction → checkpoint + exit


@dataclasses.dataclass
class FailureInjector:
    seed: int = 0
    crash_prob: float = 0.0
    straggler_prob: float = 0.0
    preempt_at_step: Optional[int] = None

    def __post_init__(self):
        self._rng = np.random.default_rng(self.seed)

    def poll(self, step: int) -> FailureEvent:
        if self.preempt_at_step is not None and step == self.preempt_at_step:
            return FailureEvent.PREEMPTION
        u = self._rng.random()
        if u < self.crash_prob:
            return FailureEvent.WORKER_CRASH
        if u < self.crash_prob + self.straggler_prob:
            return FailureEvent.STRAGGLER
        return FailureEvent.NONE


class Heartbeat:
    """Wall-clock watchdog: flags steps exceeding ``deadline_s``."""

    def __init__(self, deadline_s: float,
                 on_late: Optional[Callable[[float], None]] = None):
        self.deadline_s = deadline_s
        self.on_late = on_late or (lambda dt: None)
        self._t0: Optional[float] = None
        self._late_steps = 0

    def start(self) -> None:
        self._t0 = time.monotonic()

    def stop(self) -> float:
        if self._t0 is None:
            raise RuntimeError("Heartbeat.stop() without start()")
        dt = time.monotonic() - self._t0
        if dt > self.deadline_s:
            self._late_steps += 1
            self.on_late(dt)
        self._t0 = None
        return dt

    @property
    def late_steps(self) -> int:
        return self._late_steps
