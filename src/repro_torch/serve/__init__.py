"""Adaptive-sampling serving subsystem.  Port of :mod:`repro.serve`.

Many concurrent approximation queries share one device without
head-of-line blocking: a query meets the scheduler only at its epoch
boundaries, where the engine state is whole (frames summed, pending deltas
and generator states held), so it can be stepped, checkpointed, resized or
retired there.

* :mod:`.session` — :class:`AdaptiveSession`, a checkpointable, resumable
  handle on one running query (bit-identical resume).
* :mod:`.scheduler` — :class:`EpochScheduler`, epoch-granular continuous
  batching with a max-in-flight admission policy and per-query τ
  accounting.
* :mod:`.elastic` — elastic re-sharding of SHARED_FRAME sessions (resume
  at a width W′ | W, bit-identical (τ, estimate)) and
  :func:`elastic_restore`.
* :mod:`.placement` — the worker-slot pool (lease/release of disjoint
  slots) and the :class:`PressurePolicy` that resizes SHARED_FRAME
  sessions under queued load.
"""

from .elastic import elastic_restore, reshard_session
from .placement import (DevicePool, DeviceTopology, Lease, PlacementWait,
                        PressurePolicy)
from .scheduler import EpochScheduler, QueryResult
from .session import AdaptiveSession, SessionSpec, StepperCache

__all__ = [
    "AdaptiveSession", "DevicePool", "DeviceTopology", "EpochScheduler",
    "Lease", "PlacementWait", "PressurePolicy", "QueryResult", "SessionSpec",
    "StepperCache", "elastic_restore", "reshard_session",
]
