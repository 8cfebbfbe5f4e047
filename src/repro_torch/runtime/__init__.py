"""Fault-tolerance runtime of the port's training loop.  Port of
:mod:`repro.runtime`."""
from .elastic import elastic_restore
from .failures import FailureEvent, FailureInjector, Heartbeat

__all__ = ["FailureInjector", "FailureEvent", "Heartbeat", "elastic_restore"]
