"""Elastic rescaling lives in :mod:`repro_torch.serve.elastic`; this module
re-exports :func:`elastic_restore` under its old name, as the reference's
:mod:`repro.runtime.elastic` does."""

from __future__ import annotations

from ..serve.elastic import elastic_restore

__all__ = ["elastic_restore"]
