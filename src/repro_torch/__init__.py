"""PyTorch/CUDA port of the adaptive-sampling system in :mod:`repro`.

The layout mirrors :mod:`repro` module for module (``core/``, ``graphs/``,
``sampling/``, ``optim/``, ``kernels/``, ``configs/``), so each port module has one reference module it
is tested against.  The port imports ``torch`` and numpy and never ``jax``
or any module of :mod:`repro`.

Entry points take ``device=None``, which means the CUDA card: they raise
when CUDA is absent and never carry on on the CPU unless the caller passes
``device="cpu"`` explicitly (as the tests do).
"""

from .device import resolve_device

__all__ = ["resolve_device"]
