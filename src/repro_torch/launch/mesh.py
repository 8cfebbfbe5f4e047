"""Device pools for the serving scheduler.  Port of the part of
:mod:`repro.launch.mesh` that the adaptive-query pool uses; the meshes of
the multi-device substrate and of the model zoo wait for ROADMAP queue 1
items 8 and 11.
"""

from __future__ import annotations


def make_device_pool(topology: str = "auto"):
    """A :class:`repro_torch.serve.placement.DevicePool` over the machine
    topology — ``"auto"`` counts the host's CUDA devices, ``"N"``/``"GxN"``
    build abstract pools (see ``DeviceTopology.parse``)."""
    from ..serve.placement import DevicePool, DeviceTopology
    return DevicePool(DeviceTopology.parse(topology))
