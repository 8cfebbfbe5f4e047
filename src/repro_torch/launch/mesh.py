"""Device pools and worker groups.  Port of the parts of
:mod:`repro.launch.mesh` that the adaptive-query pool and the shard_map
substrate use; the model zoo's meshes wait for ROADMAP queue 1 item 11.
"""

from __future__ import annotations


def make_worker_group(world: int, group=None):
    """The worker group of ``world`` ranks that the epoch engine's
    shard_map substrate runs on — ``group``, or this process's current one
    (raises, saying how to launch, when there is none of that size).  The
    counterpart of the reference's ``make_worker_mesh``."""
    from ..core.substrate import worker_group
    return worker_group(world, group)


def make_device_pool(topology: str = "auto"):
    """A :class:`repro_torch.serve.placement.DevicePool` over the machine
    topology — ``"auto"`` counts the host's CUDA devices, ``"N"``/``"GxN"``
    build abstract pools (see ``DeviceTopology.parse``)."""
    from ..serve.placement import DevicePool, DeviceTopology
    return DevicePool(DeviceTopology.parse(topology))
