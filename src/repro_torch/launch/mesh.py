"""Device pools and worker groups.  Port of the parts of
:mod:`repro.launch.mesh` that the adaptive-query pool and the shard_map
substrate use; the model zoo's meshes wait for ROADMAP queue 1 item 11.
"""

from __future__ import annotations


def make_worker_group(world: int, group=None, devices=None):
    """The worker group of ``world`` ranks that the epoch engine's
    shard_map substrate runs on — ``group``, or this process's current one
    (raises, saying how to launch, when there is none of that size).  The
    counterpart of the reference's ``make_worker_mesh``; ``devices`` (slot
    ids of a lease, in a rank of a rank pool) gives the lease's group,
    which every rank of the pool has made (``core.distributed.
    lease_group``)."""
    from ..core.substrate import worker_group
    if devices is not None:
        from ..core.distributed import lease_group
        group = lease_group(devices)
    return worker_group(world, group)


def make_device_pool(topology: str = "auto"):
    """A :class:`repro_torch.serve.placement.DevicePool` over the machine
    topology — ``"auto"`` counts the host's CUDA devices (the slots of the
    open rank pool, when there is one: the shard_map sessions' slots),
    ``"N"``/``"GxN"`` build abstract pools (see ``DeviceTopology.parse``).
    A lease binds a shard_map session to its ranks through
    ``SessionSpec.placement``."""
    from ..serve.placement import DevicePool, DeviceTopology
    return DevicePool(DeviceTopology.parse(topology))
