"""Meshes, device pools and worker groups.  Port of :mod:`repro.launch.mesh`.

The model zoo's meshes are plain descriptions, (shape, axis names), that
hold no devices: :func:`make_production_mesh` and :func:`make_mesh` build
them without touching device state, as the reference's functions are
functions so that an import never touches JAX's.  The sharding rules and
the dry run read only a description; :func:`device_mesh` binds one to a
``torch.distributed`` ``DeviceMesh`` over the current process group, for
a sharded run (``launch/sharded.py``).  The worker groups and device pools
are the adaptive-query pool's and the shard_map substrate's.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class MeshDesc:
    """A mesh's shape and axis names, no devices."""
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]

    def __post_init__(self):
        if len(self.shape) != len(self.axis_names):
            raise ValueError(f"mesh shape {self.shape} and axes "
                             f"{self.axis_names} differ in length")

    @property
    def size(self) -> int:
        return math.prod(self.shape)

    @property
    def name(self) -> str:
        return "x".join(str(n) for n in self.shape)


def make_production_mesh(*, multi_pod: bool = False) -> MeshDesc:
    """The reference's production meshes: (16, 16) ("data", "model"), or
    (2, 16, 16) ("pod", "data", "model") with ``multi_pod``."""
    if multi_pod:
        return MeshDesc((2, 16, 16), ("pod", "data", "model"))
    return MeshDesc((16, 16), ("data", "model"))


def make_mesh(shape, axes) -> MeshDesc:
    """Any mesh description (tests use small ones, e.g. (2, 2))."""
    return MeshDesc(tuple(int(n) for n in shape), tuple(axes))


def device_mesh(desc: MeshDesc, device=None):
    """``desc`` as a ``DeviceMesh`` over the current process group (whose
    world size must be ``desc.size``), on the card unless ``device`` says
    the CPU; rank r at position r of the mesh in row-major order."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    from ..device import resolve_device
    if not dist.is_initialized() or dist.get_world_size() != desc.size:
        have = dist.get_world_size() if dist.is_initialized() else 0
        raise RuntimeError(f"device_mesh: mesh {desc.name} needs a process "
                           f"group of {desc.size} ranks, not {have} "
                           f"(launch.spawn.spawn_workers starts one)")
    return init_device_mesh(resolve_device(device).type, desc.shape,
                            mesh_dim_names=desc.axis_names)


def dp_axes(mesh) -> tuple:
    """The data-parallel axes of a mesh (everything but 'model')."""
    from ..models.layers import mesh_axes
    return tuple(a for a in mesh_axes(mesh)[0] if a != "model")


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
