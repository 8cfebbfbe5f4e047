"""The port's core: state frames, the epoch engine, stopping rules, the
instance layer, the substrates (sequential / vmap / shard_map on
``torch.distributed``) and the conformance and substrate-equivalence
harnesses."""

from .adaptive import AdaptiveResult, result_from_state, run_adaptive
from .distributed import (WorkerGroup, current_worker_group,
                          destroy_worker_group, init_worker_group)
from .epoch import EpochConfig, EpochProgram, EpochState, make_program
from .frames import (Collectives, FrameStrategy, StateFrame, accumulate,
                     combine, process_collectives, sequential_collectives,
                     shard_frame_pad, shard_groups, virtual_collectives,
                     zeros_like_frame)
from .instances import (AdaptiveInstance, BuiltInstance, available_instances,
                        get_instance, register_instance, run_instance)
from .substrate import (EpochStepper, Substrate, available_substrates,
                        make_stepper, resolve_substrate, run_on_substrate,
                        unavailable_reason, worker_group)

__all__ = [
    "AdaptiveInstance", "AdaptiveResult", "BuiltInstance", "Collectives",
    "EpochConfig", "EpochProgram", "EpochState", "EpochStepper",
    "FrameStrategy", "StateFrame", "Substrate", "WorkerGroup", "accumulate",
    "available_instances", "available_substrates", "combine",
    "current_worker_group", "destroy_worker_group", "get_instance",
    "init_worker_group", "make_program", "make_stepper",
    "process_collectives", "register_instance", "resolve_substrate",
    "result_from_state", "run_adaptive", "run_instance", "run_on_substrate",
    "sequential_collectives", "shard_frame_pad", "shard_groups",
    "unavailable_reason", "virtual_collectives", "worker_group",
    "zeros_like_frame",
]
