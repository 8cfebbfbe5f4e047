"""Device selection and the host-sync counter of the port."""

from __future__ import annotations

import torch

# Host reads of device values on the main path (loop predicates, verdicts).
# Each one stalls the host until the card has caught up; ``to_host`` counts
# them so a run can report syncs per epoch.
host_syncs = 0


def resolve_device(device=None) -> torch.device:
    """``None`` → the CUDA card (raises if CUDA is unavailable); anything
    else is taken as given, so callers opt into the CPU explicitly."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "repro_torch runs on a CUDA device by default and none is "
                "available; pass device='cpu' to run on the CPU explicitly")
        return torch.device("cuda")
    return torch.device(device)


def to_host(x):
    """Read a 0-d tensor on the host (one counted sync)."""
    global host_syncs
    host_syncs += 1
    return x.item()
