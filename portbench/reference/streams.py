"""How the port seeds its sampling streams, frozen here so that the
reference draws the same uniforms (``repro_torch/core/epoch.py``'s
documented scheme: worker w's ``torch.Generator`` on the run's device is
seeded by a splitmix64 chain over (0x5EED0001, seed, w); INDEXED_FRAME's
frame m by (0x5EED0002, seed, m))."""

from __future__ import annotations

import torch

_M64 = (1 << 64) - 1
WORKER_STREAM = 0x5EED_0001
INDEXED_STREAM = 0x5EED_0002


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & _M64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & _M64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & _M64
    return x ^ (x >> 31)


def mix(*xs: int) -> int:
    """A 63-bit mix of whole numbers of any size."""
    h = 0
    for x in xs:
        h = _splitmix64(h ^ (int(x) & _M64))
    return h >> 1


def generator(device, *xs: int) -> torch.Generator:
    gen = torch.Generator(device=device)
    gen.manual_seed(mix(*xs))
    return gen


def worker_generators(seed: int, world: int, device) -> list:
    return [generator(device, WORKER_STREAM, seed, w) for w in range(world)]


def frame_generators(seed: int, first: int, count: int, device) -> list:
    return [generator(device, INDEXED_STREAM, seed, m)
            for m in range(first, first + count)]
