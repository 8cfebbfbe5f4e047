"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet and the
Hopper white paper; dense rates, at the full 700 W power limit), and the
least time of a call bounded by them."""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12        # CUDA cores, no tensor cores
TF32_OPS_PER_S = 495e12
BF16_OPS_PER_S = 989e12
FP8_OPS_PER_S = 1979e12
INT8_OPS_PER_S = 1979e12


def least_seconds(nbytes: float, ops: float,
                  ops_per_s: float = F32_OPS_PER_S) -> float:
    """The larger of the time to move ``nbytes`` and to do ``ops``."""
    return max(nbytes / HBM_BYTES_PER_S, ops / ops_per_s)
