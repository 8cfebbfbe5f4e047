"""Roofline terms of a step on one card.  Port of
:mod:`repro.analysis.roofline` for the H100:

    compute    = flops_per_device    / peak_flops   [s]
    memory     = bytes_per_device    / hbm_bw       [s]
    collective = coll_bytes_per_dev  / link_bw      [s]

The counts come from closed forms (``model_flops``, ``analysis.analytic``)
or from a measured sharded call (``analysis.comms``), not from a compiler's
cost analysis, so no layer differencing is needed; ``combine_layer_diff``
is kept for parity with the reference.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

from ..models.config import ModelConfig, ShapeConfig


@dataclasses.dataclass(frozen=True)
class HardwareSpec:
    name: str
    peak_flops: float        # per card, bf16 tensor cores, dense
    hbm_bw: float            # bytes/s per card
    link_bw: float           # bytes/s per direction over NVLink, per card


# NVIDIA H100 80GB HBM3, 700 W (SXM5), datasheet peaks: 989e12 bf16 op/s
# on the tensor cores (dense), 3.35e12 B/s of HBM3, and 900 GB/s of NVLink 4
# per card in both directions together, 450e9 B/s each way
H100 = HardwareSpec(name="nvidia-h100-sxm", peak_flops=989e12, hbm_bw=3.35e12,
                    link_bw=450e9)


@dataclasses.dataclass
class RooflineTerms:
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    chips: int
    compute_s: float = 0.0
    memory_s: float = 0.0
    collective_s: float = 0.0
    dominant: str = ""
    model_flops_total: float = 0.0
    useful_ratio: float = 0.0     # MODEL_FLOPS / (flops_per_dev · chips)

    def finalize(self, hw: HardwareSpec = H100) -> "RooflineTerms":
        self.compute_s = self.flops_per_dev / hw.peak_flops
        self.memory_s = self.bytes_per_dev / hw.hbm_bw
        self.collective_s = self.coll_bytes_per_dev / hw.link_bw
        terms = {"compute": self.compute_s, "memory": self.memory_s,
                 "collective": self.collective_s}
        self.dominant = max(terms, key=terms.get)
        total = self.flops_per_dev * self.chips
        self.useful_ratio = self.model_flops_total / total if total else 0.0
        return self

    def as_dict(self) -> Dict:
        return dataclasses.asdict(self)


def model_flops(cfg: ModelConfig, shape: ShapeConfig) -> float:
    """Closed-form MODEL_FLOPS: 6·N·D (train), 2·N·D (prefill), 2·N·B
    (decode, per emitted token), N the active parameters (moe-aware)."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        return 6.0 * n * shape.seq_len * shape.global_batch
    if shape.kind == "prefill":
        return 2.0 * n * shape.seq_len * shape.global_batch
    return 2.0 * n * shape.global_batch


def roofline_terms(*, flops_per_dev: float, bytes_per_dev: float,
                   coll_bytes_per_dev: float, chips: int,
                   cfg: Optional[ModelConfig] = None,
                   shape: Optional[ShapeConfig] = None,
                   hw: HardwareSpec = H100) -> RooflineTerms:
    mf = model_flops(cfg, shape) if cfg is not None and shape is not None else 0.0
    return RooflineTerms(flops_per_dev=flops_per_dev,
                         bytes_per_dev=bytes_per_dev,
                         coll_bytes_per_dev=coll_bytes_per_dev,
                         chips=chips, model_flops_total=mf).finalize(hw)


def combine_layer_diff(base: Dict[str, float], two: Dict[str, float],
                       n_layers: int) -> Dict[str, float]:
    """total(L) = base + (L−1)·(two − base) for each cost key."""
    out = {}
    for k in base:
        per_layer = two.get(k, 0.0) - base.get(k, 0.0)
        out[k] = base[k] + max(per_layer, 0.0) * (n_layers - 1)
    return out
