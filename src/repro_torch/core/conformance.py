"""Cross-strategy conformance harness.  Port of
:mod:`repro.core.conformance` (substrate equivalence waits for the
multi-device substrate).

Runs one registered instance under every (or a chosen subset of)
:class:`~repro_torch.core.frames.FrameStrategy` × virtual world size on one
device and checks the paper's invariants.  Per cell (strategy, W):

1. **Termination** — the engine stops before ``max_epochs``.
2. **Sample-count consistency** (Prop. 1) — ``total.num`` is a whole number
   of epoch frames (× W, except under INDEXED_FRAME).
3. **(ε, δ) accuracy** — the estimate is within ε of the exact oracle and
   within 2ε of the W=1 BARRIER run.

Across cells:

4. **INDEXED_FRAME determinism** — bit-identical τ and trimmed data for
   every W.
5. **SHARED_FRAME reassembly** — the shards glued back together equal the
   LOCAL_FRAME total at the same (seed, W).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..device import resolve_device
from .frames import FrameStrategy, leaves
from .instances import (AdaptiveInstance, available_instances, get_instance,
                        run_instance)

DEFAULT_WORLDS = (1, 2, 4)


@dataclasses.dataclass
class CellResult:
    instance: str
    strategy: FrameStrategy
    world: int
    num: int
    stopped: bool
    err_oracle: float
    err_sequential: float
    failures: List[str]
    estimate: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros(0))

    @property
    def ok(self) -> bool:
        return not self.failures


@dataclasses.dataclass
class ConformanceReport:
    instance: str
    cells: List[CellResult]
    cross_failures: List[str]

    @property
    def ok(self) -> bool:
        return not self.cross_failures and all(c.ok for c in self.cells)

    @property
    def failures(self) -> List[str]:
        out = [f for c in self.cells for f in c.failures]
        return out + list(self.cross_failures)

    def summary(self) -> str:
        lines = [f"conformance[{self.instance}]: "
                 f"{sum(c.ok for c in self.cells)}/{len(self.cells)} cells ok"]
        for c in self.cells:
            tag = "ok " if c.ok else "FAIL"
            lines.append(f"  {tag} {c.strategy.name:13s} W={c.world} "
                         f"τ={c.num:6d} err={c.err_oracle:.4f}"
                         + ("" if c.ok else f"  <- {'; '.join(c.failures)}"))
        lines += [f"  CROSS FAIL: {f}" for f in self.cross_failures]
        return "\n".join(lines)


def _tree_equal(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        np.array_equal(np.asarray(x), np.asarray(y)) for x, y in zip(la, lb))


def run_conformance(instance: "str | AdaptiveInstance", *,
                    strategies: Optional[Sequence[FrameStrategy]] = None,
                    worlds: Sequence[int] = DEFAULT_WORLDS,
                    seed: int = 0, device=None) -> ConformanceReport:
    """Sweep one instance over strategies × worlds on ``device`` (``None`` →
    the CUDA card) and check all invariants."""
    device = resolve_device(device)
    inst = get_instance(instance) if isinstance(instance, str) else instance
    strategies = list(strategies) if strategies is not None \
        else list(FrameStrategy)

    # W=1 sequential oracle: BARRIER at W=1 checks after every epoch — the
    # reference Algorithm 1 execution.
    ref_est, _, _ = run_instance(inst, strategy=FrameStrategy.BARRIER, world=1,
                                 seed=seed, device=device)

    cells: List[CellResult] = []
    indexed: Dict[int, Tuple[int, object]] = {}
    local: Dict[int, Tuple[int, object]] = {}
    shared: Dict[int, Tuple[int, object]] = {}

    for strat in strategies:
        for world in worlds:
            est, res, built = run_instance(inst, strategy=strat, world=world,
                                           seed=seed, device=device)
            failures: List[str] = []
            where = f"{built.name}/{strat.name}/W={world}"

            if not res.stopped:
                failures.append(f"{where}: did not stop "
                                f"within {built.max_epochs} epochs")

            # Prop. 1: τ = Σ over integral per-worker frame prefixes.
            spf = built.samples_per_round * (
                1 if strat == FrameStrategy.LOCK else built.rounds_per_epoch)
            unit = spf if strat == FrameStrategy.INDEXED_FRAME \
                else spf * world
            if res.num <= 0 or res.num % unit != 0:
                failures.append(f"{where}: τ={res.num} is not a whole number "
                                f"of {unit}-sample frame sets")

            err_o = float(np.max(np.abs(est - built.oracle)))
            if err_o > built.eps:
                failures.append(f"{where}: oracle error {err_o:.4f} "
                                f"> ε={built.eps:.4f}")
            err_s = float(np.max(np.abs(est - ref_est)))
            if err_s > 2.0 * built.eps:
                failures.append(f"{where}: deviates from W=1 sequential "
                                f"oracle by {err_s:.4f} > 2ε")

            trimmed = built.trim(res.data)
            if strat == FrameStrategy.INDEXED_FRAME:
                indexed[world] = (res.num, trimmed)
            elif strat == FrameStrategy.LOCAL_FRAME:
                local[world] = (res.num, trimmed)
            elif strat == FrameStrategy.SHARED_FRAME:
                shared[world] = (res.num, trimmed)

            cells.append(CellResult(
                instance=built.name, strategy=strat, world=world,
                num=res.num, stopped=res.stopped, err_oracle=err_o,
                err_sequential=err_s, failures=failures, estimate=est))

    cross: List[str] = []
    if len(indexed) > 1:
        w0 = min(indexed)
        num0, data0 = indexed[w0]
        for w, (num, data) in sorted(indexed.items()):
            if num != num0:
                cross.append(f"INDEXED_FRAME τ differs across worlds: "
                             f"W={w0}→{num0}, W={w}→{num}")
            if not _tree_equal(data, data0):
                cross.append(f"INDEXED_FRAME data differs: W={w0} vs W={w}")
    for w in sorted(set(local) & set(shared)):
        num_l, data_l = local[w]
        num_s, data_s = shared[w]
        if num_l != num_s:
            cross.append(f"W={w}: SHARED τ={num_s} ≠ LOCAL τ={num_l}")
        if not _tree_equal(data_l, data_s):
            cross.append(f"W={w}: SHARED shard reassembly ≠ LOCAL total")

    return ConformanceReport(instance=inst.name, cells=cells,
                             cross_failures=cross)


def run_all(*, strategies: Optional[Sequence[FrameStrategy]] = None,
            worlds: Sequence[int] = DEFAULT_WORLDS, seed: int = 0,
            device=None) -> Dict[str, ConformanceReport]:
    """Conformance across every registered instance; ``seed`` flows into
    every cell and each sweep's W=1 reference run."""
    device = resolve_device(device)
    return {name: run_conformance(name, strategies=strategies, worlds=worlds,
                                  seed=seed, device=device)
            for name in available_instances()}
