"""ADS instance layer — workloads as registered objects.  Port of
:mod:`repro.core.instances`.

An :class:`AdaptiveInstance` bundles what the engine and the harnesses
need about one workload — SAMPLE() (``sample_fn(gens, carry)``),
CHECKFORSTOP() (``check_fn``), the frame template (padded for
SHARED_FRAME), the exact oracle and the extraction of the estimate — and a
registry maps names to instances, so the conformance harness iterates
``for name in available_instances()``.

Registered, with the reference's defaults: ``kadabra``, ``triangles``,
``reachability``, ``wrs``, ``diameter`` and ``gradvar``.

``build`` takes the device the instance runs on (``None`` → the CUDA
card); graphs, tables and oracles are built once per (instance, device).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, Protocol, Tuple, runtime_checkable

import numpy as np
import torch

from ..device import resolve_device
from .adaptive import AdaptiveResult, run_adaptive
from .frames import FrameStrategy, shard_frame_pad, tree_map
from .substrate import group_and_device

PyTree = Any


@dataclasses.dataclass(frozen=True)
class BuiltInstance:
    """One workload, materialized for a given (world, strategy, device).

    ``true_len`` is the unpadded length of vector frame leaves; :meth:`trim`
    strips SHARED_FRAME padding from result data (numpy), so estimates and
    cross-strategy comparisons happen on canonical data.
    """

    name: str
    sample_fn: Callable
    check_fn: Callable
    template: PyTree
    init_carry: PyTree
    samples_per_round: int        # frame.num of one worker in one round
    true_len: int
    eps: float                    # tolerance in estimate units
    delta: float
    oracle: np.ndarray            # exact value of the estimand (flat vector)
    estimate: Callable[[PyTree, float], np.ndarray]  # (trimmed data, τ) -> vec
    rounds_per_epoch: int = 2
    max_epochs: int = 4000

    def trim(self, data: PyTree) -> PyTree:
        def t(x):
            a = np.asarray(x)
            return a[: self.true_len] if a.ndim >= 1 else a
        return tree_map(t, data)


@runtime_checkable
class AdaptiveInstance(Protocol):
    """A registrable ADS workload: a name plus a ``build`` factory."""

    name: str

    def build(self, *, world: int = 1,
              strategy: FrameStrategy = FrameStrategy.LOCAL_FRAME,
              device=None) -> BuiltInstance: ...


_REGISTRY: Dict[str, AdaptiveInstance] = {}


def register_instance(instance: AdaptiveInstance, *,
                      overwrite: bool = False) -> AdaptiveInstance:
    if not overwrite and instance.name in _REGISTRY:
        raise ValueError(f"instance {instance.name!r} already registered")
    _REGISTRY[instance.name] = instance
    return instance


def get_instance(name: str) -> AdaptiveInstance:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise KeyError(f"unknown instance {name!r}; "
                       f"available: {available_instances()}") from None


def available_instances() -> Tuple[str, ...]:
    return tuple(sorted(_REGISTRY))


def run_instance(instance: "str | AdaptiveInstance", *,
                 strategy: "str | FrameStrategy" = FrameStrategy.LOCAL_FRAME,
                 world: int = 1, seed: int = 0,
                 substrate: "str | None" = None, frame_shards: int = 0,
                 device=None, group=None,
                 ) -> Tuple[np.ndarray, AdaptiveResult, BuiltInstance]:
    """Build and run one workload on ``device`` (``None`` → the CUDA card);
    returns (estimate, result, built).  ``substrate``, ``frame_shards`` and
    ``group`` are as in :func:`repro_torch.core.adaptive.run_adaptive`: on
    SHARD_MAP each rank builds the instance on its own device (the rank's,
    unless ``device`` names one)."""
    group, device = group_and_device(substrate, world, device, group)
    device = resolve_device(device)
    inst = get_instance(instance) if isinstance(instance, str) else instance
    strat = FrameStrategy(strategy) if isinstance(strategy, str) else strategy
    built = inst.build(world=world, strategy=strat, device=device)
    res = run_adaptive(built.sample_fn, built.check_fn, built.template,
                       strategy=strat, world=world, seed=seed,
                       rounds_per_epoch=built.rounds_per_epoch,
                       max_epochs=built.max_epochs,
                       init_carry=built.init_carry,
                       substrate=substrate, frame_shards=frame_shards,
                       device=device, group=group)
    est = built.estimate(built.trim(res.data), float(res.num))
    return est, res, built


# ---------------------------------------------------------------------------
# Built-in instances.  Graphs, tables and oracles are memoized per
# (instance, device): they are pure functions of the frozen params.
# ---------------------------------------------------------------------------

_CACHE: Dict[Any, Any] = {}


def _cached(key, fn):
    if key not in _CACHE:
        _CACHE[key] = fn()
    return _CACHE[key]


def _pad_for(n: int, world: int, strategy: FrameStrategy) -> int:
    return shard_frame_pad(n, world) if strategy == FrameStrategy.SHARED_FRAME \
        else n


@dataclasses.dataclass(frozen=True)
class KadabraInstance:
    """Betweenness-centrality approximation (the paper's case study)."""

    name: str = "kadabra"
    n_vertices: int = 32
    n_edges: int = 96
    graph_seed: int = 1
    eps: float = 0.1
    delta: float = 0.1
    batch: int = 32
    rounds_per_epoch: int = 2
    max_epochs: int = 4000
    compute_oracle: bool = True

    def _graph(self, device):
        def make():
            from ..graphs import brandes_exact, erdos_renyi
            from ..graphs.kadabra import preprocess
            g = erdos_renyi(self.n_vertices, self.n_edges, seed=self.graph_seed,
                            device=device)
            pre = preprocess(g, self.eps, self.delta, device=device)
            oracle = brandes_exact(g) if self.compute_oracle \
                else np.full((g.n,), np.nan)
            return g, pre, oracle
        return _cached(("kadabra", self, device), make)

    def build(self, *, world: int = 1,
              strategy: FrameStrategy = FrameStrategy.LOCAL_FRAME,
              device=None) -> BuiltInstance:
        from ..graphs.kadabra import frame_template, make_sample_fn
        from .stopping import KadabraCondition
        device = resolve_device(device)
        g, pre, oracle = self._graph(device)
        pad = _pad_for(g.n, world, strategy)
        cond = KadabraCondition(eps=self.eps, delta=self.delta,
                                omega=pre.omega, n_vertices=g.n)

        def estimate(data: PyTree, num: float) -> np.ndarray:
            return np.asarray(data, np.float64) / max(num, 1.0)

        return BuiltInstance(
            name=self.name, sample_fn=make_sample_fn(g, pre, self.batch,
                                                     pad_to=pad),
            check_fn=cond, template=frame_template(g, pad), init_carry=None,
            samples_per_round=self.batch, true_len=g.n,
            eps=self.eps, delta=self.delta, oracle=oracle,
            estimate=estimate, rounds_per_epoch=self.rounds_per_epoch,
            max_epochs=self.max_epochs)


@dataclasses.dataclass(frozen=True)
class TrianglesInstance:
    """Triangle counting via wedge sampling (estimate in count units)."""

    name: str = "triangles"
    n_vertices: int = 40
    m_per: int = 3
    graph_seed: int = 2
    eps_p: float = 0.05           # Hoeffding tolerance on the closure prob
    delta: float = 0.1
    batch: int = 64
    rounds_per_epoch: int = 2
    max_epochs: int = 4000
    compute_oracle: bool = True

    def _graph(self, device):
        def make():
            from ..graphs import barabasi_albert
            from ..graphs.triangles import triangles_exact, wedge_weights
            g = barabasi_albert(self.n_vertices, self.m_per,
                                seed=self.graph_seed, device=device)
            _, w_total = wedge_weights(g)
            t_exact = triangles_exact(g) if self.compute_oracle \
                else float("nan")
            return g, w_total, t_exact
        return _cached(("triangles", self, device), make)

    def build(self, *, world: int = 1,
              strategy: FrameStrategy = FrameStrategy.LOCAL_FRAME,
              device=None) -> BuiltInstance:
        from ..graphs.triangles import make_wedge_sample_fn, triangle_estimate
        from .stopping import WedgeClosureCondition
        device = resolve_device(device)
        g, w_total, t_exact = self._graph(device)
        pad = _pad_for(g.n, world, strategy)
        cond = WedgeClosureCondition(eps=self.eps_p, delta=self.delta,
                                     total_wedges=w_total)

        def estimate(data: PyTree, num: float) -> np.ndarray:
            return np.asarray([triangle_estimate(data, num, w_total)])

        return BuiltInstance(
            name=self.name,
            sample_fn=make_wedge_sample_fn(g, self.batch, pad_to=pad),
            check_fn=cond,
            template=torch.zeros((pad,), dtype=torch.int32, device=device),
            init_carry=None,
            samples_per_round=self.batch, true_len=g.n,
            eps=self.eps_p * w_total / 3.0, delta=self.delta,
            oracle=np.asarray([t_exact]), estimate=estimate,
            rounds_per_epoch=self.rounds_per_epoch,
            max_epochs=self.max_epochs)


@dataclasses.dataclass(frozen=True)
class ReachabilityInstance:
    """s–t reachability probability under edge percolation (a tiny graph,
    so that the exact-enumeration oracle stays feasible)."""

    name: str = "reachability"
    rows: int = 3
    cols: int = 3
    s: int = 0
    t: int = 8
    pi: float = 0.7               # per-edge survival probability
    eps: float = 0.05
    delta: float = 0.1
    batch: int = 64
    rounds_per_epoch: int = 2
    max_epochs: int = 4000
    compute_oracle: bool = True   # 2^m enumeration: off beyond ~20 edges

    def _graph(self, device):
        def make():
            from ..graphs import grid2d
            from ..graphs.reachability import reachability_exact
            g = grid2d(self.rows, self.cols, device=device)
            p_exact = reachability_exact(g, self.s, self.t, self.pi) \
                if self.compute_oracle else float("nan")
            return g, p_exact
        return _cached(("reachability", self, device), make)

    def build(self, *, world: int = 1,
              strategy: FrameStrategy = FrameStrategy.LOCAL_FRAME,
              device=None) -> BuiltInstance:
        from ..graphs.reachability import (frame_template,
                                           make_percolation_sample_fn)
        from .stopping import PercolationCondition, hoeffding_tau_needed
        device = resolve_device(device)
        g, p_exact = self._graph(device)
        pad = _pad_for(g.n, world, strategy)
        # ω analog: the static Hoeffding bound caps the sample count
        omega = int(np.ceil(float(hoeffding_tau_needed(self.eps, self.delta))))
        cond = PercolationCondition(eps=self.eps, delta=self.delta,
                                    max_samples=omega)

        def estimate(data: PyTree, num: float) -> np.ndarray:
            return np.asarray([float(data["s1"]) / max(num, 1.0)])

        return BuiltInstance(
            name=self.name,
            sample_fn=make_percolation_sample_fn(g, self.s, self.t, self.pi,
                                                 self.batch, pad_to=pad),
            check_fn=cond, template=frame_template(g, pad), init_carry=None,
            samples_per_round=self.batch, true_len=g.n,
            eps=self.eps, delta=self.delta,
            oracle=np.asarray([p_exact]), estimate=estimate,
            rounds_per_epoch=self.rounds_per_epoch,
            max_epochs=self.max_epochs)


@dataclasses.dataclass(frozen=True)
class WeightedSamplingInstance:
    """Weighted-mean estimation over alias-table draws (Hübschle-Schneider
    & Sanders).  Pareto(1.5) weights, quantized values in [scale/4, scale);
    the exact oracle is O(n) and always computed."""

    name: str = "wrs"
    n_items: int = 256
    weight_seed: int = 3
    rtol: float = 0.05            # relative half-width target on μ̂
    delta: float = 0.1
    batch: int = 128
    rounds_per_epoch: int = 2
    max_epochs: int = 4000
    # int32 moment sums stay exact while max_samples·(value_scale−1)² < 2³¹.
    max_samples: int = 1 << 19
    value_scale: int = 32

    def _setup(self, device):
        def make():
            from ..sampling.alias import build_alias_table, weighted_mean_exact
            rng = np.random.default_rng(self.weight_seed)
            w = rng.pareto(1.5, size=self.n_items) + 1e-3
            values_q = rng.integers(self.value_scale // 4, self.value_scale,
                                    size=self.n_items)
            table = build_alias_table(w, device=device)
            mu = weighted_mean_exact(w, values_q, self.value_scale)
            values = torch.from_numpy(values_q.astype(np.int32)).to(device)
            return table, values, mu
        return _cached(("wrs", self, device), make)

    def build(self, *, world: int = 1,
              strategy: FrameStrategy = FrameStrategy.LOCAL_FRAME,
              device=None) -> BuiltInstance:
        from ..sampling.alias import (make_weighted_sample_fn,
                                      weighted_frame_template)
        from .stopping import RelativeErrorCondition
        device = resolve_device(device)
        table, values, mu = self._setup(device)
        pad = _pad_for(self.n_items, world, strategy)
        cond = RelativeErrorCondition(rtol=self.rtol, delta=self.delta,
                                      scale=float(self.value_scale),
                                      max_samples=self.max_samples)
        scale = float(self.value_scale)

        def estimate(data: PyTree, num: float) -> np.ndarray:
            return np.asarray([float(data["s1"]) / (scale * max(num, 1.0))])

        return BuiltInstance(
            name=self.name,
            sample_fn=make_weighted_sample_fn(table, values, self.batch,
                                              pad_to=pad),
            check_fn=cond,
            template=weighted_frame_template(self.n_items, pad, device=device),
            init_carry=None, samples_per_round=self.batch,
            true_len=self.n_items,
            eps=2.0 * self.rtol * mu, delta=self.delta,
            oracle=np.asarray([mu]), estimate=estimate,
            rounds_per_epoch=self.rounds_per_epoch,
            max_epochs=self.max_epochs)


@dataclasses.dataclass(frozen=True)
class DiameterInstance:
    """Graph-diameter estimation via double-sweep BFS lower bounds, on a
    grid (``kind="grid"``) or an ER graph (``kind="er"``); assumes one
    connected component."""

    name: str = "diameter"
    kind: str = "grid"
    rows: int = 5
    cols: int = 5
    n_vertices: int = 64          # for kind="er"
    n_edges: int = 192
    graph_seed: int = 4
    gap: int = 0                  # certified |diam − estimate| tolerance
    batch: int = 8
    rounds_per_epoch: int = 2
    max_epochs: int = 4000
    max_samples: int = 4096
    compute_oracle: bool = True

    def _graph(self, device):
        def make():
            from ..graphs import erdos_renyi, grid2d
            from ..graphs.diameter import diameter_exact
            g = grid2d(self.rows, self.cols, device=device) \
                if self.kind == "grid" \
                else erdos_renyi(self.n_vertices, self.n_edges,
                                 seed=self.graph_seed, device=device)
            diam = float(diameter_exact(g)) if self.compute_oracle \
                else float("nan")
            return g, diam
        return _cached(("diameter", self, device), make)

    def build(self, *, world: int = 1,
              strategy: FrameStrategy = FrameStrategy.LOCAL_FRAME,
              device=None) -> BuiltInstance:
        from ..graphs.diameter import (diameter_estimate, frame_template,
                                       make_sweep_sample_fn)
        from .stopping import EccentricityGapCondition
        device = resolve_device(device)
        g, diam = self._graph(device)
        bins = g.n + 1
        pad = _pad_for(bins, world, strategy)
        cond = EccentricityGapCondition(gap=self.gap,
                                        max_samples=self.max_samples)

        def estimate(data: PyTree, num: float) -> np.ndarray:
            return np.asarray([diameter_estimate(data["ecc_hist"])])

        return BuiltInstance(
            name=self.name,
            sample_fn=make_sweep_sample_fn(g, self.batch, gap=self.gap,
                                           pad_to=pad),
            check_fn=cond, template=frame_template(g, pad), init_carry=None,
            samples_per_round=self.batch, true_len=bins,
            eps=self.gap + 0.5, delta=0.0,
            oracle=np.asarray([diam]), estimate=estimate,
            rounds_per_epoch=self.rounds_per_epoch,
            max_epochs=self.max_epochs)


@dataclasses.dataclass(frozen=True)
class GradVarianceInstance:
    """The mean per-example gradient norm of a fixed linear-regression
    iterate, stopping once its relative standard error is ≤ ``rtol``
    (:class:`~repro_torch.core.stopping.GradVarianceCondition`)."""

    name: str = "gradvar"
    n_examples: int = 256
    dim: int = 8
    data_seed: int = 5
    rtol: float = 0.05
    batch: int = 64
    rounds_per_epoch: int = 2
    max_epochs: int = 4000
    # int32 moment sums stay exact while max_samples·(value_scale−1)² < 2³¹.
    max_samples: int = 1 << 19
    value_scale: int = 32

    def _setup(self, device):
        def make():
            from ..optim.adaptive import quantized_grad_norms
            gq, mu = quantized_grad_norms(self.n_examples, self.dim,
                                          self.data_seed, self.value_scale)
            return torch.from_numpy(gq).to(device), mu
        return _cached(("gradvar", self, device), make)

    def build(self, *, world: int = 1,
              strategy: FrameStrategy = FrameStrategy.LOCAL_FRAME,
              device=None) -> BuiltInstance:
        from ..optim.adaptive import (gradnorm_frame_template,
                                      make_gradnorm_sample_fn)
        from .stopping import GradVarianceCondition
        device = resolve_device(device)
        gq, mu = self._setup(device)
        pad = _pad_for(self.n_examples, world, strategy)
        cond = GradVarianceCondition(rtol=self.rtol,
                                     max_samples=self.max_samples)
        scale = float(self.value_scale)

        def estimate(data: PyTree, num: float) -> np.ndarray:
            return np.asarray([float(data["s1"]) / (scale * max(num, 1.0))])

        # rel-SEM stopping is a standard-error target, not an (ε,δ) bound:
        # ε = 4·rtol·μ is the harness tolerance, as in the reference.
        return BuiltInstance(
            name=self.name,
            sample_fn=make_gradnorm_sample_fn(gq, self.batch, pad_to=pad),
            check_fn=cond,
            template=gradnorm_frame_template(self.n_examples, pad,
                                             device=device),
            init_carry=None, samples_per_round=self.batch,
            true_len=self.n_examples,
            eps=4.0 * self.rtol * mu, delta=0.0,
            oracle=np.asarray([mu]), estimate=estimate,
            rounds_per_epoch=self.rounds_per_epoch,
            max_epochs=self.max_epochs)


register_instance(KadabraInstance())
register_instance(TrianglesInstance())
register_instance(ReachabilityInstance())
register_instance(WeightedSamplingInstance())
register_instance(DiameterInstance())
register_instance(GradVarianceInstance())
