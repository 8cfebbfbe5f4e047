"""KADABRA (Borassi & Natale 2016) on the epoch engine — the paper's case
study (§2.3, §4).  Port of :mod:`repro.graphs.kadabra`.

1. ``preprocess`` — connected components, a vertex-diameter upper bound by
   double-sweep BFS, and ω from the VC bound.
2. adaptive sampling with any :class:`FrameStrategy`: one round of SAMPLE()
   for W workers is ONE batched BFS of W·batch lanes.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import numpy as np
import torch

from ..core.adaptive import AdaptiveResult, result_from_state
from ..core.epoch import EpochConfig
from ..core.frames import FrameStrategy, StateFrame, shard_frame_pad
from ..core.stopping import KadabraCondition, kadabra_omega
from ..core.substrate import run_on_substrate
from ..device import resolve_device, to_host
from .bfs import INF, bfs_sssp, connected_components, eccentricity, sample_path
from .csr import Graph


@dataclasses.dataclass(frozen=True)
class KadabraParams:
    eps: float = 0.05
    delta: float = 0.1
    batch: int = 16            # samples per worker per sampling round
    rounds_per_epoch: int = 4  # paper's N (App. C.2) in units of rounds
    max_epochs: int = 4096
    xi: float = 0.0            # App. C.3 coordinator-cadence heuristic
    c_omega: float = 0.5


@dataclasses.dataclass(frozen=True)
class Preprocessed:
    omega: float
    vd_upper: int              # vertex-diameter upper bound
    components: torch.Tensor   # (n,) int32 labels
    diam_levels: int           # BFS level budget


def preprocess(g: Graph, eps: float, delta: float, c_omega: float = 0.5,
               seed: int = 0, device=None) -> Preprocessed:
    device = resolve_device(device)
    g = g.to(device)
    comps = connected_components(g, device=device)
    max_levels = g.n  # worst case; each BFS ends when its frontier empties
    v0 = torch.tensor([seed % g.n], device=device)
    dist0, _ = bfs_sssp(g, v0, None, max_levels=max_levels, early_exit=False,
                        device=device)
    d = torch.where(dist0[0] == INF, -1, dist0[0])
    # the farthest vertex, ties to the lowest index (as jnp.argmax)
    idx = torch.arange(g.n, device=device)
    far = torch.where(d == d.max(), idx, g.n).min()
    ecc = int(to_host(eccentricity(g, far[None], max_levels=max_levels,
                                   device=device)[0]))
    diam_ub = 2 * max(ecc, 1)          # diam ≤ 2·ecc(u) for unweighted graphs
    vd_upper = diam_ub + 1             # vertices on the longest shortest path
    omega = kadabra_omega(eps, delta, vd_upper, c=c_omega)
    return Preprocessed(omega=float(omega), vd_upper=vd_upper,
                        components=comps, diam_levels=diam_ub + 1)


def make_sample_fn(g: Graph, pre: Preprocessed, batch: int, *,
                   pad_to: Optional[int] = None):
    """Build SAMPLE(): ``sample_fn(gens, carry)`` draws ``batch`` paths for
    each of the ``len(gens)`` workers in one BFS of W·batch lanes.

    Frame data: per-worker, per-vertex counts Σ x_i(v), (W, pad_to or n)
    int32.  Worker w's s, t and path noise come from ``gens[w]`` only, in
    a fixed order (s, t, then the path steps).
    """
    n, dev = g.n, g.device
    n_pad = pad_to or n

    def sample_fn(gens, carry):
        W = len(gens)
        s = torch.stack([torch.randint(0, n, (batch,), generator=gen, device=dev)
                         for gen in gens])
        # t uniform over vertices ≠ s (rejection-free)
        dt = torch.stack([torch.randint(0, n - 1, (batch,), generator=gen,
                                        device=dev) for gen in gens])
        s, t = s.reshape(-1), ((s + 1 + dt) % n).reshape(-1)
        dist, sigma = bfs_sssp(g, s, t, max_levels=pre.diam_levels,
                               early_exit=True, device=dev)
        path = sample_path(g, gens, s, t, dist, sigma, max_len=pre.vd_upper)
        # disconnected pair ⇒ x_i ≡ 0 (the estimator's term)
        same_cc = pre.components[s] == pre.components[t]
        path = torch.where(same_cc[:, None], path, n)
        # Σ x_i(v) per worker; slot n of each row collects the sentinels
        worker = torch.arange(W, device=dev).repeat_interleave(batch)
        flat = (worker[:, None] * (n + 1) + path).reshape(-1)
        counts = torch.zeros(W * (n + 1), dtype=torch.int32, device=dev)
        counts.index_add_(0, flat, torch.ones_like(flat, dtype=torch.int32))
        counts = counts.view(W, n + 1)[:, :n]
        counts = torch.nn.functional.pad(counts, (0, n_pad - n)).contiguous()
        num = torch.full((W,), batch, dtype=torch.int32, device=dev)
        return StateFrame(num=num, data=counts), carry

    return sample_fn


def frame_template(g: Graph, pad_to: Optional[int] = None) -> torch.Tensor:
    return torch.zeros((pad_to or g.n,), dtype=torch.int32, device=g.device)


def run_kadabra(g: Graph, params: KadabraParams, *,
                strategy: FrameStrategy = FrameStrategy.LOCAL_FRAME,
                world: int = 1, seed: int = 0,
                pre: Optional[Preprocessed] = None,
                device=None) -> Tuple[np.ndarray, AdaptiveResult, Preprocessed]:
    """End-to-end KADABRA with ``world`` virtual workers on ``device``
    (``None`` → the CUDA card).

    Returns (b̃ estimates (n,) float64, the run's AdaptiveResult, the
    Preprocessed) — the reference returns the raw EpochState in the middle;
    here it is ``result.state``.
    """
    device = resolve_device(device)
    g = g.to(device)
    pre = pre or preprocess(g, params.eps, params.delta, params.c_omega, seed,
                            device=device)
    shared = strategy == FrameStrategy.SHARED_FRAME
    pad = shard_frame_pad(g.n, world) if shared else g.n
    sample_fn = make_sample_fn(g, pre, params.batch, pad_to=pad)
    # the padded tail (zeros) never blocks stopping: f, g at b̃ = 0 are the
    # least values of the bounds.
    cond = KadabraCondition(eps=params.eps, delta=params.delta,
                            omega=pre.omega, n_vertices=g.n)
    cfg = EpochConfig(strategy=strategy,
                      rounds_per_epoch=params.rounds_per_epoch,
                      max_epochs=params.max_epochs, xi=params.xi)
    st = run_on_substrate(sample_fn, cond, frame_template(g, pad), None, seed,
                          world, cfg)
    res = result_from_state(st, strategy=strategy, world=world)
    btilde = res.data[: g.n].astype(np.float64) / max(float(res.num), 1.0)
    return btilde, res, pre
