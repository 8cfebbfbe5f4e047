"""KADABRA (Borassi & Natale 2016) as the benchmark's cells run it, in plain
PyTorch, to be held against the port's answers query by query.

Preprocessing: components; from v0 = q mod n a full BFS, the farthest vertex
(ties to the least id), its eccentricity e; vd_upper = 2·max(e, 1) + 1 is
also the BFS level budget; ω = (c/ε²)·(⌊log₂(vd_upper − 2)⌋ + 1 + ln(1/δ))
with c = 0.5.

Sampling (one round, W workers of ``batch`` samples): worker w draws s
uniform over the vertices and t uniform over the others from its own
stream, a BFS from s gives dist and σ up to t's level, and the path is
walked back from t, each predecessor u of the current vertex chosen with
probability σ(u)/Σσ by the Gumbel-max trick on one (batch, max_degree)
block of uniforms a step for ``vd_upper`` steps.  The internal vertices of
the path add one to the worker's count of each; a pair in two components
adds nothing.  The streams and the order of the draws are the port's
(:mod:`.streams`), so the same seed gives the same samples.

Frames and stopping: LOCAL_FRAME samples an epoch (K rounds), then at each
epoch boundary adds the previous epoch's W frames to the total, checks, and
samples the next epoch unless the check stopped.  INDEXED_FRAME draws frame
m = epoch·W + w from its own stream and adds the frames one at a time in
index order, checking after each, and stops at the first stopping prefix.
The check is KADABRA's per-vertex bounds f, g ≤ ε at δ_L = δ_U = δ/(2n), or
τ ≥ ω, in float32 on the device, as the port states its rule.

``uniform`` puts the control in the program's place: each predecessor is
drawn uniformly (σ ignored: paths that are shortest but not uniform among
the shortest).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from .graph import INF, RefGraph
from .streams import frame_generators, worker_generators

_F32 = torch.float32


def omega(eps: float, delta: float, vd_upper: int, c: float = 0.5) -> float:
    vd = max(int(vd_upper), 4)
    return (c / eps ** 2) * (math.floor(math.log2(vd - 2)) + 1
                             + math.log(1.0 / delta))


def preprocess(rg: RefGraph, eps: float, delta: float, q: int) -> dict:
    dev = rg.device
    v0 = torch.tensor([q % rg.n], device=dev)
    dist0, _ = rg.bfs(v0, max_levels=rg.n)
    d = dist0[0].cpu().numpy().astype(np.int64)
    d[d == INF] = -1
    far = int(np.flatnonzero(d == d.max())[0])
    dist1, _ = rg.bfs(torch.tensor([far], device=dev), max_levels=rg.n)
    d1 = dist1[0].cpu().numpy().astype(np.int64)
    ecc = int(d1[d1 != INF].max())
    diam_ub = 2 * max(ecc, 1)
    return {"components": rg.components(), "vd_upper": diam_ub + 1,
            "diam_levels": diam_ub + 1,
            "omega": omega(eps, delta, diam_ub + 1)}


def vd_lower(rg: RefGraph) -> int:
    """A lower bound of the graph's vertex diameter: 1 + the eccentricity
    of the vertex farthest from the least vertex of the largest component
    (a shortest path of that many vertices exists)."""
    comps = torch.from_numpy(rg.components()).to(rg.device)
    largest = int(torch.bincount(comps, minlength=rg.n).argmax())
    dist, _ = rg.bfs(torch.tensor([largest], device=rg.device), max_levels=rg.n)
    d = torch.where(dist[0] == INF, -1, dist[0].long())
    far = int(torch.nonzero(d == d.max())[0, 0])
    dist, _ = rg.bfs(torch.tensor([far], device=rg.device), max_levels=rg.n)
    return int(torch.where(dist[0] == INF, 0, dist[0]).max()) + 1


def walk_back(rg: RefGraph, gens, s, t, dist, sigma, steps: int,
              uniform: bool = False) -> torch.Tensor:
    """The sampled paths' internal vertices, (L, steps), n where unused;
    lanes w·B … w·B+B−1 draw from ``gens[w]``."""
    n, dev, delta_max = rg.n, rg.device, rg.max_degree
    L = s.numel()
    B = L // len(gens)
    rows = torch.arange(L, device=dev)
    slot = torch.arange(delta_max, device=dev)
    reachable = dist[rows, t] != INF
    cur = t.clone()
    path = torch.full((L, steps), n, dtype=torch.int64, device=dev)
    for step in range(steps):
        done = (cur == s) | ~reachable
        first = rg.t_indptr[cur]
        count = rg.t_indptr[cur + 1] - first
        nbrs = torch.where(slot < count[:, None],
                           rg.t_indices[first[:, None] + slot], n)
        nb = nbrs.clamp(max=n - 1)
        before = (nbrs < n) & (dist.gather(1, nb) == dist[rows, cur][:, None] - 1)
        if uniform:
            weight = before.float()
        else:
            weight = torch.where(before, sigma.gather(1, nb), 0.0)
        u = torch.cat([torch.rand((B, delta_max), generator=gen, device=dev)
                       for gen in gens]).clamp_min(1e-12)
        gumbel = -torch.log(-torch.log(u))
        score = torch.where(weight > 0.0, torch.log(weight) + gumbel, -torch.inf)
        pick = nbrs.gather(1, score.argmax(dim=1, keepdim=True)).squeeze(1)
        nxt = torch.where(done, cur, pick)
        inside = ~done & (nxt != s) & (nxt != t)
        path[:, step] = torch.where(inside, nxt, n)
        cur = nxt
    return path


class _Sampler:
    def __init__(self, rg: RefGraph, pre: dict, batch: int, uniform: bool):
        self.rg, self.pre, self.batch, self.uniform = rg, pre, batch, uniform
        self.comps = torch.from_numpy(pre["components"]).to(rg.device)

    def round(self, gens) -> torch.Tensor:
        """One round for the workers of ``gens`` → their (W, n) counts."""
        rg, n, dev, B = self.rg, self.rg.n, self.rg.device, self.batch
        counts = []
        # workers in blocks, so that a block's BFS state stays small
        per = max(1, 1024 // B)
        for i in range(0, len(gens), per):
            block = gens[i:i + per]
            s = torch.stack([torch.randint(0, n, (B,), generator=g, device=dev)
                             for g in block])
            dt = torch.stack([torch.randint(0, n - 1, (B,), generator=g,
                                            device=dev) for g in block])
            s, t = s.reshape(-1), ((s + 1 + dt) % n).reshape(-1)
            dist, sigma = rg.bfs(s, t, max_levels=self.pre["diam_levels"])
            path = walk_back(rg, block, s, t, dist, sigma,
                             self.pre["vd_upper"], uniform=self.uniform)
            del dist, sigma
            path = torch.where((self.comps[s] == self.comps[t])[:, None], path, n)
            for w in range(len(block)):
                hits = path[w * B:(w + 1) * B].reshape(-1)
                counts.append(torch.bincount(hits, minlength=n + 1)[:n])
        return torch.stack(counts)

    def epoch(self, gens, rounds: int) -> torch.Tensor:
        total = None
        for _ in range(rounds):
            c = self.round(gens)
            total = c if total is None else total + c
        return total


def stops(counts: torch.Tensor, tau: int, eps: float, delta: float,
          omega_: float, n: int) -> bool:
    """KADABRA's check on the total counts after τ samples, in float32."""
    dev = counts.device
    tau_t = torch.tensor(tau, dtype=torch.int32, device=dev).to(_F32)
    btilde = counts.to(_F32) / torch.clamp(tau_t, min=1.0)
    dl = delta / (2.0 * n)
    log_term = -torch.log(torch.clamp(torch.tensor(dl, dtype=_F32, device=dev),
                                      min=1e-30))
    tau_c = torch.clamp(tau_t, min=1.0)
    r = omega_ / tau_c
    f = (log_term / tau_c) * ((1.0 / 3.0 - r) + torch.sqrt(
        (1.0 / 3.0 - r) ** 2 + 2.0 * btilde * omega_ / log_term))
    g = (log_term / tau_c) * ((1.0 / 3.0 + r) + torch.sqrt(
        (1.0 / 3.0 + r) ** 2 + 2.0 * btilde * omega_ / log_term))
    bounds = (torch.max(f) <= eps) & (torch.max(g) <= eps)
    return bool((tau_t > 0) & (bounds | (tau_t >= omega_)))


def query(rg: RefGraph, traffic: dict, q: int, uniform: bool = False) -> dict:
    """The reference's answer to query ``q`` of a traffic mix."""
    eps, delta = float(traffic["eps"]), float(traffic["delta"])
    W, B = int(traffic["world"]), int(traffic["batch"])
    K, cap = int(traffic["rounds_per_epoch"]), int(traffic["max_epochs"])
    strategy = traffic["strategy"]
    pre = preprocess(rg, eps, delta, q)
    sampler = _Sampler(rg, pre, B, uniform)
    dev, n = rg.device, rg.n
    total = torch.zeros(n, dtype=torch.int64, device=dev)
    tau, stop, stop_epoch, epoch = 0, False, 0, 1

    def check() -> bool:
        return stops(total, tau, eps, delta, pre["omega"], n)

    if strategy == "local":
        gens = worker_generators(q, W, dev)
        pending = sampler.epoch(gens, K)
        while not stop and epoch < cap:
            total = total + pending.sum(dim=0)
            tau += W * K * B
            stop = check()
            if not stop:
                pending = sampler.epoch(gens, K)
            epoch += 1
            stop_epoch = epoch if stop else stop_epoch
    elif strategy == "indexed":
        pending = sampler.epoch(frame_generators(q, 0, W, dev), K)
        while not stop and epoch < cap:
            for j in range(W):
                total = total + pending[j]
                tau += K * B
                if check():
                    stop, stop_epoch = True, epoch + 1
                    break
            if not stop:
                pending = sampler.epoch(frame_generators(q, epoch * W, W, dev), K)
            epoch += 1
    else:
        raise ValueError(f"the reference runs the local and indexed frame "
                         f"strategies, not {strategy!r}")
    counts = total.cpu().numpy()
    return {"btilde": counts.astype(np.float64) / max(float(tau), 1.0),
            "tau": tau, "stopped": stop, "epochs": epoch,
            "stop_epoch": stop_epoch, "omega": pre["omega"],
            "vd_upper": pre["vd_upper"], "diam_levels": pre["diam_levels"],
            "components": pre["components"]}
