"""Gradient compression for slow links.  Port of
:mod:`repro.optim.compress`.

int8 per-tensor quantization with stochastic rounding and **error
feedback**: the residual of each quantization step is carried and added to
the next step's gradient, which makes the compression unbiased in the
limit (the EF-SGD construction).

:func:`compressed_psum` reduces over a worker group
(:class:`~repro_torch.core.distributed.WorkerGroup`): the per-tensor scale
is max-combined with one MAX all-reduce of a scalar, so every rank
quantizes on the same grid, and the int8 payload is summed as int32 with
one SUM all-reduce (512 ranks × 127 < 2³¹, no overflow).  Plain PyTorch,
as the reference computes it outside any Pallas kernel.  The noise comes
from a ``torch.Generator``, consumed leaf by leaf in the tree's order (the
reference splits its key per leaf), so the port's bits are not the
reference's; the shared scale is, on the same gradients.
"""

from __future__ import annotations

from typing import Any, Tuple

import torch
import torch.distributed as dist

PyTree = Any

_MIN_MAX = 1e-12


def _map(fn, *trees):
    """``fn`` over the tensor leaves of trees of dicts, lists and tuples,
    in order (sorted keys for dicts)."""
    t = trees[0]
    if isinstance(t, dict):
        return {k: _map(fn, *(x[k] for x in trees)) for k in sorted(t)}
    if isinstance(t, (list, tuple)):
        return type(t)(_map(fn, *xs) for xs in zip(*trees))
    return fn(*trees)


def _noise(x: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """Uniform in [−0.5, 0.5), as the reference's ``uniform(minval=-0.5,
    maxval=0.5)``."""
    return torch.rand(x.shape, generator=generator, dtype=torch.float32,
                      device=x.device) - 0.5


def _scale_of(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp_min(amax, _MIN_MAX) / 127.0


def quantize_int8(x: torch.Tensor, generator: torch.Generator
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tensor scale, stochastic rounding.  Returns (q int8, scale f32)."""
    xf = x.float()
    scale = _scale_of(xf.abs().max())
    q = torch.clamp(torch.round(xf / scale + _noise(x, generator)), -127, 127)
    return q.to(torch.int8), scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def shared_scale(gc: torch.Tensor, group) -> torch.Tensor:
    """The scale every rank of ``group`` quantizes ``gc`` with: the largest
    |gc| over the ranks (one MAX all-reduce of a scalar), over 127."""
    amax = torch.clamp_min(gc.abs().max(), _MIN_MAX).reshape(1)
    dist.all_reduce(amax, op=dist.ReduceOp.MAX, group=group.pg)
    return amax[0] / 127.0


def compressed_psum(grads: PyTree, ef: PyTree, generator: torch.Generator,
                    group) -> Tuple[PyTree, PyTree]:
    """The sum over ``group`` of ``grads`` with an int8 payload and error
    feedback ``ef`` (a tree like ``grads``, f32).  Returns (f32 grads ≈ the
    mean over the ranks, the new error feedback)."""
    world = group.world
    means, new_ef = [], []

    def leaf(g, e):
        gc = g.float() + e
        scale = shared_scale(gc, group)
        q = torch.clamp(torch.round(gc / scale + _noise(g, generator)),
                        -127, 127)
        new_ef.append(gc - q * scale)                  # residual feedback
        summed = q.to(torch.int32)
        dist.all_reduce(summed, op=dist.ReduceOp.SUM, group=group.pg)
        means.append(summed.float() * scale / world)
        return None

    _map(leaf, grads, ef)
    it_mean, it_ef = iter(means), iter(new_ef)
    return (_map(lambda g: next(it_mean), grads),
            _map(lambda g: next(it_ef), grads))


def compress_on_rank(group, ids, rows=None, shape=None, seed: int = 0,
                     steps: int = 1) -> dict:
    """A check entry for a :class:`~repro_torch.launch.spawn.RankPool`:
    ``steps`` calls of :func:`compressed_psum` over the lease ``ids``
    (whose groups every rank of the pool made first), the rank at lease
    position p reducing row p of each leaf of ``rows`` (a tree of numpy
    (W, ...) arrays), or, without ``rows``, one standard normal leaf of
    ``shape`` drawn on its device.

    Returns, per rank: each step's shared scales (one a leaf, in the
    tree's order) and seconds, the first step's largest |mean − exact
    mean| and |new ef| over the scale of each leaf (the exact mean a float
    all-reduce), the largest |mean over the steps − exact mean|, and the
    first step's collectives (``record_collectives(detail=True)``); with
    ``rows``, the first step's mean and new error feedback and the mean
    over the steps, as numpy trees."""
    import time

    from ..core import distributed
    from ..core.epoch import make_generator
    lease = distributed.lease_group(ids)
    p, dev = lease.rank, lease.device
    if rows is not None:
        g = _map(lambda r: torch.from_numpy(r[p].copy()).to(dev), rows)
    else:
        g = torch.randn(shape, generator=make_generator(dev, seed, 0, p),
                        device=dev)
    gen = make_generator(dev, seed, 1, p)

    def exact_mean(x):
        y = x.float().clone()
        dist.all_reduce(y, op=dist.ReduceOp.SUM, group=lease.pg)
        return y / lease.world

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    def flat(tree):
        out = []
        _map(out.append, tree)
        return out

    exact = _map(exact_mean, g)
    ef = _map(lambda x: torch.zeros_like(x, dtype=torch.float32), g)
    acc = _map(torch.zeros_like, ef)
    out = {"scale": [], "step_s": []}
    for t in range(steps):
        scales = flat(_map(lambda x, e: shared_scale(x.float() + e, lease),
                           g, ef))
        sync()
        t0 = time.perf_counter()
        with distributed.record_collectives(detail=True) as calls:
            mean, ef = compressed_psum(g, ef, gen, lease)
        sync()
        out["step_s"].append(time.perf_counter() - t0)
        out["scale"].append([s.cpu().numpy() for s in scales])
        if t == 0:
            out["calls"] = [(*c[:5], str(c[5])) for c in calls]
            out["mean_err_over_scale"] = [
                float((m - x).abs().max() / s) for m, x, s in
                zip(flat(mean), flat(exact), scales)]
            out["ef_over_scale"] = [float(e.abs().max() / s)
                                    for e, s in zip(flat(ef), scales)]
            if rows is not None:
                out["mean"] = _map(lambda x: x.cpu().numpy(), mean)
                out["ef"] = _map(lambda x: x.cpu().numpy(), ef)
        acc = _map(torch.add, acc, mean)
    avg = _map(lambda a: a / steps, acc)
    out["mean_over_steps_err"] = max(float((a - x).abs().max())
                                     for a, x in zip(flat(avg), flat(exact)))
    if rows is not None:
        out["mean_over_steps"] = _map(lambda x: x.cpu().numpy(), avg)
    return out
