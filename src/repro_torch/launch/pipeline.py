"""Pipeline parallelism (GPipe) over a process group.  Port of
:mod:`repro.launch.pipeline`.

``pipeline_forward`` runs a stack of L layers split into S stages, one
stage a rank of the group: stage s holds layers [s·L/S, (s+1)·L/S), and
micro-batch activations go stage to stage with ``dist.batch_isend_irecv``.
M ≥ S micro-batches run in M + S − 1 ticks (bubble (S−1)/(M+S−1)): at tick
t stage s runs micro-batch t − s when there is one.  At the end the last
stage's outputs reach every rank by a broadcast from it (the reference's
masked psum computes the same function).  Each micro-batch meets the same
layers in the same order as in a plain loop over the stack, so the result
is that loop's, bit for bit, where the layers are deterministic.

gloo carries the messages of ranks that share a card, and its
point-to-point calls take only host memory: ``core.distributed.
p2p_exchange`` stages such a CUDA tensor through the host and counts it
(``core.distributed.host_staged``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable

import torch
import torch.distributed as dist

from ..core import distributed
from ..core.distributed import p2p_exchange

_SEQUENCES = (list, tuple, torch.nn.ModuleList, torch.Tensor)


def _layer(stacked: Any, i: int) -> Any:
    """Layer i of a stack: item i of a sequence of per-layer params, or
    index i of every tensor leaf of a (nested dict) tree of stacked ones."""
    if isinstance(stacked, _SEQUENCES):
        return stacked[i]
    return {k: _layer(v, i) for k, v in stacked.items()}


def _n_layers(stacked: Any) -> int:
    if isinstance(stacked, _SEQUENCES):
        return len(stacked)
    return _n_layers(next(iter(stacked.values())))


def gpipe_ticks(S: int, M: int, L: int) -> int:
    """The ticks of the GPipe schedule of M micro-batches over S stages of
    an L-layer stack (M + S − 1); raises unless M ≥ S and S divides L."""
    if M < S:
        raise ValueError(f"pipeline_forward: {M} micro-batch(es) cannot fill "
                         f"{S} stages (need M ≥ S)")
    if L % S:
        raise ValueError(f"pipeline_forward: {L} layers do not split into "
                         f"{S} equal stages")
    return M + S - 1


def pipeline_forward(layer_fn: Callable, stacked_params: Any,
                     x_micro: torch.Tensor, group=None) -> torch.Tensor:
    """x through L layers split over the ranks of ``group`` (a
    ``WorkerGroup``, a process group, or None for the world).

    layer_fn(lp, x) -> x' — one layer, of the shape it takes.
    stacked_params — the L layers: a sequence of per-layer params, or a
    tree of tensors with leading dim L; stage s reads only its layers.
    x_micro — (M, mb, …) micro-batches, M ≥ the number of stages.
    Returns (M, mb, …) after all L layers, on every rank."""
    pg = getattr(group, "pg", group)
    S = dist.get_world_size(pg)
    sid = dist.get_rank(pg)
    M = x_micro.shape[0]
    L = _n_layers(stacked_params)
    ticks = gpipe_ticks(S, M, L)
    lo, hi = sid * L // S, (sid + 1) * L // S

    def run_stage(x):
        for i in range(lo, hi):
            x = layer_fn(_layer(stacked_params, i), x)
        return x

    outs = torch.zeros_like(x_micro)
    prev = None                      # what this stage ran at the last tick
    for t in range(ticks):
        m = t - sid                  # this tick's micro-batch here
        have = 0 <= m < M
        send = (prev, sid + 1) if prev is not None and sid < S - 1 else None
        recv = None
        if have and sid > 0:
            recv = (torch.empty_like(x_micro[0]), sid - 1)
        p2p_exchange(pg, send, recv)
        prev = None
        if have:
            x = x_micro[m] if sid == 0 else recv[0]
            prev = run_stage(x)
            if sid == S - 1:
                outs[m] = prev
    distributed.broadcast(outs, S - 1, pg)
    return outs


@functools.lru_cache(maxsize=None)
def _shell(cfg):
    from ..models import Model
    return Model(cfg, device="meta")


@dataclasses.dataclass(frozen=True)
class DecoderLayer:
    """One dense decoder layer of ``cfg`` (attention, then the SwiGLU
    block) as a picklable ``layer_fn``: lp has the layer's ``attn`` and
    ``mlp`` params (a ``Model``'s ``layers[i]``, or dicts), x (B, S, d)."""
    cfg: Any

    def __call__(self, lp, x):
        m = _shell(self.cfg)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        x = m._attn_seq(lp["attn"], x, positions, self.cfg.window)
        return m._mlp(lp["mlp"], x)


def pipeline_rank(group, layer_fn: Callable, stacked_params, x_micro,
                  stages: int = 0) -> Any:
    """``pipeline_forward`` as a rank entry (``spawn_workers``,
    ``RankPool``) over the first ``stages`` ranks of the world (default:
    all; every rank makes the group, the others return None) → the
    outputs as numpy, and the rank's count of messages staged through the
    host so far."""
    from ..core.distributed import process_group
    pg = group.pg
    if stages and stages != group.world:
        pg = process_group(range(stages))
        if pg is None:
            return None
    x_micro = torch.as_tensor(x_micro).to(group.device)
    out = pipeline_forward(layer_fn, stacked_params, x_micro, pg)
    if out.dtype == torch.bfloat16:      # numpy has no bf16; f32 holds it exactly
        out = out.float()
    return out.cpu().numpy(), distributed.host_staged
