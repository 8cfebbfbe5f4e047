"""GQA attention: the mask and one-token decode against a KV cache.

Port of :mod:`repro.models.attention`.  The sequence path (prefill and
``train_loss``) calls the hand-written ``flash_attention`` kernel through
``kernels.ops.flash_attention`` at every S; the reference's ``attn_full``
and ``attn_chunked`` are that kernel's oracles and are not carried over, nor
is their mask helper ``_causal_mask`` (the kernel and its plain version
apply the same mask themselves).

On a mesh, :func:`flash_attention` runs the kernel on each rank's local
batch rows and heads (``local_map``, :func:`local_heads`): the kernel's
wrapper sees plain local tensors, never a DTensor.
"""

from __future__ import annotations

import math

import torch

from ..kernels import ops
from .layers import shard_range

NEG = -1e30


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0) -> torch.Tensor:
    """``ops.flash_attention`` (q (B, H, S, hd), k/v (B, KV, S, hd)); on
    DTensors, the kernel on each rank's shard (:func:`_local_flash`)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return _local_flash(q, k, v, window)
    return ops.flash_attention(q, k, v, window=window)


def _whole_heads(q: torch.Tensor) -> torch.Tensor:
    """q (B, H, hd) with its heads whole on every rank, so that the
    (B, KV, G, hd) view and the products that fold (B, KV) into one batch
    dim never split a sharded dim (DTensor refuses that view); a plain
    tensor as it is.  One small all-gather a layer a decode step."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(q, DTensor):
        return q
    pl = tuple(Replicate() if p in (Shard(1), Shard(2)) else p
               for p in q.placements)
    return q.redistribute(q.device_mesh, pl) if pl != tuple(q.placements) else q


def _local_flash(q, k, v, window: int):
    """Causal attention on DTensors (B, H, S, hd), the kernel on each
    rank's batch rows and heads (:func:`local_heads`)."""
    return local_heads(
        lambda ql, kl, vl: ops.flash_attention(ql, kl, vl, window=window),
        q, k, v, 1)


def local_heads(fn, q, k, v, head: int):
    """``fn(q, k, v)`` on DTensors, each rank over its local batch rows
    (dim 0) and heads (dim ``head``), ``fn`` getting plain local tensors.
    q keeps a batch or head sharding and is replicated on every other mesh
    dim (a sequence-sharded or partial q is gathered first); k and v take
    q's batch sharding and keep their head sharding where q's heads are
    sharded on the same mesh dim.  Where the fallback replicates k/v while
    q's heads are sharded (danube-reduced's 2 kv heads on a 4-way axis,
    qwen3-moe's 4 on 16, recurrentgemma's 1), the local call slices the kv
    heads its q heads read: q head h reads kv head h // (H/KV), so the
    local GQA groups stay whole.  A rank whose heads straddle two groups
    raises (:func:`_kv_block`).

    Under autograd the narrowed k/v's gradients differ by rank: each rank
    holds the part its q heads give.  On each mesh dim where q's heads
    are split and k/v replicated, their gradients are therefore partial
    sums (``in_grad_placements``), which the backward of the redistribution
    above reduces over that dim; labelling them replicated would keep one
    rank's part and drop the others' with no error."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    q_pl = tuple(p if p in (Shard(0), Shard(head)) else Replicate()
                 for p in q.placements)
    kv_pl = tuple(Shard(0) if qp == Shard(0) else
                  (Shard(head) if qp == Shard(head) and kp == Shard(head)
                   else Replicate())
                  for qp, kp in zip(q_pl, k.placements))
    q = q.redistribute(mesh, q_pl)
    k = k.redistribute(mesh, kv_pl)
    v = v.redistribute(mesh, kv_pl)
    first, n = shard_range(mesh, q_pl, head, q.shape[head])   # its q heads
    lo, count = _kv_block(q.shape[head], k.shape[head], first, n)
    kv_first, kv_n = shard_range(mesh, kv_pl, head, k.shape[head])
    lo -= kv_first                  # the kv heads it reads, in its local k/v
    whole = (lo, count) == (0, kv_n)

    def local(ql, kl, vl):
        if not whole:
            kl, vl = kl.narrow(head, lo, count), vl.narrow(head, lo, count)
        return fn(ql, kl, vl)

    kv_grad = tuple(Partial() if qp == Shard(head) and kp == Replicate()
                    else kp for qp, kp in zip(q_pl, kv_pl))
    return local_map(local, out_placements=list(q_pl),
                     in_placements=(q_pl, kv_pl, kv_pl),
                     in_grad_placements=(q_pl, kv_grad, kv_grad),
                     device_mesh=mesh)(q, k, v)


def _kv_block(H: int, KV: int, first: int, n: int) -> tuple:
    """(first kv head, count) that q heads [first, first + n) of H read,
    q head h reading kv head h // (H/KV).  The block must hold whole GQA
    groups or lie inside one (the kernel gives every local q head the same
    group size); else ValueError."""
    G = H // KV
    if n % G and G % n:
        raise ValueError(
            f"flash_attention on a mesh: {n} local q heads of {H} straddle "
            f"the GQA groups of {G} heads on {KV} kv heads; shard the heads "
            f"so that each rank holds whole groups or part of one")
    return first // G, max(n // G, 1)


def attn_decode(q: torch.Tensor, k_cache: torch.Tensor, v_cache: torch.Tensor,
                k_pos: torch.Tensor, pos: torch.Tensor, *,
                window: int = 0) -> torch.Tensor:
    """One-token GQA attention against a cache.

    q: (B, H, hd); k_cache/v_cache: (B, Sc, KV, hd); ``k_pos``: (B, Sc)
    absolute position held in each slot (−1 ⇒ empty); ``pos``: (B,) current
    position.  A ring-buffered cache passes its slot → position map in
    ``k_pos``, so the mask does not depend on the layout.
    """
    B, H, hd = q.shape
    KV = k_cache.shape[2]
    G = H // KV
    qg = _whole_heads(q).reshape(B, KV, G, hd)
    s = torch.einsum("bkgh,bskh->bkgs", qg.float(), k_cache.float()) \
        / math.sqrt(hd)
    valid = (k_pos >= 0) & (k_pos <= pos[:, None])
    if window > 0:
        valid &= k_pos > (pos[:, None] - window)
    s = torch.where(valid[:, None, None, :], s, NEG)
    m = torch.amax(s, dim=-1, keepdim=True)
    p = torch.exp(s - m)
    l = torch.sum(p, dim=-1, keepdim=True)
    out = torch.einsum("bkgs,bskh->bkgh",
                       (p / torch.clamp(l, min=1e-30)).to(q.dtype), v_cache)
    return out.reshape(B, H, hd)
