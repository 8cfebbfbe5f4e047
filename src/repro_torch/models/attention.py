"""GQA attention: the mask and one-token decode against a KV cache.

Port of :mod:`repro.models.attention`.  The sequence path (prefill and
``train_loss``) calls the hand-written ``flash_attention`` kernel through
``kernels.ops.flash_attention`` at every S; the reference's ``attn_full``
and ``attn_chunked`` are that kernel's oracles and are not carried over, nor
is their mask helper ``_causal_mask`` (the kernel and its plain version
apply the same mask themselves).
"""

from __future__ import annotations

import math

import torch

NEG = -1e30


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
    qg = q.reshape(B, KV, G, hd)
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
