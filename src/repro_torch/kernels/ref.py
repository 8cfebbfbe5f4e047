"""Plain PyTorch versions of the port's kernels.

They are what a CPU tensor runs (the tests), and what ``chip_smoke.py``
holds each CUDA kernel against on the card.  Each matches the function of
the same name in :mod:`repro.kernels.ref`.
"""

from __future__ import annotations

import math

import torch


def frame_accum_ref(frames: torch.Tensor) -> torch.Tensor:
    """(W, n) → (n,): the sum over workers, accumulated in f32 for float
    frames and in int32 for integer frames, cast back to the input type."""
    acc = torch.float32 if frames.dtype.is_floating_point else torch.int32
    return torch.sum(frames.to(acc), dim=0, dtype=acc).to(frames.dtype)


def bfs_frontier_ref(src: torch.Tensor, dst: torch.Tensor, sigma: torch.Tensor,
                     dist: torch.Tensor, level: int) -> torch.Tensor:
    """One BFS level for B lanes, COO form:
    ``agg[b, v] = Σ_{arcs u→v} σ[b, u]·[dist[b, u] == level]``.

    src, dst: (m,) arcs; sigma: (B, n) f32; dist: (B, n) int32 → (B, n) f32.
    """
    src = src.long()
    contrib = torch.where(dist[:, src] == level, sigma.float()[:, src], 0.0)
    agg = torch.zeros(sigma.shape, dtype=torch.float32, device=sigma.device)
    return agg.index_add_(1, dst.long(), contrib)


def frontier_pack_ref(sigma: torch.Tensor, dist: torch.Tensor,
                      level: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The frontier of one BFS level as the ``bfs_frontier`` kernel packs it.

    ``front[u, g]`` holds lane 32·g + i's ``dist == level`` in bit i (int32,
    G = ⌈B/32⌉; lanes past B are 0), and ``sigp[u, g, r]`` the σ of the
    r-th set bit of that word; the slots past the word's popcount are 0
    here and unwritten by the kernel.  sigma (B, n) f32, dist (B, n) int32
    → front (n, G) int32, sigp (n, G, 32) f32.
    """
    B, n = sigma.shape
    G = (B + 31) // 32
    on = torch.zeros((G * 32, n), dtype=torch.bool, device=sigma.device)
    on[:B] = dist == level
    sig = torch.zeros((G * 32, n), dtype=torch.float32, device=sigma.device)
    sig[:B] = sigma
    on = on.t().reshape(n, G, 32)
    sig = sig.t().reshape(n, G, 32)
    bits = torch.arange(32, dtype=torch.int64, device=sigma.device)
    words = (on.long() << bits).sum(-1)                  # [0, 2^32)
    front = torch.where(words >= 2 ** 31, words - 2 ** 32, words).to(torch.int32)
    rank = torch.where(on, on.long().cumsum(-1) - 1, 32)  # unset → a spare slot
    sigp = torch.zeros((n, G, 33), dtype=torch.float32, device=sigma.device)
    sigp.scatter_(-1, rank, torch.where(on, sig, 0.0))
    return front, sigp[..., :32].contiguous()


def alias_draw_ref(prob: torch.Tensor, alias: torch.Tensor, u1: torch.Tensor,
                   u2: torch.Tensor) -> torch.Tensor:
    """Batched alias-table draw: keep bucket ``min(⌊u₁·n⌋, n−1)`` if
    u₂ < prob[bucket], else take alias[bucket].  The product is one f32
    multiply, truncated toward zero, as the reference's
    ``(u1 * n).astype(int32)``; the lower clamp at 0 only guards the gathers
    against uniforms outside [0, 1).

    prob (n,) f32, alias (n,) int32, u1/u2 (b,) f32 → idx (b,) int32.
    """
    n = prob.shape[0]
    bucket = (u1.float() * n).to(torch.int32).clamp(0, n - 1).long()
    return torch.where(u2 < prob[bucket], bucket, alias[bucket].long()
                       ).to(torch.int32)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0,
                        block_elems: int = 1 << 26) -> torch.Tensor:
    """Causal GQA attention with materialised f32 scores: q (B, H, S, hd),
    k and v (B, KV, S, hd) → (B, H, S, hd) in q's dtype.  Key k is
    admissible for query q when k ≤ q and, with a window, k > q − window.

    Computed in blocks of query rows, each against the keys its rows can
    admit, so that a block's (B, KV, G, rows, keys) scores hold at most
    ``block_elems`` values (256 MB in f32); a masked key adds an exact 0 to
    a row's softmax, so the blocks give the same function as one block."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    kf, vf = k.float(), v.float()
    rows = max(1, min(S, block_elems // max(1, B * H * S)))
    out = torch.empty((B, KV, G, S, hd), dtype=torch.float32, device=q.device)
    for q0 in range(0, S, rows):
        q1 = min(S, q0 + rows)
        k0 = max(0, q0 - window + 1) if window > 0 else 0
        s = torch.einsum("bkgqh,bksh->bkgqs", qg[:, :, :, q0:q1],
                         kf[:, :, k0:q1]) / math.sqrt(hd)
        qpos = torch.arange(q0, q1, device=q.device)[:, None]
        kpos = torch.arange(k0, q1, device=q.device)[None, :]
        mask = kpos <= qpos
        if window > 0:
            mask &= kpos > qpos - window
        p = torch.softmax(torch.where(mask, s, -1e30), dim=-1)
        out[:, :, :, q0:q1] = torch.einsum("bkgqs,bksh->bkgqh", p,
                                           vf[:, :, k0:q1])
    return out.reshape(B, H, S, hd).to(q.dtype)


def _fma_f32(a: torch.Tensor, h: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a·h + b on f32 tensors rounded once, as a fused multiply-add: the
    product is exact in f64 (24 + 24 bits), the f64 sum is rounded to odd
    (TwoSum gives its rounding error; an inexact sum with an even last bit
    moves one ulp toward the exact value), and rounding a round-to-odd
    result with 29 spare bits to f32 is the correctly rounded result."""
    x = a.double() * h.double()
    b = b.double()
    s = x + b
    bv = s - x
    err = (x - (s - bv)) + (b - bv)
    fix = (err != 0) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    return torch.where(fix, torch.nextafter(s, toward), s).float()


def _fma_scan(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t−1} + b_t along dim 1, h_{−1} = 0, in f32, step by
    step with one rounding a step (an FMA)."""
    a, b = a.float(), b.float()
    h = torch.zeros_like(a[:, 0])
    out = torch.empty_like(a)
    for t in range(a.shape[1]):
        h = _fma_f32(a[:, t], h, b[:, t])
        out[:, t] = h
    return out


def rglru_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t−1} + b_t along dim 1 of (B, S, W), h_{−1} = 0, in
    f32, step by step with one rounding a step (an FMA): the reference's
    Pallas body as XLA compiles it.  (The reference's ``rglru_scan_ref`` is
    an associative scan of the same recurrence, rounding in another order.)"""
    return _fma_scan(a, b)


def ssm_scan_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The Mamba recurrence h_t = a_t ⊙ h_{t−1} + b_t along dim 1 of
    (B, S, D, N), h_{−1} = 0, in f32, one FMA a step: the reference's Pallas
    ``ssm_scan`` body as XLA compiles it.  (The reference's ``ssm_scan_ref``
    is its associative ``linear_scan``, rounding in another order.)"""
    return _fma_scan(a, b)
