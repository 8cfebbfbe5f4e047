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


def _admissible(q0: int, q1: int, k0: int, k1: int, window: int,
                device) -> torch.Tensor:
    """(q1 − q0, k1 − k0) bool: key k is admissible for query q when k ≤ q
    and, with a window, k > q − window."""
    qpos = torch.arange(q0, q1, device=device)[:, None]
    kpos = torch.arange(k0, k1, device=device)[None, :]
    mask = kpos <= qpos
    if window > 0:
        mask &= kpos > qpos - window
    return mask


def _query_blocks(B: int, H: int, S: int, window: int, block_elems: int):
    """(q0, q1, k0) of each block of query rows: rows [q0, q1) see at most
    the keys [k0, q1)."""
    rows = max(1, min(S, block_elems // max(1, B * H * S)))
    for q0 in range(0, S, rows):
        q1 = min(S, q0 + rows)
        yield q0, q1, max(0, q0 - window + 1) if window > 0 else 0


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                        window: int = 0, block_elems: int = 1 << 26,
                        return_lse: bool = False):
    """Causal GQA attention with materialised f32 scores: q (B, H, S, hd),
    k and v (B, KV, S, hd) → (B, H, S, hd) in q's dtype.  Key k is
    admissible for query q when k ≤ q and, with a window, k > q − window.
    With ``return_lse`` → (out, lse), lse (B, H, S) f32 the natural
    logsumexp of each row's scaled scores over its admissible keys (what
    the backward rebuilds the probabilities from).

    Computed in blocks of query rows, each against the keys its rows can
    admit, so that a block's (B, KV, G, rows, keys) scores hold at most
    ``block_elems`` values (256 MB in f32); a masked key adds an exact 0 to
    a row's softmax, so the blocks give the same function as one block."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    qg = q.reshape(B, KV, G, S, hd).float()
    kf, vf = k.float(), v.float()
    out = torch.empty((B, KV, G, S, hd), dtype=torch.float32, device=q.device)
    lse = torch.empty((B, KV, G, S), dtype=torch.float32, device=q.device)
    for q0, q1, k0 in _query_blocks(B, H, S, window, block_elems):
        s = torch.einsum("bkgqh,bksh->bkgqs", qg[:, :, :, q0:q1],
                         kf[:, :, k0:q1]) / math.sqrt(hd)
        s = torch.where(_admissible(q0, q1, k0, q1, window, q.device), s, -1e30)
        p = torch.softmax(s, dim=-1)
        if return_lse:
            lse[:, :, :, q0:q1] = torch.logsumexp(s, dim=-1)
        out[:, :, :, q0:q1] = torch.einsum("bkgqs,bksh->bkgqh", p,
                                           vf[:, :, k0:q1])
    out = out.reshape(B, H, S, hd).to(q.dtype)
    return (out, lse.reshape(B, H, S)) if return_lse else out


def flash_attention_bwd_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                            o: torch.Tensor, lse: torch.Tensor,
                            do: torch.Tensor, *, window: int = 0,
                            block_elems: int = 1 << 26,
                            magnitude: bool = False):
    """The gradients of :func:`flash_attention_ref` → (dq, dk, dv) in the
    dtypes of q, k and v.  o is the forward's output, lse its row
    logsumexp (B, H, S) f32 and do the output's gradient.  In f32, with
    D = rowsum(dO ∘ O), P = exp(S·scale − lse) (0 where masked),
    dP = dO·Vᵀ and dS = P ∘ (dP − D):

        dV = Pᵀ·dO,   dK = dSᵀ·Q·scale,   dQ = dS·K·scale,

    dK and dV summed over each GQA group's query heads.  In the forward's
    blocks of query rows.  With ``magnitude``, the same sums over the
    terms' absolute values (|dO|, |V|, |O|, |Q|, |K| and dS = P ∘ (dP +
    D)): the size of what each sum adds, which bounds its rounding."""
    B, H, S, hd = q.shape
    KV = k.shape[1]
    G = H // KV
    scale = 1.0 / math.sqrt(hd)
    f = torch.abs if magnitude else (lambda t: t)
    qg = q.reshape(B, KV, G, S, hd).float()
    dog = f(do.reshape(B, KV, G, S, hd).float())
    lg = lse.reshape(B, KV, G, S).float()
    D = f(dog * o.reshape(B, KV, G, S, hd).float()).sum(-1)
    kf, vf = k.float(), f(v.float())
    dq = torch.empty((B, KV, G, S, hd), dtype=torch.float32, device=q.device)
    dk = torch.zeros((B, KV, S, hd), dtype=torch.float32, device=q.device)
    dv = torch.zeros((B, KV, S, hd), dtype=torch.float32, device=q.device)
    for q0, q1, k0 in _query_blocks(B, H, S, window, block_elems):
        s = torch.einsum("bkgqh,bksh->bkgqs", qg[:, :, :, q0:q1],
                         kf[:, :, k0:q1]) * scale
        mask = _admissible(q0, q1, k0, q1, window, q.device)
        p = torch.where(mask, torch.exp(s - lg[:, :, :, q0:q1, None]), 0.0)
        dp = torch.einsum("bkgqh,bksh->bkgqs", dog[:, :, :, q0:q1],
                          vf[:, :, k0:q1])
        ds = p * (dp + D[:, :, :, q0:q1, None] if magnitude
                  else dp - D[:, :, :, q0:q1, None])
        dv[:, :, k0:q1] += torch.einsum("bkgqs,bkgqh->bksh", p,
                                        dog[:, :, :, q0:q1])
        dk[:, :, k0:q1] += torch.einsum("bkgqs,bkgqh->bksh", ds,
                                        f(qg[:, :, :, q0:q1])) * scale
        dq[:, :, :, q0:q1] = torch.einsum("bkgqs,bksh->bkgqh", ds,
                                          f(kf[:, :, k0:q1])) * scale
    return (dq.reshape(B, H, S, hd).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


def flash_attention_bwd_check(q, k, v, o, lse, do, got, *, window: int,
                              tol: float) -> dict:
    """Hold a backward's ``got`` = (dq, dk, dv) to the plain backward row by
    row: each (b, head, position) row of hd values within ``tol`` · the
    row's max |plain| + hd · 2⁻²⁴ · the row's max of the same backward over
    absolute values (``magnitude``).  The first term holds each row to its
    own scale, so a row far smaller than the tensor's largest (a late
    query's, a key's at the window's edge) is held as tightly as the
    largest.  The second is the worst rounding of an f32 dot product of hd
    terms, relative to their size: it covers rows whose sum cancels, where
    that rounding is all that is left (dq of a query that sees one key is
    exactly 0, its dP − D two equal hd-term sums).

    → {"dq"|"dk"|"dv": {"max_abs_err", "max_abs_plain", "worst" (the
    largest row's error over its allowance; ≤ 1 passes)}}."""
    f32 = [t.float() for t in (q, k, v, o, do)]
    plain = flash_attention_bwd_ref(*f32[:4], lse, f32[4], window=window)
    mag = flash_attention_bwd_ref(*f32[:4], lse, f32[4], window=window,
                                  magnitude=True)
    unit = q.shape[-1] * 2.0 ** -24
    out = {}
    for name, g, p, m in zip(("dq", "dk", "dv"), got, plain, mag):
        if not g.numel():
            out[name] = {"max_abs_err": 0.0, "max_abs_plain": 0.0, "worst": 0.0}
            continue
        err = (g.float() - p).abs()
        allow = tol * p.abs().amax(-1) + unit * m.amax(-1)
        out[name] = {"max_abs_err": float(err.max()),
                     "max_abs_plain": float(p.abs().max()),
                     "worst": float((err.amax(-1) / allow)
                                    .nan_to_num(0.0, posinf=math.inf).max())}
    return out


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


def scan_bwd_ref(a: torch.Tensor, h: torch.Tensor, g: torch.Tensor
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """The gradients of the recurrence h_t = a_t ⊙ h_{t−1} + b_t along
    dim 1 (h_{−1} = 0) given g = ∂L/∂h, in f32, step by step from the end
    (the reference's custom VJP, ``repro/models/ssm.py`` ``_ls_bwd``, as a
    sequential recurrence):

        γ_t = a_{t+1}·γ_{t+1} + g_t (one FMA; γ_{S−1} = fma(0, 0, g_{S−1})),
        db_t = γ_t,   da_t = γ_t · h_{t−1} (one rounding).

    a, h, g: (B, S, …) → (da, db) f32 of the same shape; the backward
    kernels of ``rglru_scan`` and ``ssm_scan`` give the same bits."""
    a, h, g = a.float(), h.float(), g.float()
    da = torch.empty_like(a)
    db = torch.empty_like(a)
    gamma = torch.zeros_like(a[:, 0])
    a_next = torch.zeros_like(a[:, 0])
    for t in range(a.shape[1] - 1, -1, -1):
        gamma = _fma_f32(a_next, gamma, g[:, t])
        db[:, t] = gamma
        da[:, t] = gamma * (h[:, t - 1] if t > 0 else 0.0)
        a_next = a[:, t]
    return da, db
