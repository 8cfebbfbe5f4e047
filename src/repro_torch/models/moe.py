"""Mixture-of-Experts FFN (mixtral-8x22b, qwen3-moe): GShard-style
token-choice top-k routing with a per-expert capacity, in dispatch groups.

Port of :mod:`repro.models.moe`, with the reference's activation
constraints (experts_act / ffn_act, applied by the ``constrain`` the model
passes).  The parameters carry the reference's logical axes (EP: experts
over ``model`` where the count divides, else TP-MoE over the per-expert
ffn), so the dry run sizes them; running moe on a mesh (the dispatch's
all-to-all) is ROADMAP queue 1 item 12 and raises here.
The routing is the reference's
exactly: choice ranks are processed in order and tokens in sequence order,
tokens past an expert's capacity are dropped for it, and top-k ties break
toward the lower expert index, as ``jax.lax.top_k`` breaks them.  The
expert products are plain ``torch.einsum``s, as the reference leaves them
to XLA; no Pallas kernel lies on this path.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.nn.functional as F

from .layers import ParamDef


def moe_defs(cfg) -> dict:
    d, E = cfg.d_model, cfg.n_experts
    ff = cfg.moe_ff or cfg.d_ff
    res = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    return {
        "ln": ParamDef((d,), init="ones", logical=("embed",)),
        "router": ParamDef((d, E), dtype=torch.float32, init="scaled",
                           logical=("embed", None)),
        "w1": ParamDef((E, d, ff), init="scaled",
                       logical=("experts", "embed", "ffn")),
        "w3": ParamDef((E, d, ff), init="scaled",
                       logical=("experts", "embed", "ffn")),
        "w2": ParamDef((E, ff, d), init="scaled", scale=res,
                       logical=("experts", "ffn", "embed")),
    }


def moe_capacity(cfg, tokens_per_group: int) -> int:
    """Slots an expert takes from a group, rounded up to a multiple of 8."""
    cap = int(tokens_per_group * cfg.top_k / cfg.n_experts
              * cfg.capacity_factor) + 1
    return max(8, ((cap + 7) // 8) * 8)


def _top_k(probs: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k largest along the last dim, ties to the lower index (a stable
    descending sort), as ``jax.lax.top_k``."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def _route(logits: torch.Tensor, k: int):
    """→ probs, normalised top-k weights (G, S, k), top-k experts (G, S, k)
    and the Switch load-balancing aux loss."""
    E = logits.shape[-1]
    # jax.nn.softmax's form; its exp and PyTorch's differ by an ulp at times
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    topv, topi = _top_k(probs, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    # E · Σ_e fraction_tokens_e · mean_prob_e / k
    frac = F.one_hot(topi, E).float().sum(2).mean((0, 1))
    aux = E * torch.sum(frac * probs.mean((0, 1))) / k
    return probs, topv, topi, aux


def route_topk(logits: torch.Tensor, k: int, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing with per-expert capacity.

    logits (G, S, E) f32 → dispatch (G, S, E, C) one-hot, combine (G, S, E, C)
    weights, aux loss.  A (token, choice) takes the next free slot of its
    expert, choice rank 0 of every token first, then rank 1, …, tokens in
    sequence order; past ``capacity`` it is dropped for that expert.  The
    choices of a token go to distinct experts, so each (s, e) has at most
    one slot: the reference's sums over choices hold one term, and the
    slots are written here directly, with the same values."""
    G, S, E = logits.shape
    _, topv, topi, aux = _route(logits, k)
    # choice-major order: (G, k·S)
    flat_e = topi.transpose(1, 2).reshape(G, k * S)
    oh = F.one_hot(flat_e, E).float()                       # (G, k·S, E)
    before = (torch.cumsum(oh, dim=1) - oh)                 # slots taken before
    pos = torch.gather(before, 2, flat_e[..., None])[..., 0].long()
    keep = pos < capacity
    g, j = keep.nonzero(as_tuple=True)
    s = j % S
    e, c = flat_e[g, j], pos[g, j]
    dispatch = torch.zeros((G, S, E, capacity), dtype=torch.float32,
                           device=logits.device)
    combine = torch.zeros_like(dispatch)
    dispatch[g, s, e, c] = 1.0
    combine[g, s, e, c] = topv.transpose(1, 2).reshape(G, k * S)[g, j]
    return dispatch, combine, aux


def _groups(x: torch.Tensor, cfg, group_size: int) -> Tuple[torch.Tensor, int]:
    B, S, d = x.shape
    T = B * S
    g = min(group_size or cfg.moe_group, T)
    while T % g != 0:
        g //= 2
    return x.reshape(T // g, g, d), g


def _no_constraint(x, logical):
    return x


def moe_ffn(p, x: torch.Tensor, cfg, group_size: int = 0,
            constrain=_no_constraint) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (B, S, d), aux loss.  Groups of ``group_size`` tokens
    (``cfg.moe_group`` by default) bound the dispatch tensors;
    ``cfg.moe_dispatch`` picks the one-hot (GShard) or the sorted
    dispatch.  ``constrain(t, logical)`` lays out the expert activations
    at the reference's sites; a DTensor ``x`` (a mesh) raises."""
    from torch.distributed.tensor import DTensor
    if isinstance(x, DTensor):
        raise NotImplementedError(
            "moe on a mesh (expert parallelism) is not ported yet: ROADMAP "
            "queue 1, item 12 (moe (EP) on a mesh)")
    xg, g = _groups(x, cfg, group_size)
    if cfg.moe_dispatch == "sort":
        y, aux = moe_ffn_sorted(p, xg, cfg, constrain)
        return y.reshape(x.shape), aux
    logits = (xg.to(p["router"].dtype) @ p["router"]).float()   # (G, g, E)
    dispatch, comb, aux = route_topk(logits, cfg.top_k, moe_capacity(cfg, g))
    dt = x.dtype
    xe = torch.einsum("gsec,gsd->egcd", dispatch.to(dt), xg)
    xe = constrain(xe, ("experts_act", "batch", None, None))
    h = F.silu(torch.einsum("egcd,edf->egcf", xe, p["w1"])) \
        * torch.einsum("egcd,edf->egcf", xe, p["w3"])
    h = constrain(h, ("experts_act", "batch", None, "ffn_act"))
    ye = torch.einsum("egcf,efd->egcd", h, p["w2"])
    ye = constrain(ye, ("experts_act", "batch", None, None))
    y = torch.einsum("egcd,gsec->gsd", ye, comb.to(dt))
    return y.reshape(x.shape), aux


def moe_ffn_sorted(p, xg: torch.Tensor, cfg, constrain=_no_constraint
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sort-based dispatch of grouped tokens xg (G, g, d) → (G, g, d), aux.
    The (token, choice) slots, choice-major, are sorted stably by expert;
    a slot's position in its expert's run is its queue position, past the
    capacity it is dropped; tokens are scattered into (G, E, C, d), the
    experts run, and each token sums its kept choices' outputs by weight.
    The same capacity and dropping as :func:`moe_ffn`'s one-hot path."""
    G, g, d = xg.shape
    E, k = cfg.n_experts, cfg.top_k
    C = moe_capacity(cfg, g)
    logits = (xg.to(p["router"].dtype) @ p["router"]).float()
    _, topv, topi, aux = _route(logits, k)

    flat_e = topi.transpose(1, 2).reshape(G, k * g)
    flat_w = topv.transpose(1, 2).reshape(G, k * g)
    flat_tok = torch.arange(g, device=xg.device).expand(G, k, g).reshape(G, k * g)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    stok = torch.gather(flat_tok, 1, order)

    idx = torch.arange(k * g, device=xg.device).expand(G, k * g)
    new_seg = torch.ones_like(se, dtype=torch.bool)
    new_seg[:, 1:] = se[:, 1:] != se[:, :-1]
    seg_start = torch.cummax(torch.where(new_seg, idx, 0), dim=1).values
    pos = idx - seg_start
    keep = pos < C
    posc = torch.where(keep, pos, 0)
    sec = torch.where(keep, se, 0)

    gath = torch.gather(xg, 1, stok[..., None].expand(G, k * g, d))
    gath = torch.where(keep[..., None], gath, 0)
    gi = torch.arange(G, device=xg.device)[:, None].expand(G, k * g)
    xe = torch.zeros((G, E, C, d), dtype=xg.dtype, device=xg.device)
    xe.index_put_((gi, sec, posc), gath, accumulate=True)
    # the scatter local, then one all-to-all into the experts' layout
    xe = constrain(xe, ("batch", None, None, None))
    xe = constrain(xe, ("batch", "experts_act", None, None))

    h = F.silu(torch.einsum("gecd,edf->gecf", xe, p["w1"])) \
        * torch.einsum("gecd,edf->gecf", xe, p["w3"])
    h = constrain(h, ("batch", "experts_act", None, "ffn_act"))
    ye = torch.einsum("gecf,efd->gecd", h, p["w2"])
    ye = constrain(ye, ("batch", "experts_act", None, None))
    ye = constrain(ye, ("batch", None, None, None))     # back to the gather's

    y_slots = ye[gi, sec, posc] * (sw * keep).to(ye.dtype)[..., None]
    inv = torch.argsort(order, dim=1)
    y_unsorted = torch.gather(y_slots, 1, inv[..., None].expand(G, k * g, d))
    return y_unsorted.reshape(G, k, g, d).sum(1), aux
