"""Mixture-of-Experts FFN (mixtral-8x22b, qwen3-moe): GShard-style
token-choice top-k routing with a per-expert capacity, in dispatch groups.

Port of :mod:`repro.models.moe`, with the reference's activation
constraints (experts_act / ffn_act, applied by the ``constrain`` the model
passes).  The parameters carry the reference's logical axes: EP, the
experts over ``model`` where the count divides, else TP-MoE, the experts
replicated and each one's ffn over ``model``.

On a mesh (a DTensor ``x``) the data-dependent steps, the routing, the
scatter of tokens into expert slots and the gather back, run on each
rank's local tensors through ``local_map``, on the rank's dispatch groups,
and so do the expert products, on each rank's shards of the slots and
weights (:func:`_expert_mm`); the reference's constraints around them
move the slots into the experts' layout and back.  A rank's groups are
its own batch rows' when the group size divides its rows' tokens; a
group that straddles the data ranks (every decode step's, and a prefill's
where the group size does not divide a rank's tokens, as at the reduced
sizes) is routed whole: its tokens are gathered over the data ranks
first, since capacity positions count over the whole group.  The aux
loss is the mean over every group's, the ranks' means summed.
Under autograd (sharded training) each ``local_map`` that reads an input
whole beside split groups, tokens or experts declares that input's
gradient a partial sum, which the backward reduces: the router beside
split groups, an expert weight gathered whole beside split tokens, the
activations beside a split N of the weight, the combine weights beside
split experts.  An input whose every rank computes on the same data (a
group routed whole on every data rank) keeps a replicated gradient.
The routing is the reference's
exactly: choice ranks are processed in order and tokens in sequence order,
tokens past an expert's capacity are dropped for it, and top-k ties break
toward the lower expert index, as ``jax.lax.top_k`` breaks them.  The
expert products are plain ``torch.einsum``s, as the reference leaves them
to XLA; no Pallas kernel lies on this path.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn.functional as F

from .layers import ParamDef, whole


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
    """→ probs, normalised top-k weights (G, S, k), top-k experts (G, S, k),
    and the aux loss's two means over the groups' tokens: the fraction of
    choices each expert got (E,) and its mean probability (E,)."""
    E = logits.shape[-1]
    # jax.nn.softmax's form; its exp and PyTorch's differ by an ulp at times
    e = torch.exp(logits - logits.amax(-1, keepdim=True))
    probs = e / e.sum(-1, keepdim=True)
    topv, topi = _top_k(probs, k)
    topv = topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9)
    frac = F.one_hot(topi, E).float().sum(2).mean((0, 1))
    return probs, topv, topi, frac, probs.mean((0, 1))


def _aux(frac: torch.Tensor, mprob: torch.Tensor, k: int) -> torch.Tensor:
    """The Switch load-balancing loss E · Σ_e fraction_e · mean_prob_e / k."""
    return frac.shape[-1] * torch.sum(frac * mprob) / k


def _topk_slots(logits: torch.Tensor, k: int, capacity: int):
    """:func:`route_topk` on plain tensors, the aux loss as its two means:
    → dispatch, combine, frac, mprob."""
    G, S, E = logits.shape
    _, topv, topi, frac, mprob = _route(logits, k)
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
    return dispatch, combine, frac, mprob


def route_topk(logits: torch.Tensor, k: int, capacity: int
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Token-choice top-k routing with per-expert capacity.

    logits (G, S, E) f32 → dispatch (G, S, E, C) one-hot, combine (G, S, E, C)
    weights, aux loss.  A (token, choice) takes the next free slot of its
    expert, choice rank 0 of every token first, then rank 1, …, tokens in
    sequence order; past ``capacity`` it is dropped for that expert.  The
    choices of a token go to distinct experts, so each (s, e) has at most
    one slot: the reference's sums over choices hold one term, and the
    slots are written here directly, with the same values.  DTensor logits
    are routed by :func:`_on_groups`."""
    dispatch, combine, frac, mprob = _on_groups(_topk_slots, logits, k,
                                                capacity, n_out=2)
    return dispatch, combine, _aux(frac, mprob, k)


class SortedSlots(NamedTuple):
    """The sorted dispatch's slots, (G, k·g) each: ``order`` sorts the
    choice-major (token, choice) slots stably by expert; in that order a
    slot's expert ``sec``, its queue position ``posc`` (both 0 where
    dropped), its token ``stok``, its weight ``sw`` and whether it is
    kept."""
    order: torch.Tensor
    sec: torch.Tensor
    posc: torch.Tensor
    stok: torch.Tensor
    sw: torch.Tensor
    keep: torch.Tensor


def _sorted_slots(logits: torch.Tensor, k: int, capacity: int):
    """The sorted dispatch's routing on plain tensors: → the
    :class:`SortedSlots` fields, frac, mprob."""
    G, g, _ = logits.shape
    dev = logits.device
    _, topv, topi, frac, mprob = _route(logits, k)
    flat_e = topi.transpose(1, 2).reshape(G, k * g)
    flat_w = topv.transpose(1, 2).reshape(G, k * g)
    flat_tok = torch.arange(g, device=dev).expand(G, k, g).reshape(G, k * g)
    order = torch.argsort(flat_e, dim=1, stable=True)
    se = torch.gather(flat_e, 1, order)
    sw = torch.gather(flat_w, 1, order)
    stok = torch.gather(flat_tok, 1, order)

    idx = torch.arange(k * g, device=dev).expand(G, k * g)
    new_seg = torch.ones_like(se, dtype=torch.bool)
    new_seg[:, 1:] = se[:, 1:] != se[:, :-1]
    seg_start = torch.cummax(torch.where(new_seg, idx, 0), dim=1).values
    pos = idx - seg_start
    keep = pos < capacity
    return (order, torch.where(keep, se, 0), torch.where(keep, pos, 0), stok,
            sw, keep, frac, mprob)


def route_sorted(logits: torch.Tensor, k: int, capacity: int
                 ) -> Tuple[SortedSlots, torch.Tensor]:
    """The sorted dispatch's routing of logits (G, g, E) f32 → its
    :class:`SortedSlots` and the aux loss: the same kept (token, choice)
    pairs, queue positions and weights as :func:`route_topk`'s.  DTensor
    logits are routed by :func:`_on_groups`."""
    *slots, frac, mprob = _on_groups(_sorted_slots, logits, k, capacity,
                                     n_out=6)
    return SortedSlots(*slots), _aux(frac, mprob, k)


# ---------------------------------------------------------------------------
# On a mesh
# ---------------------------------------------------------------------------

def _group_placements(t) -> tuple:
    """Placements of a (G, …) DTensor with its groups split as dim 0 is
    and whole on every other mesh dim (a group split over its tokens, dim
    1, gathered whole)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if p == Shard(0) else Replicate() for p in t.placements)


def _on_groups(fn, logits, k: int, capacity: int, n_out: int):
    """``fn(logits, k, capacity)`` → (n_out per-group tensors, frac,
    mprob), on plain logits as it is; on DTensor logits (G, g, E), on each
    rank's groups through ``local_map`` (groups split over their tokens
    are gathered whole first), the per-group outputs laid out as the
    groups and the aux loss's means over all the groups (the ranks'
    means summed over the group shards)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.distributed.tensor.experimental import local_map
    if not isinstance(logits, DTensor):
        return fn(logits, k, capacity)
    mesh = logits.device_mesh
    pl = _group_placements(logits)
    logits = logits.redistribute(mesh, pl)
    shards = math.prod(mesh.size(i) for i, p in enumerate(pl)
                       if p != Replicate())
    means = tuple(Replicate() if p == Replicate() else Partial() for p in pl)
    out = local_map(lambda lg: fn(lg, k, capacity),
                    out_placements=(pl,) * n_out + (means, means),
                    in_placements=(pl,), device_mesh=mesh)(logits)
    # reduced as DTensors, so that the aux loss's gradient flows back
    # through the mesh (a plain ``full_tensor`` would take a DTensor one)
    whole_pl = (Replicate(),) * mesh.ndim
    frac, mprob = (m.redistribute(mesh, whole_pl) / shards
                   for m in out[n_out:])
    return (*out[:n_out], frac, mprob)


def _mesh_groups(x, cfg, group_size: int):
    """x (B, S, d) DTensor → (xg (G, g, d), g, the rows' placements to
    return to): xg holds each rank's groups, split over the data dims that
    split the batch rows when the group size divides a rank's tokens, else
    whole on every rank (a group straddles the data ranks: the tokens are
    gathered)."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    from .layers import shard_range
    mesh = x.device_mesh
    rows = tuple(p if p == Shard(0) else Replicate() for p in x.placements)
    B, S, d = x.shape
    g = _group_size(B * S, cfg, group_size)
    _, n = shard_range(mesh, rows, 0, B)
    pl = rows if (n * S) % g == 0 else (Replicate(),) * mesh.ndim
    x = x.redistribute(mesh, pl)
    xg = local_map(lambda xl: xl.reshape(-1, g, d), out_placements=list(pl),
                   in_placements=(pl,), device_mesh=mesh)(x)
    return xg, g, rows


def _mesh_tokens(y, x_shape, rows):
    """The groups' output y (G, g, d), laid out as :func:`_mesh_groups`'
    xg, back in (B, S, d) with the batch rows laid out by ``rows``."""
    from torch.distributed.tensor.experimental import local_map
    mesh = y.device_mesh
    pl = tuple(y.placements)
    S, d = x_shape[1], x_shape[2]
    y = local_map(lambda yl: yl.reshape(-1, S, d), out_placements=list(pl),
                  in_placements=(pl,), device_mesh=mesh)(y)
    return y.redistribute(mesh, rows)


def _router_logits(xg, router):
    """(G, g, E) f32 router logits: on a mesh, each rank's groups against
    the whole router, whose gradient is then each rank's groups' part: a
    partial sum over the mesh dims that split the groups."""
    from torch.distributed.tensor import DTensor, Partial, Shard
    from torch.distributed.tensor.experimental import local_map
    if not isinstance(xg, DTensor):
        return (xg.to(router.dtype) @ router).float()
    pl = tuple(xg.placements)
    router = whole(router, range(router.dim()))
    r_pl = tuple(router.placements)
    r_grad = tuple(Partial() if p == Shard(0) else r
                   for p, r in zip(pl, r_pl))
    return local_map(lambda xl, r: (xl.to(r.dtype) @ r).float(),
                     out_placements=list(pl), in_placements=(pl, r_pl),
                     in_grad_placements=(pl, r_grad),
                     device_mesh=xg.device_mesh)(xg, router)


def _local(fn, out_pl, *ts, grad_pl=None):
    """``fn`` on the local shards of the DTensors ``ts`` (each already laid
    out as it needs), its output laid out by ``out_pl``; on plain tensors,
    ``fn`` itself.  ``grad_pl`` gives the inputs' gradient placements
    where one differs from its layout (a partial sum), None for the
    layout."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor.experimental import local_map
    if not isinstance(ts[0], DTensor):
        return fn(*ts)
    in_pl = tuple(tuple(t.placements) for t in ts)
    grad_pl = in_pl if grad_pl is None else tuple(
        p if g is None else g for p, g in zip(in_pl, grad_pl))
    return local_map(fn, out_placements=list(out_pl), in_placements=in_pl,
                     in_grad_placements=grad_pl,
                     device_mesh=ts[0].device_mesh)(*ts)


def _moved(pl, src: int, dst: int) -> tuple:
    """Placements ``pl`` with the split of dim ``src`` moved to ``dst``."""
    from torch.distributed.tensor import Shard
    return tuple(Shard(dst) if p == Shard(src) else p for p in pl)


def _gather_layout(ye, groups_pl, g_dim: int, e_dim: int):
    """Where the gather back to the tokens reads the experts' output ye:
    its groups (dim ``g_dim``) laid out as the routing's ``groups_pl``, its
    experts (dim ``e_dim``) kept split where they are (each rank then sums
    its own experts' part: a partial sum), whole on every other mesh dim.
    → (ye redistributed, the first and the number of this rank's experts,
    the placements of the gathered tokens (G, g, d))."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    from .layers import shard_range
    mesh = ye.device_mesh
    pl = tuple(Shard(g_dim) if gp == Shard(0) else
               (Shard(e_dim) if yp == Shard(e_dim) else Replicate())
               for gp, yp in zip(groups_pl, ye.placements))
    ye = ye.redistribute(mesh, pl)
    first, n = shard_range(mesh, pl, e_dim, ye.shape[e_dim])
    out = tuple(Shard(0) if p == Shard(g_dim) else
                (Partial() if p == Shard(e_dim) else Replicate()) for p in pl)
    return ye, first, n, out


def _own_experts_grad(out, w) -> tuple:
    """The gradient placements of the combine weights ``w``, read whole by
    the gather back to the tokens whose output is laid out by ``out``
    (:func:`_gather_layout`): each rank weighs only its own experts'
    slots, so on every mesh dim that splits the experts (``out``
    partial) its gradient is a partial sum."""
    from torch.distributed.tensor import Partial
    return tuple(Partial() if o.is_partial() else p
                 for o, p in zip(out, w.placements))


def _expert_mm(eq: str, x, w, e_dim: int):
    """``torch.einsum(eq, x, w)`` of activations x (experts on dim
    ``e_dim``, the contraction last) and an expert weight w (E, K, N).  On
    a mesh each rank multiplies its shards: per mesh dim, experts split
    in x take w's experts split alike (EP); a split contraction (TP-MoE's
    ffn into ``w2``) gives a partial sum; a split N of w (TP-MoE's ffn out
    of ``w1``/``w3``, FSDP's d out of ``w2``) splits the output's last
    dim; where x is whole and w's K split (FSDP's d into ``w1``/``w3``),
    x takes its slice and the sum is partial, so a group routed whole (a
    decode step's) gathers no weights; split token dims take w whole
    (FSDP's weights gathered), as does every other dim.

    Under autograd an input whole on a mesh dim along which the ranks
    compute different parts has a partial-sum gradient there: x's where
    w's N is split (each rank's N columns give their part), w's where
    the tokens are split (each rank's tokens give theirs)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not isinstance(x, DTensor):
        return torch.einsum(eq, x, w)
    last = x.dim() - 1
    rows = []       # per mesh dim: x's, w's, the output's, x's and w's grad
    for xp, wp in zip(x.placements, w.placements):
        if xp == Shard(e_dim):
            rows.append((xp, Shard(0), xp, xp, Shard(0)))
        elif xp == Shard(last):
            rows.append((xp, Shard(1), Partial(), xp, Shard(1)))
        elif wp == Shard(2) and xp == Replicate():
            rows.append((xp, wp, Shard(last), Partial(), wp))
        elif wp == Shard(1) and xp == Replicate():
            rows.append((Shard(last), wp, Partial(), Shard(last), wp))
        elif isinstance(xp, Shard):
            rows.append((xp, Replicate(), xp, xp, Partial()))
        else:
            rows.append((Replicate(),) * 5)
    x_pl, w_pl, out_pl, x_grad, w_grad = zip(*rows)
    mesh = x.device_mesh
    return _local(lambda xl, wl: torch.einsum(eq, xl, wl), out_pl,
                  x.redistribute(mesh, x_pl), w.redistribute(mesh, w_pl),
                  grad_pl=(x_grad, w_grad))


def _group_size(T: int, cfg, group_size: int) -> int:
    g = min(group_size or cfg.moe_group, T)
    while T % g != 0:
        g //= 2
    return g


def _groups(x: torch.Tensor, cfg, group_size: int) -> Tuple[torch.Tensor, int]:
    B, S, d = x.shape
    g = _group_size(B * S, cfg, group_size)
    return x.reshape(B * S // g, g, d), g


def _no_constraint(x, logical):
    return x


def moe_ffn(p, x: torch.Tensor, cfg, group_size: int = 0,
            constrain=_no_constraint) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, d) → (B, S, d), aux loss.  Groups of ``group_size`` tokens
    (``cfg.moe_group`` by default) bound the dispatch tensors;
    ``cfg.moe_dispatch`` picks the one-hot (GShard) or the sorted
    dispatch.  ``constrain(t, logical)`` lays out the expert activations
    at the reference's sites.  A DTensor ``x`` runs on the mesh (see the
    module docstring); its output has x's batch rows and is whole on every
    other mesh dim (the experts' partial sums reduced)."""
    from torch.distributed.tensor import DTensor
    on_mesh = isinstance(x, DTensor)
    if on_mesh:
        xg, g, rows = _mesh_groups(x, cfg, group_size)
    else:
        xg, g = _groups(x, cfg, group_size)
    if cfg.moe_dispatch == "sort":
        y, aux = moe_ffn_sorted(p, xg, cfg, constrain)
    else:
        y, aux = _moe_onehot(p, xg, cfg, g, constrain)
    if on_mesh:
        return _mesh_tokens(y, x.shape, rows), aux
    return y.reshape(x.shape), aux


def _moe_onehot(p, xg, cfg, g: int, constrain):
    """The one-hot (GShard) dispatch of grouped tokens xg (G, g, d) →
    (G, g, d), aux."""
    logits = _router_logits(xg, p["router"])                   # (G, g, E)
    dispatch, comb, aux = route_topk(logits, cfg.top_k, moe_capacity(cfg, g))
    dt = xg.dtype
    groups_pl = tuple(getattr(xg, "placements", ()))
    xe = _local(lambda dl, xl: torch.einsum("gsec,gsd->egcd", dl.to(dt), xl),
                _moved(groups_pl, 0, 1), dispatch, xg)
    xe = constrain(xe, ("experts_act", "batch", None, None))
    h = F.silu(whole(_expert_mm("egcd,edf->egcf", xe, p["w1"], 0))) \
        * whole(_expert_mm("egcd,edf->egcf", xe, p["w3"], 0))
    h = constrain(h, ("experts_act", "batch", None, "ffn_act"))
    ye = _expert_mm("egcf,efd->egcd", h, p["w2"], 0)
    ye = constrain(ye, ("experts_act", "batch", None, None))
    if not groups_pl:
        return torch.einsum("egcd,gsec->gsd", ye, comb.to(dt)), aux
    ye, first, n, out = _gather_layout(ye, groups_pl, 1, 0)
    y = _local(lambda yl, cl: torch.einsum(
        "egcd,gsec->gsd", yl, cl[:, :, first:first + n].to(dt)), out, ye, comb,
        grad_pl=(None, _own_experts_grad(out, comb)))
    return y, aux


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
    slots, aux = route_sorted(_router_logits(xg, p["router"]), k, C)
    groups_pl = tuple(getattr(xg, "placements", ()))

    def scatter(xl, sl: SortedSlots):
        Gl = xl.shape[0]
        gath = torch.gather(xl, 1, sl.stok[..., None].expand(Gl, k * g, d))
        gath = torch.where(sl.keep[..., None], gath, 0)
        gi = torch.arange(Gl, device=xl.device)[:, None].expand(Gl, k * g)
        xe = torch.zeros((Gl, E, C, d), dtype=xl.dtype, device=xl.device)
        xe.index_put_((gi, sl.sec, sl.posc), gath, accumulate=True)
        return xe

    xe = _local(lambda xl, *sl: scatter(xl, SortedSlots(*sl)), groups_pl,
                xg, *slots)
    # the scatter local, then one all-to-all into the experts' layout
    xe = constrain(xe, ("batch", None, None, None))
    xe = constrain(xe, ("batch", "experts_act", None, None))

    h = F.silu(whole(_expert_mm("gecd,edf->gecf", xe, p["w1"], 1))) \
        * whole(_expert_mm("gecd,edf->gecf", xe, p["w3"], 1))
    h = constrain(h, ("batch", "experts_act", None, "ffn_act"))
    ye = _expert_mm("gecf,efd->gecd", h, p["w2"], 1)
    ye = constrain(ye, ("batch", "experts_act", None, None))
    ye = constrain(ye, ("batch", None, None, None))     # back to the gather's

    def gather(yl, sl: SortedSlots, first: int, n: int):
        Gl = yl.shape[0]
        gi = torch.arange(Gl, device=yl.device)[:, None].expand(Gl, k * g)
        # this rank's experts' slots (all of them off a mesh)
        mine = sl.keep & (sl.sec >= first) & (sl.sec < first + n)
        at = torch.where(mine, sl.sec - first, 0)
        y_slots = yl[gi, at, sl.posc] * (sl.sw * mine).to(yl.dtype)[..., None]
        inv = torch.argsort(sl.order, dim=1)
        y_unsorted = torch.gather(y_slots, 1, inv[..., None].expand(Gl, k * g, d))
        return y_unsorted.reshape(Gl, k, g, d).sum(1)

    if not groups_pl:
        return gather(ye, slots, 0, E), aux
    ye, first, n, out = _gather_layout(ye, groups_pl, 0, 1)
    grad_pl = (None,) + tuple(_own_experts_grad(out, t) if f == "sw" else None
                              for f, t in slots._asdict().items())
    y = _local(lambda yl, *sl: gather(yl, SortedSlots(*sl), first, n), out,
               ye, *slots, grad_pl=grad_pl)
    return y, aux
