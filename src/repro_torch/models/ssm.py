"""Mamba-1 selective SSM block (falcon-mamba-7b) and the linear-recurrence
helpers shared with the RG-LRU block.

Port of :mod:`repro.models.ssm`.  The reference runs the recurrence as an
associative scan (the oracle of its Pallas scans); here a 3-D (B, S, W)
scan goes through the hand-written ``rglru_scan`` kernel and a 4-D
(B, S, D, N) scan through ``ssm_scan`` (``kernels.ops``), both computing
the same recurrence in sequential order, one FMA a step.  Decode advances
the recurrence one step.

On a mesh (DTensors) the scans and the causal convolution run on each
rank's lanes through ``local_map``: its batch rows (the data axes) and
channels (``lru`` or ``inner`` over ``model``), the sequence whole (a
sequence-sharded input gathered), so the kernels see plain local
tensors.  ``x_proj`` contracts the split ``inner``, so its partial output
is reduced once, as GSPMD does.  Under FSDP the projections' ``embed``
dim is gathered before the products, so the batch rows stay split over
the data axes through the block.  Under autograd the inputs that these
``local_map`` calls read whole beside split rows or channels (the
convolution's w and b beside split batch rows, the readout's C beside
split channels) take partial-sum gradients; the scans' a, b and h0 are
laid out as their lanes, so their gradients are each rank's own.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from ..kernels import ops
from .layers import ParamDef, gather_seq, residual, rms_norm, whole


def linear_scan(a: torch.Tensor, b: torch.Tensor,
                h0: Optional[torch.Tensor] = None, axis: int = 1) -> torch.Tensor:
    """h_t = a_t ⊙ h_{t−1} + b_t along ``axis`` (1), all h_t, for (B, S, W)
    or (B, S, D, N); ``h0`` is folded into the first b: h_1 = a_1·h0 + b_1,
    as the reference does.  On DTensors, the kernel on each rank's lanes
    (:func:`_lanes`)."""
    from torch.distributed.tensor import DTensor, Shard
    from torch.distributed.tensor.experimental import local_map
    if axis != 1:
        raise NotImplementedError(f"linear_scan runs along axis 1, got {axis}")
    if a.dim() not in (3, 4):
        raise NotImplementedError(
            f"linear_scan takes (B, S, W) or (B, S, D, N), got {a.dim()}-D")
    if not isinstance(a, DTensor):
        return _scan(a, b, h0)
    mesh = a.device_mesh
    pl = _lanes(a)
    args, in_pl = [a.redistribute(mesh, pl), b.redistribute(mesh, pl)], [pl, pl]
    if h0 is not None:                  # (B, C, …): a's placements less S
        h_pl = tuple(Shard(p.dim - 1) if isinstance(p, Shard) and p.dim > 1
                     else p for p in pl)
        args.append(h0.redistribute(mesh, h_pl))
        in_pl.append(h_pl)
    return local_map(_scan, out_placements=list(pl), in_placements=tuple(in_pl),
                     device_mesh=mesh)(*args)


def _scan(a, b, h0=None):
    if h0 is not None:
        b = torch.cat([b[:, :1] + a[:, :1] * h0[:, None], b[:, 1:]], dim=1)
    scan = ops.rglru_scan if a.dim() == 3 else ops.ssm_scan
    return scan(a.float().contiguous(), b.float().contiguous())


def _lanes(t) -> tuple:
    """The placements of a (B, S, C, …) DTensor for a recurrence along S:
    its batch rows and channels split as they are, its sequence whole,
    every other mesh dim whole (a partial sum reduced)."""
    from torch.distributed.tensor import Replicate, Shard
    return tuple(p if isinstance(p, Shard) and p.dim != 1 else Replicate()
                 for p in t.placements)


def causal_conv1d(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                  tail: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Depthwise causal conv, x (B, S, C), w (K, C), b (C,), as K shifted
    adds in f32; ``tail`` (B, K−1, C) is the context before x.  On
    DTensors, on each rank's lanes (:func:`_lanes`), w and b split as the
    channels and whole elsewhere: on a mesh dim that splits the batch rows
    each rank's w and b gradients are its rows' part, a partial sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    if not isinstance(x, DTensor):
        return _conv(x, w, b, tail)
    mesh = x.device_mesh
    pl = _lanes(x)
    w_pl = tuple(Shard(1) if p == Shard(2) else Replicate() for p in pl)
    b_pl = tuple(Shard(0) if p == Shard(2) else Replicate() for p in pl)
    args = [x.redistribute(mesh, pl), w.redistribute(mesh, w_pl),
            b.redistribute(mesh, b_pl)]
    in_pl = [pl, w_pl, b_pl]
    grad_pl = [pl] + [tuple(Partial() if p == Shard(0) else q
                            for p, q in zip(pl, wb)) for wb in (w_pl, b_pl)]
    if tail is not None:
        args.append(tail.redistribute(mesh, pl))
        in_pl.append(pl)
        grad_pl.append(pl)
    return local_map(_conv, out_placements=list(pl), in_placements=tuple(in_pl),
                     in_grad_placements=tuple(grad_pl), device_mesh=mesh)(*args)


def _conv(x, w, b, tail=None):
    K = w.shape[0]
    if tail is None:
        tail = torch.zeros((x.shape[0], K - 1, x.shape[-1]), dtype=x.dtype,
                           device=x.device)
    xp = torch.cat([tail, x], dim=1)                 # (B, S+K−1, C)
    S = x.shape[1]
    y = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for i in range(K):
        y = y + xp[:, i:i + S, :].float() * w[i].float()
    return (y + b.float()).to(x.dtype)


def _readout(h: torch.Tensor, C: torch.Tensor) -> torch.Tensor:
    """y = Σ_n h[…, d, n] · C[…, n] (f32), h (B, S, D, N) or (B, D, N).  On
    a mesh, on each rank's batch rows and channels (C's batch rows as
    h's, its N whole); on a mesh dim that splits the channels D each
    rank's C gradient is its channels' part, a partial sum."""
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map
    eq = "bsdn,bsn->bsd" if h.dim() == 4 else "bdn,bn->bd"
    if not isinstance(h, DTensor):
        return torch.einsum(eq, h, C.float())
    mesh = h.device_mesh
    h_pl = tuple(p if isinstance(p, Shard) and p.dim < h.dim() - 1
                 else Replicate() for p in h.placements)
    c_pl = tuple(Shard(0) if p == Shard(0) else Replicate() for p in h_pl)
    c_grad = tuple(Partial() if p == Shard(h.dim() - 2) else q
                   for p, q in zip(h_pl, c_pl))
    return local_map(lambda hl, cl: torch.einsum(eq, hl, cl.float()),
                     out_placements=list(h_pl), in_placements=(h_pl, c_pl),
                     in_grad_placements=(h_pl, c_grad),
                     device_mesh=mesh)(h.redistribute(mesh, h_pl),
                                       C.redistribute(mesh, c_pl))


def _split_inner(y: torch.Tensor, conv_w: torch.Tensor):
    """``in_proj``'s output (…, 2·di) → x_in, z (…, di).  On a mesh the
    split 2·di (``inner2``) is gathered, halved, and each half split as
    ``conv_w``'s di (``inner``)."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(y, DTensor):
        return torch.chunk(y, 2, dim=-1)
    last = y.dim() - 1
    y = whole(y, (last,))
    x_in, z = torch.chunk(y, 2, dim=-1)
    pl = tuple(Shard(last) if cp == Shard(1) else p
               for p, cp in zip(y.placements, conv_w.placements))
    return x_in.redistribute(y.device_mesh, pl), z.redistribute(y.device_mesh, pl)


# ---------------------------------------------------------------------------
# Mamba-1 block
# ---------------------------------------------------------------------------

def mamba_defs(cfg) -> dict:
    d, di, N, dr, K = (cfg.d_model, cfg.dinner, cfg.ssm_state, cfg.dtrank,
                       cfg.ssm_conv)
    f32 = torch.float32
    res = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    return {
        "norm": ParamDef((d,), init="ones", logical=("embed",)),
        "in_proj": ParamDef((d, 2 * di), init="scaled",
                            logical=("embed", "inner2")),
        "conv_w": ParamDef((K, di), init="scaled", scale=0.5,
                           logical=(None, "inner")),
        "conv_b": ParamDef((di,), init="zeros", logical=("inner",)),
        "x_proj": ParamDef((di, dr + 2 * N), init="scaled",
                           logical=("inner", None)),
        "dt_proj": ParamDef((dr, di), init="scaled", logical=(None, "inner")),
        "dt_bias": ParamDef((di,), dtype=f32, init="zeros",
                            logical=("inner",)),
        "A_log": ParamDef((di, N), dtype=f32, init="ones",
                          logical=("inner", None)),
        "D": ParamDef((di,), dtype=f32, init="ones", logical=("inner",)),
        "out_proj": ParamDef((di, d), init="scaled", scale=res,
                             logical=("inner", "embed")),
    }


class MambaState(NamedTuple):
    h: torch.Tensor          # (B, di, N) f32
    conv_tail: torch.Tensor  # (B, K−1, di)


def mamba_init_state(cfg, batch: int, dtype=torch.bfloat16,
                     device=None) -> MambaState:
    return MambaState(
        h=torch.zeros((batch, cfg.dinner, cfg.ssm_state), dtype=torch.float32,
                      device=device),
        conv_tail=torch.zeros((batch, cfg.ssm_conv - 1, cfg.dinner),
                              dtype=dtype, device=device))


def _ssm_inputs(p, x_c: torch.Tensor, cfg):
    """The discretisation: → (a, b, C) with a, b (B, S, di, N) f32 and C
    (B, S, N) in x_c's dtype."""
    dr, N = cfg.dtrank, cfg.ssm_state
    xdbl = whole(x_c @ p["x_proj"])                          # (B, S, dr+2N)
    dt, Bc, Cc = torch.split(xdbl, [dr, N, N], dim=-1)
    dt = F.softplus((dt @ p["dt_proj"]).float() + p["dt_bias"])  # (B, S, di)
    A = -torch.exp(p["A_log"].float())                       # (di, N)
    a = torch.exp(dt[..., None] * A)                         # (B, S, di, N)
    b = (dt[..., None] * Bc[..., None, :].float()
         * x_c[..., None].float())                           # (B, S, di, N)
    return a, b, Cc


def mamba_block(p, x: torch.Tensor, cfg,
                state: Optional[MambaState] = None,
                return_state: bool = False):
    """Full-sequence Mamba block. x: (B, S, d) → (B, S, d), and the state
    after the last position with ``return_state``."""
    h_in = gather_seq(rms_norm(x, p["norm"]))
    x_in, z = _split_inner(h_in @ whole(p["in_proj"], (0,)), p["conv_w"])
    tail = state.conv_tail if state is not None else None
    x_c = F.silu(causal_conv1d(x_in, p["conv_w"], p["conv_b"], tail))
    a, b, Cc = _ssm_inputs(p, x_c, cfg)
    hs = linear_scan(a, b, h0=state.h if state is not None else None)
    del a, b                                  # (B, S, di, N) f32 each
    y = _readout(hs, Cc)
    y = y + p["D"] * x_c.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ whole(p["out_proj"], (1,))
    if not return_state:
        return residual(x, out)
    if tail is None:
        tail = torch.zeros((x.shape[0], cfg.ssm_conv - 1, cfg.dinner),
                           dtype=x.dtype, device=x.device)
    new_tail = torch.cat([tail, x_in], dim=1)[:, -(cfg.ssm_conv - 1):, :]
    return residual(x, out), MambaState(h=hs[:, -1], conv_tail=new_tail)


def mamba_decode_step(p, x: torch.Tensor, state: MambaState, cfg
                      ) -> Tuple[torch.Tensor, MambaState]:
    """One-token step. x: (B, d) → (B, d)."""
    h_in = rms_norm(x, p["norm"])
    x_in, z = _split_inner(h_in @ whole(p["in_proj"], (0,)),
                           p["conv_w"])                      # (B, di)
    window = torch.cat([state.conv_tail, x_in[:, None, :]], dim=1)
    x_c = torch.sum(window.float() * p["conv_w"].float()[None], dim=1) \
        + p["conv_b"].float()
    x_c = F.silu(x_c).to(x.dtype)                            # (B, di)
    a, b, Cc = _ssm_inputs(p, x_c[:, None, :], cfg)
    a, b, Cc = a[:, 0], b[:, 0], Cc[:, 0]                    # (B, di, N), (B, N)
    h = a * state.h + b
    y = _readout(h, Cc)
    y = y + p["D"] * x_c.float()
    y = y.to(x.dtype) * F.silu(z)
    out = y @ whole(p["out_proj"], (1,))
    return x + out, MambaState(h=h, conv_tail=window[:, 1:, :])
