"""RG-LRU recurrent block (recurrentgemma-2b): gated linear recurrence and
GeLU gate.  Port of :mod:`repro.models.rglru`:

h_t = a_t ⊙ h_{t−1} + sqrt(1 − a_t²) ⊙ (i_t ⊙ u_t),
a_t = exp(−c · softplus(Λ) · σ(r_t)),  c = 8,

with the reference's dense gate projections.  The sequence path's
recurrence is the ``rglru_scan`` kernel, through :func:`.ssm.linear_scan`.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from .layers import ParamDef, gather_seq, residual, rms_norm, whole
from .ssm import causal_conv1d, linear_scan

_C = 8.0
_K = 4          # conv width


def rglru_defs(cfg) -> dict:
    d, w = cfg.d_model, cfg.lru_width or cfg.d_model
    res = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    f32 = torch.float32
    return {
        "norm": ParamDef((d,), init="ones", logical=("embed",)),
        "w_in": ParamDef((d, w), init="scaled", logical=("embed", "lru")),
        "w_gate": ParamDef((d, w), init="scaled", logical=("embed", "lru")),
        "conv_w": ParamDef((_K, w), init="scaled", scale=0.5,
                           logical=(None, "lru")),
        "conv_b": ParamDef((w,), init="zeros", logical=("lru",)),
        "w_r": ParamDef((w, w), init="scaled", logical=("lru_in", "lru")),
        "b_r": ParamDef((w,), dtype=f32, init="zeros", logical=("lru",)),
        "w_i": ParamDef((w, w), init="scaled", logical=("lru_in", "lru")),
        "b_i": ParamDef((w,), dtype=f32, init="zeros", logical=("lru",)),
        "lam": ParamDef((w,), dtype=f32, init="ones", logical=("lru",)),
        "w_out": ParamDef((w, d), init="scaled", scale=res,
                          logical=("lru", "embed")),
    }


class RGLRUState(NamedTuple):
    h: torch.Tensor          # (B, W) f32
    conv_tail: torch.Tensor  # (B, K−1, W)


def rglru_init_state(cfg, batch: int, dtype=torch.bfloat16,
                     device=None) -> RGLRUState:
    w = cfg.lru_width or cfg.d_model
    return RGLRUState(
        h=torch.zeros((batch, w), dtype=torch.float32, device=device),
        conv_tail=torch.zeros((batch, _K - 1, w), dtype=dtype, device=device))


def _gates(p, u: torch.Tensor):
    """The gates of u (…, W) through the square weights (``lru_in`` whole,
    ``lru`` split): on a mesh u's channels are gathered for the products,
    whose outputs are split as ``lru``."""
    uw = whole(u, (u.dim() - 1,))
    r = torch.sigmoid((uw @ p["w_r"]).float() + p["b_r"])
    i = torch.sigmoid((uw @ p["w_i"]).float() + p["b_i"])
    log_a = -_C * F.softplus(p["lam"]) * r
    a = torch.exp(log_a)
    gate_in = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, gate_in * i * u.float()


def rglru_block(p, x: torch.Tensor, cfg,
                state: Optional[RGLRUState] = None,
                return_state: bool = False):
    """Full-sequence recurrent block. x: (B, S, d) → (B, S, d), and the
    state after the last position with ``return_state``.  On a mesh the
    scan and the convolution run on each rank's lanes (``ssm``), and under
    FSDP the projections' ``embed`` dim is gathered first, so the batch
    rows stay split."""
    h_in = gather_seq(rms_norm(x, p["norm"]))
    u_raw = h_in @ whole(p["w_in"], (0,))                    # (B, S, W)
    gate = F.gelu(h_in @ whole(p["w_gate"], (0,)), approximate="tanh")
    tail = state.conv_tail if state is not None else None
    u = causal_conv1d(u_raw, p["conv_w"], p["conv_b"], tail)
    a, b = _gates(p, u)                                      # (B, S, W) f32
    hs = linear_scan(a, b, h0=state.h if state is not None else None)
    out = (hs.to(x.dtype) * gate) @ whole(p["w_out"], (1,))
    if not return_state:
        return residual(x, out)
    if tail is None:
        tail = torch.zeros((x.shape[0], _K - 1, u.shape[-1]), dtype=x.dtype,
                           device=x.device)
    new_tail = torch.cat([tail, u_raw], dim=1)[:, -(_K - 1):, :]
    return residual(x, out), RGLRUState(h=hs[:, -1], conv_tail=new_tail)


def rglru_decode_step(p, x: torch.Tensor, state: RGLRUState, cfg
                      ) -> Tuple[torch.Tensor, RGLRUState]:
    """One-token step. x: (B, d)."""
    h_in = rms_norm(x, p["norm"])
    u_raw = h_in @ whole(p["w_in"], (0,))                    # (B, W)
    gate = F.gelu(h_in @ whole(p["w_gate"], (0,)), approximate="tanh")
    window = torch.cat([state.conv_tail, u_raw[:, None, :]], dim=1)
    u = torch.sum(window.float() * p["conv_w"].float()[None], dim=1) \
        + p["conv_b"].float()
    u = u.to(x.dtype)
    a, b = _gates(p, u)
    h = a * state.h + b
    out = (h.to(x.dtype) * gate) @ whole(p["w_out"], (1,))
    return x + out, RGLRUState(h=h, conv_tail=window[:, 1:, :])
