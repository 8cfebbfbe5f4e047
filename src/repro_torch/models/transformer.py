"""Model assembly.  Port of :mod:`repro.models.transformer` for two
families: ``hybrid`` (recurrentgemma: RG-LRU ⊕ local attention in units of
(rec, rec, attn), then the trailing recurrent layers) and ``ssm``
(falcon-mamba: a stack of Mamba blocks).

    model = Model(cfg, device=dev).init(generator)
    model.train_loss(batch)                → scalar loss
    model.prefill(batch)                   → last-position logits
    model.decode_step(cache, batch)        → (cache, logits)

``Model`` is an ``nn.Module`` whose parameters carry the reference tree's
names (``units.3.r0.w_in``, ``tail_r0_mlp.w2``, ``layers.7.in_proj``), each
in its ``ParamDef`` dtype; ``convert.model_params_from_numpy`` maps the
reference's tree onto them.  The reference's ``lax.scan`` over units or
layers is a Python loop here.  The full-sequence path reaches the
hand-written kernels: ``rglru_scan`` in every RG-LRU layer,
``flash_attention`` in every attention layer and ``ssm_scan`` in every
Mamba layer.  Other families raise ``NotImplementedError``.
"""

from __future__ import annotations

import math
from typing import Dict

import torch
from torch import nn

from ..device import resolve_device
from ..kernels import ops
from .attention import attn_decode
from .config import ModelConfig
from .layers import (ParamDef, Params, init_leaf, register_params, rms_norm,
                     rotary, softmax_cross_entropy, swiglu)
from .rglru import RGLRUState, rglru_block, rglru_decode_step, rglru_defs
from .ssm import MambaState, mamba_block, mamba_decode_step, mamba_defs

_NOT_PORTED = {
    "dense": "the dense family is still to port: ROADMAP queue 1 item 10",
    "moe": "the moe family is still to port: ROADMAP queue 1 item 10",
    "encdec": "the encdec family is still to port: ROADMAP queue 1 item 10",
    "vlm": "the vlm family is still to port: ROADMAP queue 1 item 10",
}


def _attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Head-major projections; the residual output wo is scaled by
    1/√(2L) (GPT-2 init), as in the reference."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    res = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    return {
        "ln": ParamDef((d,), init="ones"),
        "wq": ParamDef((d, H, hd), init="scaled", fan_in=d),
        "wk": ParamDef((d, KV, hd), init="scaled", fan_in=d),
        "wv": ParamDef((d, KV, hd), init="scaled", fan_in=d),
        "wo": ParamDef((H, hd, d), init="scaled", scale=res, fan_in=H * hd),
    }


def _mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    res = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    return {
        "ln": ParamDef((d,), init="ones"),
        "w1": ParamDef((d, ff), init="scaled"),
        "w3": ParamDef((d, ff), init="scaled"),
        "w2": ParamDef((ff, d), init="scaled", scale=res),
    }


class Model(nn.Module):
    """The model's parameters (uninitialised until :meth:`init` or
    ``load_state_dict``) and its forward functions."""

    def __init__(self, cfg: ModelConfig, device=None):
        super().__init__()
        if cfg.family not in ("hybrid", "ssm"):
            raise NotImplementedError(_NOT_PORTED.get(
                cfg.family, f"unknown model family {cfg.family!r}"))
        self.cfg = cfg
        device = resolve_device(device)
        d, Vp = cfg.d_model, cfg.padded_vocab
        register_params(self, {
            "embed": ParamDef((Vp, d), init="normal"),
            "final_norm": ParamDef((d,), init="ones"),
            **({} if cfg.tie_embeddings else
               {"unembed": ParamDef((d, Vp), init="scaled")})}, device)
        if cfg.family == "ssm":
            self.layers = nn.ModuleList(Params(mamba_defs(cfg), device)
                                        for _ in range(cfg.n_layers))
            return
        unit = {"r0": rglru_defs(cfg), "r0_mlp": _mlp_defs(cfg),
                "r1": rglru_defs(cfg), "r1_mlp": _mlp_defs(cfg),
                "a": _attn_defs(cfg), "a_mlp": _mlp_defs(cfg)}
        n_units = cfg.n_layers // 3
        self.units = nn.ModuleList(
            nn.ModuleDict({k: Params(defs, device) for k, defs in unit.items()})
            for _ in range(n_units))
        self.n_tail = cfg.n_layers - 3 * n_units
        for i in range(self.n_tail):
            setattr(self, f"tail_r{i}", Params(rglru_defs(cfg), device))
            setattr(self, f"tail_r{i}_mlp", Params(_mlp_defs(cfg), device))

    def param_defs(self) -> Dict[str, ParamDef]:
        """Every parameter's definition, by its name in ``named_parameters``."""
        return {f"{mod_name}.{k}" if mod_name else k: d
                for mod_name, mod in self.named_modules()
                for k, d in getattr(mod, "defs", {}).items()}

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "Model":
        """Draw every parameter from ``generator`` (on the model's device),
        in the order of ``named_parameters``; returns the model."""
        defs = self.param_defs()
        for name, p in self.named_parameters():
            p.copy_(init_leaf(defs[name], generator))
        return self

    @property
    def dtype(self) -> torch.dtype:
        """The activations' dtype: the embedding's (bf16, or f32 when the
        parameters were cast)."""
        return self.embed.dtype

    def _tails(self):
        return [(getattr(self, f"tail_r{i}"), getattr(self, f"tail_r{i}_mlp"))
                for i in range(self.n_tail)]

    # -------------------------------------------------------- sublayers
    def _attn_seq(self, p, x, positions, window: int):
        cfg = self.cfg
        B, S, d = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        h = rms_norm(x, p["ln"])
        q = (h @ p["wq"].reshape(d, H * hd)).view(B, S, H, hd)
        k = (h @ p["wk"].reshape(d, KV * hd)).view(B, S, KV, hd)
        v = (h @ p["wv"].reshape(d, KV * hd)).view(B, S, KV, hd)
        q, k = rotary(q, k, positions)
        # (B, H, S, hd) views of the (B, S, H, hd) projections; the kernel
        # writes its output in q's layout, so the transpose back is free
        o = ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), window=window)
        o = o.transpose(1, 2).reshape(B, S, H * hd)
        return x + o @ p["wo"].reshape(H * hd, d)

    def _mlp(self, p, x):
        """The SwiGLU block on (B, S, d) or, in decode, (B, d)."""
        return x + swiglu(rms_norm(x, p["ln"]), p["w1"], p["w3"], p["w2"])

    # ------------------------------------------------------- backbone (seq)
    def backbone(self, x: torch.Tensor, positions: torch.Tensor) -> torch.Tensor:
        """Full-sequence forward. x: (B, S, d) embedded → (B, S, d)."""
        cfg = self.cfg
        if cfg.family == "ssm":
            for p in self.layers:
                x = mamba_block(p, x, cfg)
            return x
        for unit in self.units:
            for r in ("r0", "r1"):
                x = rglru_block(unit[r], x, cfg)
                x = self._mlp(unit[f"{r}_mlp"], x)
            x = self._attn_seq(unit["a"], x, positions, cfg.local_window)
            x = self._mlp(unit["a_mlp"], x)
        for rec, mlp in self._tails():
            x = self._mlp(mlp, rglru_block(rec, x, cfg))
        return x

    # ------------------------------------------------------------- embed/out
    def _embed_batch(self, batch):
        """→ (x (B, S, d), positions (B, S))."""
        tokens = batch["tokens"]
        x = self.embed[tokens]
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        return x, positions

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ self.embed.T
        return x @ self.unembed

    def train_loss(self, batch) -> torch.Tensor:
        """Token-mean cross entropy of ``batch`` = {"tokens", "labels"}
        (B, S); the hybrid and ssm families have no auxiliary loss."""
        x, positions = self._embed_batch(batch)
        x = rms_norm(self.backbone(x, positions), self.final_norm)
        return softmax_cross_entropy(self._logits(x), batch["labels"],
                                     self.cfg.vocab)

    def prefill(self, batch) -> torch.Tensor:
        """Process a full prompt → last-position logits (B, V_padded).  As in
        the reference, no cache is built: ``launch.serve.generate`` decodes
        the prompt token by token."""
        x, positions = self._embed_batch(batch)
        x = self.backbone(x, positions)
        return self._logits(rms_norm(x[:, -1], self.final_norm))

    # --------------------------------------------------------------- caches
    def init_cache(self, batch_size: int, capacity: int) -> dict:
        """The decode state, laid out as the reference's.  ssm: per layer the
        scan state ``h`` (B, d_inner, N) f32 and the conv tail.  hybrid: per
        unit two recurrent states and a ring-buffered local-attention KV
        cache of Sc = min(capacity, local_window) slots with their positions
        (``kpos``, −1 = empty), and the trailing layers' states.  Conv tails
        and KV hold the model's dtype (bf16; the reference's cache is always
        bf16)."""
        cfg = self.cfg
        dev, dt = self.embed.device, self.dtype
        if cfg.family == "ssm":
            L, di = cfg.n_layers, cfg.dinner
            return {
                "h": torch.zeros((L, batch_size, di, cfg.ssm_state),
                                 dtype=torch.float32, device=dev),
                "conv": torch.zeros((L, batch_size, cfg.ssm_conv - 1, di),
                                    dtype=dt, device=dev),
            }
        n_units = len(self.units)
        w = cfg.lru_width or cfg.d_model
        sc = min(capacity, cfg.local_window)

        def z(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        return {
            "h": z(n_units, 2, batch_size, w, dtype=torch.float32),
            "conv": z(n_units, 2, batch_size, 3, w),
            "k": z(n_units, batch_size, sc, cfg.n_kv, cfg.hd),
            "v": z(n_units, batch_size, sc, cfg.n_kv, cfg.hd),
            "kpos": torch.full((batch_size, sc), -1, dtype=torch.int32,
                               device=dev),
            "tail_h": z(max(self.n_tail, 1), batch_size, w, dtype=torch.float32),
            "tail_conv": z(max(self.n_tail, 1), batch_size, 3, w),
        }

    # ---------------------------------------------------------- decode step
    def _attn_dec(self, p, x, k_cache, v_cache, kpos, pos, slot, window):
        """x: (B, d); caches (B, Sc, KV, hd), written in place at ``slot``."""
        cfg = self.cfg
        B, d = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        h = rms_norm(x, p["ln"])
        q = (h @ p["wq"].reshape(d, H * hd)).view(B, 1, H, hd)
        k = (h @ p["wk"].reshape(d, KV * hd)).view(B, 1, KV, hd)
        v = (h @ p["wv"].reshape(d, KV * hd)).view(B, KV, hd)
        q, k = rotary(q, k, pos[:, None])
        # an indexed write: the same values as the reference's one-hot blend
        # (which can differ only in the sign of a zero)
        rows = torch.arange(B, device=x.device)
        k_cache[rows, slot] = k[:, 0].to(k_cache.dtype)
        v_cache[rows, slot] = v.to(v_cache.dtype)
        o = attn_decode(q[:, 0], k_cache, v_cache, kpos, pos, window=window)
        return x + o.reshape(B, H * hd) @ p["wo"].reshape(H * hd, d)

    def decode_step(self, cache: dict, batch) -> tuple:
        """One token for every sequence, batch = {"tokens": (B,), "pos": (B,)}
        → (cache, logits (B, V_padded)).  The cache is updated in place (the
        reference returns a new one)."""
        cfg = self.cfg
        tokens, pos = batch["tokens"], batch["pos"]
        x = self.embed[tokens]                               # (B, d)
        if cfg.family == "ssm":
            for i, p in enumerate(self.layers):
                x, st = mamba_decode_step(
                    p, x, MambaState(h=cache["h"][i], conv_tail=cache["conv"][i]),
                    cfg)
                cache["h"][i] = st.h
                cache["conv"][i] = st.conv_tail
            return cache, self._logits(rms_norm(x, self.final_norm))
        Sc = cache["k"].shape[2]
        slot = (pos % Sc).long()
        rows = torch.arange(x.shape[0], device=x.device)
        cache["kpos"][rows, slot] = pos.to(torch.int32)
        for u, unit in enumerate(self.units):
            for i, r in enumerate(("r0", "r1")):
                st = RGLRUState(h=cache["h"][u, i], conv_tail=cache["conv"][u, i])
                x, st = rglru_decode_step(unit[r], x, st, cfg)
                x = self._mlp(unit[f"{r}_mlp"], x)
                cache["h"][u, i] = st.h
                cache["conv"][u, i] = st.conv_tail
            x = self._attn_dec(unit["a"], x, cache["k"][u], cache["v"][u],
                               cache["kpos"], pos, slot, cfg.local_window)
            x = self._mlp(unit["a_mlp"], x)
        for i, (rec, mlp) in enumerate(self._tails()):
            st = RGLRUState(h=cache["tail_h"][i], conv_tail=cache["tail_conv"][i])
            x, st = rglru_decode_step(rec, x, st, cfg)
            x = self._mlp(mlp, x)
            cache["tail_h"][i] = st.h
            cache["tail_conv"][i] = st.conv_tail
        return cache, self._logits(rms_norm(x, self.final_norm))
