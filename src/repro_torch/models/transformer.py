"""Model assembly.  Port of :mod:`repro.models.transformer`, every family:

* ``dense``  — GQA decoder (smollm, h2o-danube (sliding window), internlm2,
               mistral-large)
* ``moe``    — GQA decoder with an MoE FFN (mixtral (sliding window),
               qwen3-moe), its load-balancing aux loss in ``train_loss``
* ``vlm``    — the dense decoder with patch embeddings prepended (internvl2;
               the ViT frontend is a stub, ``batch["patches"]``)
* ``encdec`` — a bidirectional encoder over frame embeddings and a decoder
               with cross attention (seamless-m4t; the audio frontend is a
               stub, ``batch["frames"]``)
* ``hybrid`` — RG-LRU ⊕ local attention in units of (rec, rec, attn), then
               the trailing recurrent layers (recurrentgemma)
* ``ssm``    — a stack of Mamba blocks (falcon-mamba)

    model = Model(cfg, device=dev).init(generator)
    model.train_loss(batch)                → scalar loss
    model.prefill(batch)                   → last-position logits
    model.decode_step(cache, batch)        → (cache, logits)

``Model`` is an ``nn.Module`` whose parameters carry the reference tree's
names (``layers.3.attn.wq``, ``units.3.r0.w_in``, ``dec_layers.1.cross.wo``,
``layers.0.moe.w1``), each in its ``ParamDef`` dtype;
``convert.model_params_from_numpy`` maps the reference's tree onto them.
The reference's ``lax.scan`` over layers is a Python loop here.  The
full-sequence path reaches the hand-written kernels: ``flash_attention`` in
every causal self-attention layer (the decoders of every family but ssm),
``rglru_scan`` in every RG-LRU layer and ``ssm_scan`` in every Mamba layer.
The encoder's and the cross attention are non-causal; the reference has no
Pallas kernel for them, and they stay plain PyTorch (``_attn_bidir``).
``batch`` layouts per family come from ``data.family_batch``.

On a mesh.  ``Model(cfg, rules=...)`` (a ``layers.ShardingRules``; None,
the default, is off-mesh and changes nothing) runs on DTensor parameters
and inputs (``launch/sharded.py`` places them) and redistributes its
activations at the reference's sites (``layers.constrain``): the
embedded and each layer's output stream on ("batch", "seq_sp", None),
the queries on ("batch", None, "heads_act", None) and the SwiGLU hidden
on ("batch", None, "ffn_act").  ``flash_attention`` runs on each rank's
local heads (``attention.flash_attention``), as do the encoder's and the
cross attention (``_attn_bidir``), and a decode step writes the new key,
value and position into the local shard of a cache that is sharded over
its batch and slots, and the ssm and hybrid states into theirs
(``_put``); the encdec decoder's cross attention over the slot-sharded
``cross_k``/``cross_v`` reduces over the ranks as the self-attention's
does (``attention.attn_decode``).  Every family runs on a mesh: moe
routes on each rank's groups (``moe.moe_ffn``), and the scans run on each
rank's channels (``ssm.linear_scan``).

Training: the parameters track no gradients until a trainer opts in with
``model.requires_grad_(True)``, so serving builds no autograd graph.  Where
a graph is built, ``cfg.remat`` checkpoints one layer (one hybrid unit) of
the backbone, the encoder and the encdec decoder, the reference's four
``_remat`` sites, with ``torch.utils.checkpoint`` (non-reentrant): "none"
saves everything, "full" recomputes each layer's forward in the backward
(its kernels launch twice), "dots" saves the outputs of the matrix
products without batch dimensions (``aten.mm``/``addmm``, as JAX's
``checkpoint_dots_with_no_batch_dims``) and recomputes the rest.
"""

from __future__ import annotations

import functools
import math
from typing import Dict

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils import checkpoint as ckpt

from ..device import resolve_device
from .attention import attn_decode, flash_attention, local_heads
from .config import ModelConfig
from .layers import (ParamDef, Params, constrain, gather_seq, init_leaf,
                     register_params, residual, rms_norm, rotary,
                     shard_range, softmax_cross_entropy, swiglu, whole_grad)
from .moe import moe_defs, moe_ffn
from .rglru import RGLRUState, rglru_block, rglru_decode_step, rglru_defs
from .ssm import MambaState, mamba_block, mamba_decode_step, mamba_defs

FAMILIES = ("dense", "moe", "ssm", "hybrid", "encdec", "vlm")
SEQ = ("batch", "seq_sp", None)       # the residual stream between layers

# the products "dots" saves: matrix products with no batch dimensions
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return ckpt.CheckpointPolicy.MUST_SAVE if op in _DOTS \
        else ckpt.CheckpointPolicy.PREFER_RECOMPUTE


_DOTS_CONTEXT = functools.partial(ckpt.create_selective_checkpoint_contexts,
                                  _save_dots)


def _attn_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    """Head-major projections; the residual output wo is scaled by
    1/√(2L) (GPT-2 init), as in the reference."""
    d, H, KV, hd = cfg.d_model, cfg.n_heads, cfg.n_kv, cfg.hd
    res = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    return {
        "ln": ParamDef((d,), init="ones", logical=("embed",)),
        "wq": ParamDef((d, H, hd), init="scaled", fan_in=d,
                       logical=("embed", "heads", None)),
        "wk": ParamDef((d, KV, hd), init="scaled", fan_in=d,
                       logical=("embed", "kv", None)),
        "wv": ParamDef((d, KV, hd), init="scaled", fan_in=d,
                       logical=("embed", "kv", None)),
        "wo": ParamDef((H, hd, d), init="scaled", scale=res, fan_in=H * hd,
                       logical=("heads", None, "embed")),
    }


def _mlp_defs(cfg: ModelConfig) -> Dict[str, ParamDef]:
    d, ff = cfg.d_model, cfg.d_ff
    res = 1.0 / math.sqrt(2.0 * max(cfg.n_layers, 1))
    return {
        "ln": ParamDef((d,), init="ones", logical=("embed",)),
        "w1": ParamDef((d, ff), init="scaled", logical=("embed", "ffn")),
        "w3": ParamDef((d, ff), init="scaled", logical=("embed", "ffn")),
        "w2": ParamDef((ff, d), init="scaled", scale=res,
                       logical=("ffn", "embed")),
    }


class Model(nn.Module):
    """The model's parameters (uninitialised until :meth:`init` or
    ``load_state_dict``) and its forward functions."""

    def __init__(self, cfg: ModelConfig, device=None, rules=None):
        super().__init__()
        if cfg.family not in FAMILIES:
            raise ValueError(f"unknown model family {cfg.family!r}")
        self.cfg = cfg
        self.rules = rules
        device = resolve_device(device)
        d, Vp = cfg.d_model, cfg.padded_vocab
        register_params(self, {
            "embed": ParamDef((Vp, d), init="normal",
                              logical=("vocab", "embed")),
            "final_norm": ParamDef((d,), init="ones", logical=("embed",)),
            **({} if cfg.tie_embeddings else
               {"unembed": ParamDef((d, Vp), init="scaled",
                                    logical=("embed", "vocab"))}),
            **({"enc_norm": ParamDef((d,), init="ones", logical=("embed",))}
               if cfg.family == "encdec" else {})}, device)

        def stack(blocks, n):
            return nn.ModuleList(
                nn.ModuleDict({k: Params(defs, device) for k, defs in blocks.items()})
                for _ in range(n))

        if cfg.family == "ssm":
            self.layers = nn.ModuleList(Params(mamba_defs(cfg), device)
                                        for _ in range(cfg.n_layers))
        elif cfg.family == "hybrid":
            unit = {"r0": rglru_defs(cfg), "r0_mlp": _mlp_defs(cfg),
                    "r1": rglru_defs(cfg), "r1_mlp": _mlp_defs(cfg),
                    "a": _attn_defs(cfg), "a_mlp": _mlp_defs(cfg)}
            n_units = cfg.n_layers // 3
            self.units = stack(unit, n_units)
            self.n_tail = cfg.n_layers - 3 * n_units
            for i in range(self.n_tail):
                setattr(self, f"tail_r{i}", Params(rglru_defs(cfg), device))
                setattr(self, f"tail_r{i}_mlp", Params(_mlp_defs(cfg), device))
        elif cfg.family == "encdec":
            self.enc_layers = stack({"attn": _attn_defs(cfg),
                                     "mlp": _mlp_defs(cfg)}, cfg.enc_layers)
            self.dec_layers = stack({"attn": _attn_defs(cfg),
                                     "cross": _attn_defs(cfg),
                                     "mlp": _mlp_defs(cfg)}, cfg.n_layers)
        else:  # dense / moe / vlm decoders
            ffn = ({"moe": moe_defs(cfg)} if cfg.family == "moe"
                   else {"mlp": _mlp_defs(cfg)})
            self.layers = stack({"attn": _attn_defs(cfg), **ffn}, cfg.n_layers)

    def param_defs(self) -> Dict[str, ParamDef]:
        """Every parameter's definition, by its name in ``named_parameters``."""
        return {f"{mod_name}.{k}" if mod_name else k: d
                for mod_name, mod in self.named_modules()
                for k, d in getattr(mod, "defs", {}).items()}

    def stacked_param_defs(self) -> Dict[str, ParamDef]:
        """The reference's tree of definitions, flattened with dots: the
        layers of a stack (``layers``, ``units``, ``enc_layers``,
        ``dec_layers``) as one def each with a leading ``layers`` dim
        (``layers.attn.wq`` of shape (L, d, H, hd)), the rest by name."""
        out: Dict[str, ParamDef] = {}
        counts: Dict[str, int] = {}
        for name, d in self.param_defs().items():
            parts = name.split(".")
            if len(parts) > 2 and parts[1].isdigit():
                key = ".".join(parts[:1] + parts[2:])
                counts[key] = counts.get(key, 0) + 1
                out[key] = d
            else:
                out[name] = d
        return {k: d.stacked(counts[k]) if k in counts else d
                for k, d in out.items()}

    def _constrain(self, x: torch.Tensor, logical) -> torch.Tensor:
        return constrain(x, logical, self.rules)

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
    def _attn_seq(self, p, x, positions, window: int, causal: bool = True):
        cfg = self.cfg
        B, S, d = x.shape
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        h = gather_seq(rms_norm(x, p["ln"]))
        q = (h @ p["wq"].reshape(d, H * hd)).view(B, S, H, hd)
        k = (h @ p["wk"].reshape(d, KV * hd)).view(B, S, KV, hd)
        v = (h @ p["wv"].reshape(d, KV * hd)).view(B, S, KV, hd)
        q, k = rotary(q, k, positions)
        q = self._constrain(q, ("batch", None, "heads_act", None))
        if causal:
            # (B, H, S, hd) views of the (B, S, H, hd) projections; the
            # kernel writes its output in q's layout, so the transpose back
            # is free
            o = flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                v.transpose(1, 2), window=window)
            o = o.transpose(1, 2)
        else:
            o = _attn_bidir(q, k, v)
        return residual(x, o.reshape(B, S, H * hd)
                        @ p["wo"].reshape(H * hd, d))

    def _cross_seq(self, p, x, mem):
        """Cross attention of the decoder stream x (B, S, d) on the
        encoder's output mem (B, Sm, d): non-causal, no rotary."""
        cfg = self.cfg
        B, S, d = x.shape
        Sm = mem.shape[1]
        H, KV, hd = cfg.n_heads, cfg.n_kv, cfg.hd
        h = gather_seq(rms_norm(x, p["ln"]))
        mem = gather_seq(mem)
        q = (h @ p["wq"].reshape(d, H * hd)).view(B, S, H, hd)
        k = (mem @ p["wk"].reshape(d, KV * hd)).view(B, Sm, KV, hd)
        v = (mem @ p["wv"].reshape(d, KV * hd)).view(B, Sm, KV, hd)
        o = _attn_bidir(q, k, v)
        return residual(x, o.reshape(B, S, H * hd)
                        @ p["wo"].reshape(H * hd, d))

    def _mlp(self, p, x):
        """The SwiGLU block on (B, S, d) or, in decode, (B, d) (whose hidden
        the reference leaves unconstrained)."""
        hidden = (lambda t: self._constrain(t, ("batch", None, "ffn_act"))) \
            if x.dim() == 3 else None
        return residual(x, swiglu(gather_seq(rms_norm(x, p["ln"])), p["w1"],
                                  p["w3"], p["w2"], hidden))

    def _moe(self, p, x):
        """The MoE block on (B, S, d) → (x', aux loss)."""
        y, aux = moe_ffn(p, gather_seq(rms_norm(x, p["ln"])), self.cfg,
                         constrain=self._constrain)
        return residual(x, y), aux

    # ------------------------------------------------------- backbone (seq)
    def _remat_kwargs(self, x: torch.Tensor):
        """``torch.utils.checkpoint`` arguments for ``cfg.remat`` where an
        autograd graph is being built (grad mode on, and x or a parameter
        requires grad); None where nothing is checkpointed."""
        mode = self.cfg.remat
        if mode == "none" or not torch.is_grad_enabled() or not (
                x.requires_grad or self.embed.requires_grad):
            return None
        if mode == "full":
            return {"use_reentrant": False}
        if mode == "dots":
            return {"use_reentrant": False, "context_fn": _DOTS_CONTEXT}
        raise ValueError(f"unknown remat {mode!r}: none | dots | full")

    def _layers(self, layers, sublayers, x: torch.Tensor):
        """x through each of ``layers``, a layer being the functions
        ``sublayers(layer)`` applied in turn (a function may return (x,
        aux)); each layer checkpointed as ``_remat_kwargs`` says.  Without
        checkpointing the sublayers run here one by one, so that a layer's
        input is freed once its first sublayer returns.  → (x, the f32 sum
        of the aux losses)."""
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        remat = self._remat_kwargs(x)
        for layer in layers:
            fns = sublayers(layer)
            if remat is not None:
                x, a = ckpt.checkpoint(_through, fns, x, **remat)
                aux = aux + a
                continue
            for fn in fns:
                x = fn(x)
                if isinstance(x, tuple):
                    x, a = x
                    aux = aux + a
        return x, aux

    def backbone(self, x: torch.Tensor, positions: torch.Tensor):
        """Full-sequence forward. x: (B, S, d) embedded → ((B, S, d), the
        f32 sum of the layers' aux losses, 0 but for moe)."""
        cfg = self.cfg

        def seq(x):
            return self._constrain(x, SEQ)

        if cfg.family == "ssm":
            return self._layers(
                self.layers, lambda p: (lambda x: mamba_block(p, x, cfg), seq), x)
        if cfg.family == "hybrid":
            def unit(u):
                return (lambda x: rglru_block(u["r0"], x, cfg),
                        lambda x: self._mlp(u["r0_mlp"], x),
                        lambda x: rglru_block(u["r1"], x, cfg),
                        lambda x: self._mlp(u["r1_mlp"], x),
                        lambda x: self._attn_seq(u["a"], x, positions,
                                                 cfg.local_window),
                        lambda x: self._mlp(u["a_mlp"], x), seq)

            x, aux = self._layers(self.units, unit, x)
            for rec, mlp in self._tails():
                x = self._mlp(mlp, rglru_block(rec, x, cfg))
            return x, aux

        # dense / moe / vlm decoders
        def layer(lp):
            ffn = (lambda x: self._moe(lp["moe"], x)) if cfg.family == "moe" \
                else (lambda x: self._mlp(lp["mlp"], x))
            return (lambda x: self._attn_seq(lp["attn"], x, positions,
                                             cfg.window), ffn, seq)

        return self._layers(self.layers, layer, x)

    def _encoder(self, frames: torch.Tensor) -> torch.Tensor:
        """The bidirectional encoder over frame embeddings (B, Sm, d)."""
        B, Sm, _ = frames.shape
        positions = torch.arange(Sm, device=frames.device).expand(B, Sm)
        x, _ = self._layers(self.enc_layers, lambda lp: (
            lambda x: self._attn_seq(lp["attn"], x, positions, 0, causal=False),
            lambda x: self._mlp(lp["mlp"], x)), frames)
        return rms_norm(x, self.enc_norm)

    def _decoder_ed(self, x, mem, positions) -> torch.Tensor:
        x, _ = self._layers(self.dec_layers, lambda lp: (
            lambda x: self._attn_seq(lp["attn"], x, positions, self.cfg.window),
            lambda x: self._cross_seq(lp["cross"], x, mem),
            lambda x: self._mlp(lp["mlp"], x)), x)
        return x

    def _forward(self, batch):
        """The full-sequence path → (x (B, S, d) before the final norm,
        aux loss).  encdec: the frames, rounded to bf16 as in the
        reference, through the encoder, then the decoder over the tokens."""
        x, positions = self._embed_batch(batch)
        if self.cfg.family == "encdec":
            mem = self._encoder(batch["frames"].to(torch.bfloat16))
            return self._decoder_ed(x, mem, positions), torch.zeros(
                (), dtype=torch.float32, device=x.device)
        return self.backbone(x, positions)

    # ------------------------------------------------------------- embed/out
    def _embed_batch(self, batch):
        """→ (x (B, S, d), positions (B, S)); vlm prepends the patch
        embeddings (B, n_patches, d) to the tokens'."""
        x = self._embed(batch["tokens"])
        if self.cfg.family == "vlm":
            x = torch.cat([batch["patches"].to(x.dtype), x], dim=1)
        B, S, _ = x.shape
        positions = torch.arange(S, device=x.device).expand(B, S)
        return self._constrain(x, SEQ), positions

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The tokens' rows of ``embed``.  A vocab-sharded DTensor table is
        read by ``F.embedding``, which each rank answers from its rows
        (the others masked, then one all-reduce of the activations), where
        indexing would all-gather the whole table at every step."""
        from torch.distributed.tensor import DTensor, Replicate, Shard
        w = self.embed
        if not isinstance(w, DTensor):
            return w[tokens]
        # FSDP: the table's model dim gathered first (its unshard)
        w = w.redistribute(w.device_mesh, tuple(
            Replicate() if p == Shard(1) else p for p in w.placements))
        x = F.embedding(tokens, w)
        # the lookup's masked partial sums take a gradient only whole
        return whole_grad(x.redistribute(x.device_mesh, tuple(
            Replicate() if p.is_partial() else p for p in x.placements)))

    def _logits(self, x: torch.Tensor) -> torch.Tensor:
        if self.cfg.tie_embeddings:
            return x @ self.embed.T
        return x @ self.unembed

    def train_loss(self, batch) -> torch.Tensor:
        """Token-mean cross entropy of ``batch`` (``data.family_batch``'s
        layout, with labels) plus 0.01 · the moe aux loss; vlm scores only
        the text positions.  On a mesh a sequence-sharded stream is
        gathered whole before the unembedding (``gather_seq``)."""
        x, aux = self._forward(batch)
        x = gather_seq(rms_norm(x, self.final_norm))
        labels = batch["labels"]
        if self.cfg.family == "vlm":
            x = x[:, -labels.shape[1]:]
        loss = softmax_cross_entropy(self._logits(x), labels, self.cfg.vocab)
        return loss + 0.01 * aux

    def prefill(self, batch) -> torch.Tensor:
        """Process a full prompt → last-position logits (B, V_padded).  As in
        the reference, no cache is built: ``launch.serve.generate`` decodes
        the prompt token by token."""
        x, _ = self._forward(batch)
        return self._logits(rms_norm(x[:, -1], self.final_norm))

    # --------------------------------------------------------------- caches
    def init_cache(self, batch_size: int, capacity: int) -> dict:
        """The decode state, laid out as the reference's.  ssm: per layer the
        scan state ``h`` (B, d_inner, N) f32 and the conv tail.  hybrid: per
        unit two recurrent states and a ring-buffered local-attention KV
        cache of Sc = min(capacity, local_window) slots, and the trailing
        layers' states.  The decoders of the other families: per layer a
        KV cache of Sc = min(capacity, window) ring slots with a window,
        ``capacity`` slots without one; encdec adds the cross-attention
        ``cross_k``/``cross_v`` of capacity // frame_ratio frames (zeros, as
        the reference's: prefill builds no cache).  ``kpos`` holds each
        slot's position (−1 = empty).  Conv tails and KV hold the model's
        dtype (bf16; the reference's cache is always bf16)."""
        cfg = self.cfg
        dev, dt = self.embed.device, self.dtype

        def z(*shape, dtype=dt):
            return torch.zeros(shape, dtype=dtype, device=dev)

        if cfg.family == "ssm":
            L, di = cfg.n_layers, cfg.dinner
            return {"h": z(L, batch_size, di, cfg.ssm_state, dtype=torch.float32),
                    "conv": z(L, batch_size, cfg.ssm_conv - 1, di)}
        KV, hd = cfg.n_kv, cfg.hd
        if cfg.family == "hybrid":
            n_units = len(self.units)
            w = cfg.lru_width or cfg.d_model
            sc = min(capacity, cfg.local_window)
            return {
                "h": z(n_units, 2, batch_size, w, dtype=torch.float32),
                "conv": z(n_units, 2, batch_size, 3, w),
                "k": z(n_units, batch_size, sc, KV, hd),
                "v": z(n_units, batch_size, sc, KV, hd),
                "kpos": torch.full((batch_size, sc), -1, dtype=torch.int32,
                                   device=dev),
                "tail_h": z(max(self.n_tail, 1), batch_size, w, dtype=torch.float32),
                "tail_conv": z(max(self.n_tail, 1), batch_size, 3, w),
            }
        sc = min(capacity, cfg.window) if cfg.window else capacity
        L = cfg.n_layers
        cache = {"k": z(L, batch_size, sc, KV, hd), "v": z(L, batch_size, sc, KV, hd),
                 "kpos": torch.full((batch_size, sc), -1, dtype=torch.int32,
                                    device=dev)}
        if cfg.family == "encdec":
            sm = capacity // cfg.frame_ratio
            cache["cross_k"] = z(L, batch_size, sm, KV, hd)
            cache["cross_v"] = z(L, batch_size, sm, KV, hd)
        return cache

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
        _write_slots(k_cache, slot, k[:, 0])
        _write_slots(v_cache, slot, v)
        o = attn_decode(q[:, 0], k_cache, v_cache, kpos, pos, window=window)
        return x + o.reshape(B, H * hd) @ p["wo"].reshape(H * hd, d)

    def _moe_dec(self, p, x):
        """The MoE block on a single-token batch (B, d), one dispatch group."""
        y, _ = moe_ffn(p, rms_norm(x, p["ln"])[:, None, :], self.cfg,
                       group_size=x.shape[0], constrain=self._constrain)
        return x + y[:, 0]

    def _cross_dec(self, p, x, xk, xv):
        """Cross attention of one token (B, d) on the cached frames'
        keys and values (B, Sm, KV, hd), all admissible."""
        cfg = self.cfg
        B, d = x.shape
        H, hd = cfg.n_heads, cfg.hd
        q = (rms_norm(x, p["ln"]) @ p["wq"].reshape(d, H * hd)).view(B, H, hd)
        Sm = xk.shape[1]
        kpos = torch.arange(Sm, device=x.device).expand(B, Sm)
        o = attn_decode(q, xk, xv, kpos, torch.full((B,), Sm, device=x.device))
        return x + o.reshape(B, H * hd) @ p["wo"].reshape(H * hd, d)

    def decode_step(self, cache: dict, batch) -> tuple:
        """One token for every sequence, batch = {"tokens": (B,), "pos": (B,)}
        → (cache, logits (B, V_padded)).  The cache is updated in place (the
        reference returns a new one)."""
        cfg = self.cfg
        tokens, pos = batch["tokens"], batch["pos"]
        x = self._embed(tokens)                              # (B, d)
        if cfg.family == "ssm":
            for i, p in enumerate(self.layers):
                x, st = mamba_decode_step(
                    p, x, MambaState(h=cache["h"][i], conv_tail=cache["conv"][i]),
                    cfg)
                _put(cache["h"], (i,), st.h)
                _put(cache["conv"], (i,), st.conv_tail)
            return cache, self._logits(rms_norm(x, self.final_norm))
        Sc = cache["k"].shape[2]
        if cfg.family == "hybrid":
            slot = (pos % Sc).long()
            _write_slots(cache["kpos"], slot, pos)
            for u, unit in enumerate(self.units):
                for i, r in enumerate(("r0", "r1")):
                    st = RGLRUState(h=cache["h"][u, i], conv_tail=cache["conv"][u, i])
                    x, st = rglru_decode_step(unit[r], x, st, cfg)
                    x = self._mlp(unit[f"{r}_mlp"], x)
                    _put(cache["h"], (u, i), st.h)
                    _put(cache["conv"], (u, i), st.conv_tail)
                x = self._attn_dec(unit["a"], x, cache["k"][u], cache["v"][u],
                                   cache["kpos"], pos, slot, cfg.local_window)
                x = self._mlp(unit["a_mlp"], x)
            for i, (rec, mlp) in enumerate(self._tails()):
                st = RGLRUState(h=cache["tail_h"][i], conv_tail=cache["tail_conv"][i])
                x, st = rglru_decode_step(rec, x, st, cfg)
                x = self._mlp(mlp, x)
                _put(cache["tail_h"], (i,), st.h)
                _put(cache["tail_conv"], (i,), st.conv_tail)
            return cache, self._logits(rms_norm(x, self.final_norm))
        # dense / moe / vlm / encdec decoders: ring slots with a window, else
        # the position, held at the last slot past the capacity
        slot = (pos % Sc if cfg.window > 0 else torch.clamp(pos, max=Sc - 1)).long()
        _write_slots(cache["kpos"], slot, pos)
        is_ed = cfg.family == "encdec"
        for i, lp in enumerate(self.dec_layers if is_ed else self.layers):
            x = self._attn_dec(lp["attn"], x, cache["k"][i], cache["v"][i],
                               cache["kpos"], pos, slot, cfg.window)
            if is_ed:
                x = self._cross_dec(lp["cross"], x, cache["cross_k"][i],
                                    cache["cross_v"][i])
            if cfg.family == "moe":
                x = self._moe_dec(lp["moe"], x)
            else:
                x = self._mlp(lp["mlp"], x)
        return cache, self._logits(rms_norm(x, self.final_norm))


def _write_slots(buf: torch.Tensor, slot: torch.Tensor,
                 value: torch.Tensor) -> None:
    """buf[b, slot[b]] = value[b] for every row b, in place (a cache
    (B, Sc, …) and its slot of each sequence).  A DTensor cache, sharded
    over its rows and slots, is written in its local shard: each rank
    writes the rows it holds whose slot falls in its slots."""
    from torch.distributed.tensor import DTensor, Replicate, Shard
    if not isinstance(buf, DTensor):
        rows = torch.arange(buf.shape[0], device=buf.device)
        buf[rows, slot] = value.to(buf.dtype)
        return
    mesh = buf.device_mesh
    # the rows' placements of the cache for the slot and the value, every
    # other mesh dim replicated
    rows_pl = tuple(p if p == Shard(0) else Replicate() for p in buf.placements)
    slot = slot.redistribute(mesh, rows_pl).to_local()
    value = value.redistribute(mesh, rows_pl).to_local()
    local = buf.to_local()
    first, _ = shard_range(mesh, buf.placements, 1, buf.shape[1])
    # every local row rewrites one local slot (its own where the slot is
    # this rank's, else its slot 0 with the value it holds): no host sync
    mine = (slot >= first) & (slot < first + local.shape[1])
    at = torch.where(mine, slot - first, 0)
    rows = torch.arange(local.shape[0], device=local.device)
    keep = mine.view((-1,) + (1,) * (local.dim() - 2))
    local[rows, at] = torch.where(keep, value.to(local.dtype), local[rows, at])


def _put(buf: torch.Tensor, at: tuple, value: torch.Tensor) -> None:
    """buf[at] = value in place, ``at`` leading indices of unsplit dims (a
    layer, a unit): a DTensor state (the ssm and hybrid caches, split over
    their batch rows and channels) is written in its local shard, the
    value laid out as buf[at] first."""
    from torch.distributed.tensor import DTensor, Shard
    if not isinstance(buf, DTensor):
        buf[at] = value
        return
    n = len(at)
    pl = tuple(Shard(p.dim - n) if isinstance(p, Shard) else p
               for p in buf.placements)
    if any(isinstance(p, Shard) and p.dim < 0 for p in pl):
        raise ValueError(f"_put: {buf.placements} split an indexed dim")
    buf.to_local()[at] = value.redistribute(buf.device_mesh, pl).to_local()


def _through(fns, x):
    """One checkpointed layer: x through ``fns`` in turn → (x, aux sum)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for fn in fns:
        x = fn(x)
        if isinstance(x, tuple):
            x, a = x
            aux = aux + a
    return x, aux


def _attn_bidir(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Non-causal GQA attention (the encoder's and the cross attention):
    q (B, Sq, H, hd), k and v (B, Sk, KV, hd) → (B, Sq, H, hd).  Scores and
    softmax in f32, the probabilities cast to q's dtype for the product with
    v, as the reference's unchunked ``_attn_bidir``.  On DTensors, on each
    rank's batch rows and heads (``attention.local_heads``)."""
    from torch.distributed.tensor import DTensor
    if isinstance(q, DTensor):
        return local_heads(_attn_bidir, q, k, v, 2)
    B, Sq, H, hd = q.shape
    KV = k.shape[2]
    qg = q.reshape(B, Sq, KV, H // KV, hd)
    s = torch.einsum("bqkgh,bskh->bkgqs", qg.float(), k.float()) / math.sqrt(hd)
    att = torch.softmax(s, dim=-1).to(q.dtype)
    o = torch.einsum("bkgqs,bskh->bqkgh", att, v.to(q.dtype))
    return o.reshape(B, Sq, H, hd)
