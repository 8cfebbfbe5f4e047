"""Model and shape configuration.

Port of :mod:`repro.models.config`, kept as the port's own copy:
``ModelConfig`` covers every architecture family of the model zoo
(dense / moe / ssm / hybrid / encdec / vlm); ``ShapeConfig`` is one of the
four input shapes.  Concrete configs live in ``repro_torch/configs/<arch>.py``
and register themselves here.  The port's ``Model`` runs every family.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                    # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 0              # 0 → d_model // n_heads
    window: int = 0                # 0 → full attention; >0 → sliding window
    # MoE
    n_experts: int = 0
    top_k: int = 0
    moe_ff: int = 0                # per-expert ff width (0 → d_ff)
    # SSM (mamba1)
    ssm_state: int = 0
    ssm_conv: int = 4
    dt_rank: int = 0               # 0 → ceil(d_model/16)
    d_inner: int = 0               # 0 → 2·d_model
    # hybrid (recurrentgemma): pattern unit (rec, rec, attn); lru width
    lru_width: int = 0
    attn_every: int = 0            # every k-th layer is attention (rg: 3)
    local_window: int = 0          # rg local-attention window
    # enc-dec (seamless): encoder depth; frontend stub emits frame embeddings
    enc_layers: int = 0
    frame_ratio: int = 4           # encoder frames = seq // frame_ratio
    # vlm: patch embeddings prepended (stub frontend)
    n_patches: int = 0
    # numerics / memory knobs of the reference (kept so configs compare
    # field for field; the port's attention ignores attn_chunk)
    dtype: str = "bfloat16"
    remat: str = "full"            # none | dots | full
    scan_layers: bool = True
    grad_accum: int = 1            # microbatches per train step
    attn_chunk: int = 1024
    vocab_pad_to: int = 128
    tie_embeddings: bool = False
    capacity_factor: float = 1.25  # MoE token-dropping capacity
    moe_dispatch: str = "onehot"
    moe_group: int = 512           # tokens per dispatch group

    @property
    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def padded_vocab(self) -> int:
        p = self.vocab_pad_to
        return ((self.vocab + p - 1) // p) * p

    @property
    def dinner(self) -> int:
        return self.d_inner or 2 * self.d_model

    @property
    def dtrank(self) -> int:
        return self.dt_rank or -(-self.d_model // 16)

    @property
    def is_subquadratic(self) -> bool:
        """Can this arch serve 500k-token contexts? (SSM / hybrid / SWA.)"""
        return self.family in ("ssm", "hybrid") or self.window > 0

    def param_count(self) -> int:
        """Closed-form parameter count, as the reference computes it, field
        for field.  For the ssm family that form leaves out each layer's
        ``conv_b`` and the ``final_norm``: n_layers·d_inner + d_model fewer
        than the model holds."""
        d, hd = self.d_model, self.hd
        emb = self.padded_vocab * d * (1 if self.tie_embeddings else 2)
        if self.family == "ssm":
            di, N, dr = self.dinner, self.ssm_state, self.dtrank
            per = (d * 2 * di + di * self.ssm_conv + di * (dr + 2 * N)
                   + dr * di + di + di * N + di + di * d + d)
            return emb + self.n_layers * per
        attn = d * (self.n_heads * hd) + d * (self.n_kv * hd) * 2 \
            + (self.n_heads * hd) * d
        if self.family == "moe":
            ff_w = self.moe_ff or self.d_ff
            mlp = self.n_experts * 3 * d * ff_w + d * self.n_experts
        else:
            mlp = 3 * d * self.d_ff
        per = attn + mlp + 2 * d
        if self.family == "hybrid":
            w = self.lru_width or d
            rec = (d * 2 * w + w * self.ssm_conv + 2 * w * 2
                   + w * 2 * w + w + w * d)
            n_attn = self.n_layers // (self.attn_every or 3)
            n_rec = self.n_layers - n_attn
            return emb + n_attn * per + n_rec * (rec + 3 * d * self.d_ff + 2 * d)
        total = self.n_layers * per
        if self.family == "encdec":
            enc = self.enc_layers * (attn + 3 * d * self.d_ff + 2 * d)
            total += enc + self.n_layers * (attn + d)
        return emb + total

    def active_param_count(self) -> int:
        """Parameters active per token (moe: top_k of the n_experts)."""
        if self.family != "moe" or not self.n_experts:
            return self.param_count()
        d = self.d_model
        ff_w = self.moe_ff or self.d_ff
        dense_moe = self.n_experts * 3 * d * ff_w
        active_moe = self.top_k * 3 * d * ff_w
        return self.param_count() - self.n_layers * (dense_moe - active_moe)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4_096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32_768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524_288, 1, "decode"),
}

_REGISTRY: Dict[str, ModelConfig] = {}


def register(cfg: ModelConfig) -> ModelConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        _load_all()
    return _REGISTRY[name]


def all_configs() -> Dict[str, ModelConfig]:
    _load_all()
    return dict(_REGISTRY)


def _load_all() -> None:
    import importlib
    import pkgutil

    import repro_torch.configs as pkg
    for m in pkgutil.iter_modules(pkg.__path__):
        importlib.import_module(f"repro_torch.configs.{m.name}")


def cell_is_applicable(cfg: ModelConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """Whether (arch × shape) is a runnable cell: long_500k needs a
    subquadratic arch, as in the reference."""
    if shape.name == "long_500k" and not cfg.is_subquadratic:
        return False, "long_500k skipped: pure full-attention arch (O(S²) KV)"
    return True, ""


def resolve_config(name: str) -> ModelConfig:
    """A registered config by name; ``<arch>-reduced`` is the arch module's
    ``reduced()`` (the reference's ``launch/train.py`` ``_resolve_config``)."""
    if name.endswith("-reduced"):
        import importlib
        mod = name[: -len("-reduced")].replace("-", "_")
        return importlib.import_module(f"repro_torch.configs.{mod}").reduced()
    return get_config(name)

