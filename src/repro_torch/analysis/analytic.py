"""Closed-form device-memory traffic of a step.  Port of
:mod:`repro.analysis.analytic`: the bytes one device moves per step when
the attention and the recurrences run as fused kernels (scores and state
blocks stay on chip).

* weights: read forward + re-read (remat) + read backward + gradient write
  (f32) + optimizer moments read and written (train); read once (prefill,
  decode)
* activations: ~6 residual-stream-sized tensors read or written per layer
  per pass
* attention: q/k/v/o traffic + K/V streamed once per query block (flash)
* ssm / rg: the recurrence's inputs and outputs (a, b, h) per layer
* logits / cross entropy and the embedding
* decode: the whole cache read and one slot written per emitted token

``analytic_collective_bytes`` is the port's own closed form of the bytes a
device sends in the step's collectives (the reference reads them from the
compiled HLO): Megatron's two all-reduces of the residual stream per layer
and pass over the model axis, and, in training, the gradients' all-reduce
over the data axes, each a ring moving 2·(n−1)/n of its tensor.
"""

from __future__ import annotations

from ..models.config import ModelConfig, ShapeConfig
from .roofline import H100

BF16 = 2
F32 = 4


def analytic_bytes(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                   model_axis: int = 16) -> float:
    """Estimated device-memory bytes per device per step."""
    P = cfg.param_count()
    L = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
    d = cfg.d_model
    V = cfg.padded_vocab

    if shape.kind == "decode":
        B_loc = max(shape.global_batch // (chips // model_axis), 1)
        total = P / chips * BF16                      # weights read once
        if cfg.family == "ssm":
            cache = cfg.n_layers * B_loc * cfg.dinner * cfg.ssm_state * F32
        else:
            sc = min(shape.seq_len, cfg.window or shape.seq_len)
            sc_loc = sc / model_axis
            cache = cfg.n_layers * B_loc * sc_loc * cfg.n_kv * cfg.hd * BF16 * 2
        total += cache * 2 + B_loc * V / chips * BF16  # read+write + logits
        return total

    tokens_loc = shape.seq_len * shape.global_batch / (chips // model_axis)
    passes = 3.0 if shape.kind == "train" else 1.0   # fwd + refwd + bwd
    w = P / chips * BF16 * passes
    if shape.kind == "train":
        w += P / chips * (F32 + 3 * F32)             # grads + moments r/w
    act = L * tokens_loc * d * BF16 * 6 * passes
    if cfg.family == "ssm":
        seqmix = cfg.n_layers * tokens_loc * cfg.dinner / model_axis \
            * cfg.ssm_state * F32 * 3 * passes       # a, b, h
    else:
        H_loc = max(cfg.n_heads / model_axis, 1)
        qkvo = (2 * H_loc + 2 * cfg.n_kv) * cfg.hd
        nq = max(shape.seq_len // cfg.attn_chunk, 1)
        window = cfg.window or (cfg.local_window if cfg.family == "hybrid"
                                else 0)
        kv_frac = min(1.0, window / shape.seq_len) if window else 1.0
        stream = cfg.n_kv * cfg.hd * (nq / 2) * kv_frac  # flash KV re-reads
        seqmix = cfg.n_layers * tokens_loc * (qkvo + stream) * BF16 * passes
    logits = tokens_loc * V / model_axis * (BF16 + F32) * passes \
        if shape.kind == "train" else \
        shape.global_batch / max(chips // model_axis, 1) * V * BF16
    emb = tokens_loc * d * BF16 * 2
    return w + act + seqmix + logits + emb


def kernel_memory_s(cfg: ModelConfig, shape: ShapeConfig, chips: int,
                    hbm_bw: float = H100.hbm_bw) -> float:
    return analytic_bytes(cfg, shape, chips) / hbm_bw


def analytic_collective_bytes(cfg: ModelConfig, shape: ShapeConfig,
                              chips: int, model_axis: int = 16) -> float:
    """Estimated bytes one device sends in the step's collectives."""
    dp = max(chips // model_axis, 1)
    L = cfg.n_layers + (cfg.enc_layers if cfg.family == "encdec" else 0)
    tokens_loc = (shape.global_batch if shape.kind == "decode"
                  else shape.seq_len * shape.global_batch) / dp
    passes = 3.0 if shape.kind == "train" else 1.0
    ring_tp = 2.0 * (model_axis - 1) / model_axis
    tp = 2 * L * tokens_loc * cfg.d_model * BF16 * passes * ring_tp
    grads = 0.0
    if shape.kind == "train" and dp > 1:
        grads = cfg.param_count() / model_axis * BF16 * 2.0 * (dp - 1) / dp
    return tp + grads
