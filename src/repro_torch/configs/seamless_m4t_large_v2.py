"""seamless-m4t-large-v2 [audio] — 24L d_model=1024 16H (GQA kv=16)
d_ff=8192 vocab=256206 — enc-dec, multimodal [arXiv:2308.11596].
Frontend stub: ``input_specs`` provides precomputed frame embeddings
(frames = seq // 4). vocab padded 256206 → 256256 for 16-way TP.
The same values as the reference's ``repro/configs/seamless_m4t_large_v2.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="seamless-m4t-large-v2", family="encdec",
    n_layers=24, enc_layers=24, d_model=1024, n_heads=16, n_kv=16,
    d_ff=8192, vocab=256206, frame_ratio=4, grad_accum=4,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="seamless-m4t-large-v2-reduced", n_layers=2,
        enc_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128, vocab=256,
        remat="none")
