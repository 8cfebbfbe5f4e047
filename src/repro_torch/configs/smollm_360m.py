"""smollm-360m [dense] — 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small [hf:HuggingFaceTB/SmolLM family].
15 heads don't divide the 16-way model axis → heads replicate, ffn/vocab
shard (automatic divisibility fallback).
The same values as the reference's ``repro/configs/smollm_360m.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv=5, d_ff=2560, vocab=49152, grad_accum=2,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="smollm-360m-reduced", n_layers=2, d_model=60,
        n_heads=3, n_kv=1, d_ff=128, vocab=256, remat="none")
