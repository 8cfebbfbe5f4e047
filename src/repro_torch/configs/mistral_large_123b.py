"""mistral-large-123b [dense] — 88L d_model=12288 96H (GQA kv=8)
d_ff=28672 vocab=32768 [hf:mistralai/Mistral-Large-Instruct-2407].
Pure full attention ⇒ long_500k skipped (DESIGN.md §4).
The same values as the reference's ``repro/configs/mistral_large_123b.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mistral-large-123b", family="dense",
    n_layers=88, d_model=12288, n_heads=96, n_kv=8, d_ff=28672, vocab=32768,
    grad_accum=8,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mistral-large-123b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, grad_accum=1, remat="none")
