"""internvl2-76b [vlm] — 80L d_model=8192 64H (GQA kv=8) d_ff=28672
vocab=128256 — InternViT + LLM backbone [arXiv:2404.16821].
ViT frontend is a stub: ``input_specs`` provides 256 precomputed patch
embeddings prepended to the text sequence.
The same values as the reference's ``repro/configs/internvl2_76b.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv=8, d_ff=28672, vocab=128256,
    n_patches=256, grad_accum=4,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internvl2-76b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, n_patches=8, grad_accum=1,
        remat="none")
