"""mixtral-8x22b [moe] — 56L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=32768, MoE 8 experts top-2, SWA [arXiv:2401.04088].
TP-MoE sharding (8 experts don't divide the 16-way model axis — the
per-expert ffn dim shards instead; see DESIGN.md §3.2).
The same values as the reference's ``repro/configs/mixtral_8x22b.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x22b", family="moe",
    n_layers=56, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=32768,
    n_experts=8, top_k=2, window=4096, grad_accum=8,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="mixtral-8x22b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, n_experts=4, top_k=2,
        window=32, remat="none")
