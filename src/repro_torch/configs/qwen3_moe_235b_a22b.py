"""qwen3-moe-235b-a22b [moe] — 94L d_model=4096 64H (GQA kv=4) moe_ff=1536
vocab=151936, MoE 128 experts top-8 [hf:Qwen/Qwen3-30B-A3B family].
EP sharding: 128 experts / 16-way model axis = 8 experts per shard.
head_dim=128 (as published; H·hd = 8192 ≠ d_model).
The same values as the reference's ``repro/configs/qwen3_moe_235b_a22b.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-moe-235b-a22b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv=4, head_dim=128,
    d_ff=1536, moe_ff=1536, vocab=151936, n_experts=128, top_k=8, grad_accum=4,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="qwen3-moe-235b-a22b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, head_dim=16, d_ff=96, moe_ff=96, vocab=256,
        n_experts=8, top_k=2, remat="none")
