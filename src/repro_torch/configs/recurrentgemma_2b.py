"""recurrentgemma-2b [hybrid] — 26L d_model=2560 10H (MQA kv=1) d_ff=7680
vocab=256000 — RG-LRU + local attention, pattern (rec, rec, attn)
[arXiv:2402.19427]. head_dim=256, lru_width=2560, local window 2048.
26 layers = 8 (rec, rec, attn) units + 2 trailing rec layers.  The same
values as the reference's ``repro/configs/recurrentgemma_2b.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="recurrentgemma-2b", family="hybrid",
    n_layers=26, d_model=2560, n_heads=10, n_kv=1, d_ff=7680, vocab=256000,
    lru_width=2560, attn_every=3, local_window=2048, grad_accum=4,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="recurrentgemma-2b-reduced", n_layers=5, d_model=64,
        n_heads=2, n_kv=1, d_ff=128, vocab=256, lru_width=64,
        local_window=32, remat="none")
