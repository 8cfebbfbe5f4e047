"""internlm2-20b [dense] — 48L d_model=6144 48H (GQA kv=8) d_ff=16384
vocab=92544 [arXiv:2403.17297].
The same values as the reference's ``repro/configs/internlm2_20b.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384, vocab=92544, grad_accum=2,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="internlm2-20b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, remat="none")
