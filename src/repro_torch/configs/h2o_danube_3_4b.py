"""h2o-danube-3-4b [dense] — 24L d_model=3840 32H (GQA kv=8) d_ff=10240
vocab=32000 — llama+mistral mix, SWA [arXiv:2401.16818].
head_dim = 120 (3840/32). SWA window 4096 ⇒ long_500k runs.
The same values as the reference's ``repro/configs/h2o_danube_3_4b.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="h2o-danube-3-4b", family="dense",
    n_layers=24, d_model=3840, n_heads=32, n_kv=8, d_ff=10240, vocab=32000,
    window=4096, grad_accum=4,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="h2o-danube-3-4b-reduced", n_layers=2, d_model=64,
        n_heads=4, n_kv=2, d_ff=128, vocab=256, window=32, remat="none")
