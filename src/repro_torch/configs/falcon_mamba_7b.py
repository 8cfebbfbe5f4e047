"""falcon-mamba-7b [ssm] — 64L d_model=4096 (attention-free), vocab=65024,
ssm_state=16, conv 4, Mamba-1 blocks [arXiv:2410.05355]; d_inner = 2·d =
8192 and dt_rank = ⌈d/16⌉ = 256 (the config's defaults).  The same values
as the reference's ``repro/configs/falcon_mamba_7b.py``."""
import dataclasses

from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="falcon-mamba-7b", family="ssm",
    n_layers=64, d_model=4096, n_heads=1, n_kv=1, d_ff=0, vocab=65024,
    ssm_state=16, ssm_conv=4, grad_accum=4,
))


def reduced() -> ModelConfig:
    return dataclasses.replace(
        CONFIG, name="falcon-mamba-7b-reduced", n_layers=2, d_model=64,
        vocab=256, ssm_state=4, remat="none")
