"""End-to-end training run of the PyTorch port (the analogue of
``examples/train_adaptive.py``): train lm-100m for a few hundred steps
with the paper's adaptive-sampling engine controlling gradient
accumulation, plus checkpointing and deterministic data.

The default sizes are small (40 steps of 8 × 64 tokens); ``--steps 300
--seq 128`` is the full run.

    PYTHONPATH=src python examples/train_adaptive_torch.py --steps 2 --batch 4 --seq 16 --micro 2 --device cpu
    PYTHONPATH=src python examples/train_adaptive_torch.py --steps 300 --seq 128   # the card
"""

import argparse
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))

from repro_torch.device import resolve_device
from repro_torch.launch import train as train_mod
from repro_torch.models import ModelConfig, register

# 12L, d=768, ff=2048, vocab 32k: 124,667,904 parameters, 75.5M in the
# layers and 49.2M in the embedding and unembedding
LM100M = register(ModelConfig(
    name="lm-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
    n_kv=4, d_ff=2048, vocab=32_000, remat="none", attn_chunk=4096))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--ckpt-dir",
                    default=str(Path(tempfile.gettempdir()) / "lm100m_ckpt_torch"),
                    help="checkpoints (default: lm100m_ckpt_torch in the "
                         "temporary directory; the reference example's "
                         "lm100m_ckpt holds its own)")
    ap.add_argument("--device", default=None,
                    help="cpu, or the card (default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    n = LM100M.param_count()
    print(f"[example] lm-100m: {n/1e6:.1f}M params, adaptive accumulation on")
    return train_mod.main([
        "--arch", "lm-100m", "--steps", str(args.steps),
        "--batch", str(args.batch), "--seq", str(args.seq),
        "--micro", str(args.micro), "--adaptive", "--rtol", "0.2",
        "--ckpt-dir", args.ckpt_dir, "--ckpt-every", "50",
        "--log-every", "10", "--device", str(dev),
    ])


if __name__ == "__main__":
    raise SystemExit(main())
