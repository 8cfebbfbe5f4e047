"""Serving launcher of the port: batched greedy generation and **adaptive
metric evaluation** — the paper's engine estimating mean per-token loss
over a prompt distribution to (ε, δ) with Empirical-Bernstein stopping, one
forward pass a sample.  Port of :mod:`repro.launch.serve` for the model
zoo's ``--arch`` path; the adaptive-query pool (``--pool``) is still to
port (ROADMAP queue 1 item 9).

    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b-reduced --device cpu --adaptive-eval --eps 0.5

``--arch`` names a config of the ``hybrid`` (recurrentgemma) or ``ssm``
(falcon-mamba) family, or its ``-reduced`` cut; ``generate`` and
``adaptive_eval`` take any ported model.  Everything runs on the CUDA card
unless ``--device`` (or ``device=``) names another device.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..core.adaptive import AdaptiveResult, run_adaptive
from ..core.frames import FrameStrategy, StateFrame
from ..core.stopping import EmpiricalBernsteinCondition
from ..data import TokenStream
from ..device import resolve_device, to_host
from ..models import Model, resolve_config
from .steps import make_serve_step


def generate(model: Model, prompts: torch.Tensor, gen: int) -> torch.Tensor:
    """Greedy decode ``gen`` tokens for a (B, P) prompt batch → (B, P+gen).
    As in the reference, the prompt is fed through the decode step one token
    at a time (no prefill cache)."""
    B, P = prompts.shape
    capacity = P + gen
    serve_step = make_serve_step(model)
    cache = model.init_cache(B, capacity)
    toks = prompts[:, 0]
    out = [toks]
    for t in range(capacity - 1):
        pos = torch.full((B,), t, dtype=torch.int32, device=prompts.device)
        cache, nxt = serve_step(cache, {"tokens": toks, "pos": pos})
        toks = prompts[:, t + 1] if t + 1 < P else nxt
        out.append(toks)
    return torch.stack(out, dim=1)


def adaptive_eval(model: Model, stream: TokenStream, *, eps: float,
                  delta: float, max_epochs: int = 200, seed: int = 0
                  ) -> tuple[float, AdaptiveResult]:
    """(ε, δ)-estimate of the mean per-token loss over the stream's batches
    with the epoch engine (LOCAL_FRAME, one worker, 2 rounds an epoch, one
    batch a round) → (mean, result).  Each sample is the loss of the batch
    at a step drawn from the worker's generator (one host read a sample)."""
    device = model.embed.device
    cond = EmpiricalBernsteinCondition(eps=eps, delta=delta, value_range=15.0)

    def sample_fn(gens, carry):
        losses = []
        for gen in gens:
            step = to_host(torch.randint(0, 1 << 30, (), generator=gen,
                                         device=gen.device))
            losses.append(model.train_loss(stream.batch_at(step, device=device)))
        l = torch.stack(losses).float()
        num = torch.ones(len(gens), dtype=torch.int32, device=device)
        return StateFrame(num=num, data={"s1": l, "s2": torch.square(l)}), carry

    z = torch.zeros((), dtype=torch.float32)
    res = run_adaptive(sample_fn, cond, {"s1": z, "s2": z.clone()},
                       strategy=FrameStrategy.LOCAL_FRAME, world=1, seed=seed,
                       rounds_per_epoch=2, max_epochs=max_epochs, device=device)
    return float(res.data["s1"]) / max(res.num, 1), res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="recurrentgemma-2b-reduced")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adaptive-eval", action="store_true")
    ap.add_argument("--eps", type=float, default=0.1)
    ap.add_argument("--delta", type=float, default=0.1)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card)")
    ap.add_argument("--pool", action="store_true",
                    help="the adaptive-query pool (not ported yet)")
    args = ap.parse_args(argv)

    if args.pool:
        raise NotImplementedError("the adaptive-query pool (--pool) is still "
                                  "to port: ROADMAP queue 1 item 9")
    device = resolve_device(args.device)
    cfg = resolve_config(args.arch)
    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    with torch.inference_mode():
        model = Model(cfg, device=device).init(gen)
        if args.adaptive_eval:
            stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                                 batch=args.batch, seed=args.seed)
            t0 = time.time()
            mean, res = adaptive_eval(model, stream, eps=args.eps,
                                      delta=args.delta, seed=args.seed)
            print(f"[serve] adaptive eval: mean loss = {mean:.4f} ± {args.eps} "
                  f"(p ≥ {1 - args.delta}) after {res.num} samples "
                  f"(stopped={res.stopped}, {time.time() - t0:.1f}s)")
            return 0
        stream = TokenStream(vocab=cfg.vocab, seq_len=args.prompt_len,
                             batch=args.batch, seed=args.seed)
        prompts = stream.batch_at(0, device=device)["tokens"]
        t0 = time.time()
        out = generate(model, prompts, args.gen).cpu()
        dt = time.time() - t0
    n_new = args.batch * args.gen
    print(f"[serve] generated {n_new} tokens in {dt:.1f}s "
          f"({n_new / dt:.1f} tok/s); sample row: "
          f"{out[0, -args.gen:].tolist()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
