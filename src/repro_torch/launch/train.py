"""End-to-end training launcher of the port.  Port of
:mod:`repro.launch.train`: deterministic data pipeline → (optionally
adaptive) gradient accumulation → AdamW → async checkpoints → failure
injection and recovery.  Runs on the CUDA card unless ``--device`` names
another device; the reduced configs run on the CPU.

    PYTHONPATH=src python -m repro_torch.launch.train \\
        --arch smollm-360m-reduced --device cpu --steps 4 --batch 4 \\
        --seq 32 --micro 2 --ckpt-dir /tmp/ck

``--adaptive`` switches gradient accumulation to the paper's ADS engine
(stop drawing micro-batches once the gradient-variance bound holds).
"""

from __future__ import annotations

import argparse
import dataclasses
import time
from pathlib import Path

import torch

from ..checkpoint import CheckpointManager
from ..data import DataCursor, TokenStream
from ..device import resolve_device
from ..models import Model, resolve_config
from ..optim import (AdamWConfig, AdaptiveAccumConfig, adamw_init,
                     adamw_update, adaptive_accumulate)
from ..runtime import FailureEvent, FailureInjector, Heartbeat
from .steps import loss_and_grads, make_train_step


def make_adaptive_step(model: Model, opt_cfg: AdamWConfig,
                       acc_cfg: AdaptiveAccumConfig):
    """step(opt_state, micro_batches) → (opt_state, metrics with
    ``micro_used`` and ``rel_sem``)."""
    params = dict(model.named_parameters())

    def step(opt_state, micro_batches):
        grads, loss, n_used, rel = adaptive_accumulate(
            lambda p, b: loss_and_grads(model, p, b), params, micro_batches,
            acc_cfg)
        _, opt_state, gnorm = adamw_update(grads, opt_state, params, opt_cfg)
        return opt_state, {"loss": loss, "grad_norm": gnorm,
                           "micro_used": n_used, "rel_sem": rel}

    return step


def make_fixed_step(model: Model, opt_cfg: AdamWConfig):
    return make_train_step(model, opt_cfg)


def _restore(manager, params, opt_state):
    """The latest checkpoint's parameters copied into ``params`` in place,
    its optimizer state and data cursor; None without a checkpoint."""
    restored = manager.restore_latest({"params": params, "opt": opt_state})
    if not restored:
        return None
    step0, tree, meta = restored
    with torch.no_grad():
        for k, p in params.items():
            p.copy_(tree["params"][k])
    return step0, tree["opt"], DataCursor.from_meta(meta)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m-reduced")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--micro", type=int, default=4)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--adaptive", action="store_true",
                    help="ADS-driven gradient accumulation")
    ap.add_argument("--rtol", type=float, default=0.3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=25)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--inject-failures", action="store_true")
    ap.add_argument("--preempt-at", type=int, default=-1)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the CUDA card; 'cpu' to run "
                         "on the CPU)")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = dataclasses.replace(resolve_config(args.arch), grad_accum=1)
    opt_cfg = AdamWConfig(lr=args.lr)
    acc_cfg = AdaptiveAccumConfig(rtol=args.rtol,
                                  min_micro=min(2, args.micro),
                                  max_micro=args.micro)

    gen = torch.Generator(device=device)
    gen.manual_seed(args.seed)
    model = Model(cfg, device=device).init(gen).requires_grad_(True)
    params = dict(model.named_parameters())
    opt_state = adamw_init(params)
    stream = TokenStream(vocab=cfg.vocab, seq_len=args.seq,
                         batch=args.batch, seed=args.seed)
    cursor = DataCursor(step=0, seed=args.seed)

    manager = None
    if args.ckpt_dir:
        manager = CheckpointManager(Path(args.ckpt_dir), keep=2)
        if args.resume:
            restored = _restore(manager, params, opt_state)
            if restored:
                step0, opt_state, cursor = restored
                print(f"[train] resumed at step {step0} "
                      f"(data cursor {cursor.step})")

    injector = FailureInjector(
        seed=args.seed + 1,
        crash_prob=0.02 if args.inject_failures else 0.0,
        straggler_prob=0.05 if args.inject_failures else 0.0,
        preempt_at_step=args.preempt_at if args.preempt_at >= 0 else None)
    heartbeat = Heartbeat(deadline_s=120.0, on_late=lambda dt: print(
        f"[train] WARN slow step: {dt:.1f}s (straggler suspect)"))

    step_fn = make_adaptive_step(model, opt_cfg, acc_cfg) if args.adaptive \
        else make_fixed_step(model, opt_cfg)

    def state():
        return {"params": params, "opt": opt_state}

    t_start = time.time()
    step = cursor.step
    losses = []
    while step < args.steps:
        heartbeat.start()
        event = injector.poll(step)
        if event == FailureEvent.WORKER_CRASH and manager is not None:
            print(f"[train] step {step}: injected WORKER_CRASH — "
                  f"restoring from last checkpoint")
            manager.wait()
            restored = _restore(manager, params, opt_state)
            if restored:
                _, opt_state, cursor = restored
                step = cursor.step
        if event == FailureEvent.PREEMPTION and manager is not None:
            print(f"[train] step {step}: PREEMPTION — checkpoint + exit")
            manager.save(state(), step,
                         meta=DataCursor(step=step, seed=args.seed).as_meta())
            manager.wait()
            return 0

        batch = stream.micro_batches(step, args.micro, device=device)
        if not args.adaptive and args.micro == 1:
            batch = {k: x[0] for k, x in batch.items()}
        opt_state, metrics = step_fn(opt_state, batch)
        loss = float(metrics["loss"])
        losses.append(loss)
        dt = heartbeat.stop()
        if step % args.log_every == 0 or step == args.steps - 1:
            extra = ""
            if args.adaptive:
                extra = (f" micro={int(metrics['micro_used'])}"
                         f" rel_sem={float(metrics['rel_sem']):.3f}")
            print(f"[train] step {step:5d} loss={loss:.4f} "
                  f"gnorm={float(metrics['grad_norm']):.3f} "
                  f"{dt*1e3:6.0f}ms{extra}")
        step += 1
        if manager is not None and step % args.ckpt_every == 0:
            manager.save(state(), step,
                         meta=DataCursor(step=step, seed=args.seed).as_meta())
    if manager is not None:
        manager.save(state(), step,
                     meta=DataCursor(step=step, seed=args.seed).as_meta())
        manager.wait()
    n = max(len(losses) // 10, 1)
    print(f"[train] done in {time.time()-t_start:.1f}s; "
          f"loss {sum(losses[:n])/n:.4f} → {sum(losses[-n:])/n:.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
