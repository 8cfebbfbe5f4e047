"""Serving launcher of the port: the adaptive-query pool (``--pool``, the
serving subsystem's CLI), batched greedy generation and **adaptive metric
evaluation** — the paper's engine estimating mean per-token loss over a
prompt distribution to (ε, δ) with Empirical-Bernstein stopping, one
forward pass a sample.  Port of :mod:`repro.launch.serve`.

    # epoch-granular continuous batching over a mixed query stream
    PYTHONPATH=src python -m repro_torch.launch.serve --pool \
        --queries wrs:shared:4,triangles:local:2:1 --max-in-flight 2 \
        [--checkpoint-dir CKPT [--resume] [--checkpoint-every 2]]
    # a pool of worker slots, SHARED_FRAME sessions resized under load
    PYTHONPATH=src python -m repro_torch.launch.serve --pool --topology 4 \
        --pressure-policy shrink-regrow \
        --queries reachability:shared:4,wrs:local:2
    PYTHONPATH=src python -m repro_torch.launch.serve --arch recurrentgemma-2b \\
        --batch 4 --prompt-len 32 --gen 16
    PYTHONPATH=src python -m repro_torch.launch.serve --arch falcon-mamba-7b
    PYTHONPATH=src python -m repro_torch.launch.serve \\
        --arch falcon-mamba-7b-reduced --device cpu --adaptive-eval --eps 0.5

``--arch`` names a config of the ``hybrid`` (recurrentgemma) or ``ssm``
(falcon-mamba) family, or its ``-reduced`` cut; ``generate`` and
``adaptive_eval`` take any ported model.  Everything runs on the CUDA card
unless ``--device`` (or ``device=``) names another device; a pool resumed
with ``--resume`` must run on the device type it was checkpointed on.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
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


DEFAULT_POOL_QUERIES = "wrs:local:2,triangles:local:2:1"


def serve_pool(args) -> int:
    """Drive the epoch-granular scheduler over a query stream."""
    from ..serve import EpochScheduler, PressurePolicy, SessionSpec
    from .mesh import make_device_pool

    device = resolve_device(args.device)
    # --resume restores the checkpointed stream; the default query list only
    # applies to fresh pools (explicit --queries adds to a resumed one).
    queries = args.queries if args.queries is not None \
        else ("" if args.resume else DEFAULT_POOL_QUERIES)

    pool = make_device_pool(args.topology) if args.topology else None
    pressure = PressurePolicy.parse(args.pressure_policy)
    if pressure is not None and pool is None:
        print("[serve] --pressure-policy needs --topology (a device pool)")
        return 2
    if pool is not None:
        print(f"[serve] device pool: {pool.capacity} slot(s) in "
              f"{len(pool.topology.groups)} group(s)"
              + (f", pressure={args.pressure_policy}" if pressure else ""))

    if args.resume:
        if not args.checkpoint_dir:
            print("[serve] --resume needs --checkpoint-dir")
            return 2
        sched = EpochScheduler.resume(
            args.checkpoint_dir, max_in_flight=args.max_in_flight,
            substrate=args.substrate, pool=pool, pressure=pressure,
            checkpoint_every=args.checkpoint_every, device=device)
        print(f"[serve] resumed {sched.pending} session(s) from "
              f"{args.checkpoint_dir}")
    else:
        sched = EpochScheduler(max_in_flight=args.max_in_flight,
                               substrate=args.substrate,
                               pool=pool, pressure=pressure,
                               checkpoint_dir=args.checkpoint_dir or None,
                               checkpoint_every=args.checkpoint_every,
                               device=device)
    for q in (s for s in queries.split(",") if s):
        sched.submit(SessionSpec.parse(q))

    t0 = time.time()
    while not sched.idle:
        ev = sched.tick()
        for qid, old_w, new_w in ev.resharded:
            word = "shrunk" if new_w < old_w else "regrown"
            print(f"[serve] tick {ev.tick}: {word} {qid} "
                  f"W={old_w} → {new_w} (pressure)")
        for qid in ev.retired:
            r = sched.results[qid]
            est = np.array2string(r.estimate, precision=4)
            place = f" dev={r.devices_leased}" \
                f" pwait={r.placement_wait_ticks}" if pool else ""
            print(f"[serve] tick {ev.tick}: retired {qid} "
                  f"τ={r.tau} epochs={r.epochs} wait={r.wait_ticks}"
                  f"{place} est={est}")
    dt = time.time() - t0
    n = len(sched.results)
    taus = sum(r.tau for r in sched.results.values())
    print(f"[serve] pool drained: {n} queries, {sched.tick_count} ticks, "
          f"{taus} samples in {dt:.1f}s ({taus / max(dt, 1e-9):.0f} "
          f"samples/s, {len(sched.cache)} built steppers)")
    return 0


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
    # ----- adaptive-query pool (repro_torch.serve scheduler) -----
    ap.add_argument("--pool", action="store_true",
                    help="run the adaptive-query pool scheduler")
    ap.add_argument("--queries", default=None,
                    help="comma-separated instance:strategy:world[:seed] "
                         f"(default for fresh pools: {DEFAULT_POOL_QUERIES}; "
                         "--resume defaults to the restored stream only)")
    ap.add_argument("--max-in-flight", type=int, default=2)
    ap.add_argument("--substrate", default=None,
                    help="sequential | vmap (the pool's shard_map sessions "
                         "wait for ROADMAP queue 1 item 9 and raise)")
    ap.add_argument("--topology", default="",
                    help="device pool topology: 'auto' (the host's CUDA "
                         "devices), 'N' (one group of N slots), or 'GxN' "
                         "(G groups of N); empty = no placement pool")
    ap.add_argument("--pressure-policy", default="none",
                    help="none | shrink | shrink-regrow[:min=N] — resize "
                         "SHARED_FRAME sessions under queued load "
                         "(needs --topology)")
    ap.add_argument("--checkpoint-dir", default="")
    ap.add_argument("--checkpoint-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="restore sessions from --checkpoint-dir")
    args = ap.parse_args(argv)

    if args.pool:
        return serve_pool(args)
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
