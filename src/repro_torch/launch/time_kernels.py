"""Time, on one CUDA card, the calls that the driven paths make most of with
the redesigned kernels (``bfs_frontier``, ``flash_attention`` and its
backward, ``rglru_scan`` and the scans' backward, ``alias_draw``,
``frame_accum``), so that two trees of the port can be held side by side:

- ``flash_attention`` in bf16 at ``adaptive_eval``'s shape, q (4, 10, 64,
  256) and k/v (4, 1, 64, 256), window 2048, and at recurrentgemma-2b's
  prefill shape, q (2, 10, 4096, 256) and k/v (2, 1, 4096, 256), both as
  the model's (B, S, heads, hd) memory in (B, heads, S, hd) views; in f32
  at the prefill shape and at the f32 prefill-vs-decode gate's q (4, 10,
  32, 256);
- ``frame_accum`` on int32 frames at the kadabra path's (4, 2²⁰), the wrs
  path's (4, 2²⁴) and (4, 1), and the conformance grid's commonest (2, 1);
  at the first two also after an L2 flush that leaves clean lines
  (``ms_clean_l2``);
- the conformance grid, ``run_all(device="cuda")`` (6 instances × 5
  strategies × W ∈ {1, 2, 4}), by its wall time, once to warm up and then
  ``--reps`` times;
- ``bfs_frontier`` on the inputs of the conformance grid's most frequent
  (lanes, vertices) shapes, as recorded in the warm-up run;
- ``rglru_scan`` at recurrentgemma-2b's prefill (2, 4096, 2560) and at
  ``adaptive_eval``'s (4, 64, 2560);
- the backward of ``flash_attention`` in bf16 (with the forward's
  logsumexp, q, k, v and dO as the model's views) at the train step's
  shapes: h2o-danube-3-4b's (1, 32, 4096, 120) kv 8 window 4096,
  recurrentgemma-2b's (1, 10, 4096, 256) kv 1 window 2048 and the training
  CLI's smollm-360m (4, 15, 512, 64) kv 5; and in f32 (the 3xTF32 body) at
  danube's shape;
- the scans' shared backward kernel: ``rglru_scan_bwd`` at (1, 4096, 2560)
  and ``ssm_scan_bwd`` at (1, 2048, 8192, 16), the train steps' shapes;
- ``alias_draw`` on a 2²⁴-bucket table (the wrs path's size; random valid
  ``prob``/``alias``, not a Vose build) at 2¹⁸ draws (the wrs path's
  W·batch), 2²⁰, 2²² and 2²⁴ draws, with prob uniform on [0, 1) (half the
  draws rejected) and on [0, 0.7) (65 % rejected, as on the wrs path's
  Pareto table); at the conformance grid's shapes, a 256-bucket table and
  128, 256 and 512 draws; and, at 2²⁴ draws on the half-rejected table,
  the probes that show what holds it back: the same draws on a 2¹⁶-bucket
  table (in L2), with prob ≡ 1 (no alias gather), and with u1 sorted
  (buckets in order), beside ``torch.add(u1, u2)``, which streams the same
  12 bytes a draw.

Each kernel time is the median of CUDA-event times with L2 flushed before
every call (``ms``), and the host's time a call in a loop of 200 calls,
the median of five loops (``loop_us``), where launches and allocations
show.  The package is the
one that ``PYTHONPATH`` gives, so the file can time another tree::

    PYTHONPATH=src python src/repro_torch/launch/time_kernels.py --label new
    PYTHONPATH=old/src python src/repro_torch/launch/time_kernels.py --label old

``--only flash,frame_accum`` times only those groups (``flash``,
``frame_accum``, ``rglru``, ``flash_bwd``, ``scan_bwd``, ``alias``,
``conformance``; the last times ``bfs_frontier`` too).  The backward groups
call only the wrappers' public functions, so a tree from before their
redesign times as well.

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def event_ms(fn, flush: torch.Tensor, reps: int = 25, warmup: int = 3,
             clean: bool = False) -> float:
    """Median CUDA-event time of ``fn`` in ms; before each call L2 is
    flushed by zeroing ``flush``, which leaves its last lines dirty in L2,
    or with ``clean`` by reading it, which leaves them clean."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        if clean:
            flush.view(torch.float32).sum()
        else:
            flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_us(fn, calls: int = 200, loops: int = 5) -> float:
    """The median over ``loops`` loops of the host's time a call in a loop
    of ``calls`` calls (the host is shared, so a single loop is noisy)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(loops):
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) / calls * 1e6)
    return statistics.median(times)


GROUPS = ("flash", "frame_accum", "rglru", "flash_bwd", "scan_bwd", "alias",
          "conformance")


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="")
    p.add_argument("--reps", type=int, default=10)
    p.add_argument("--only", default=",".join(GROUPS),
                   help="comma-separated groups to time: " + ", ".join(GROUPS))
    args = p.parse_args(argv)
    only = set(args.only.split(","))
    if not only <= set(GROUPS):
        p.error(f"--only takes {', '.join(GROUPS)}")

    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.frame_accum import frame_accum
    from repro_torch.kernels.rglru_scan import rglru_scan

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.build_all()
    out = {"label": args.label, "package": repro_torch.__file__,
           "card": torch.cuda.get_device_name(0), "build_s": time.time() - t0}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    flash = (("flash_bf16_eval", torch.bfloat16, (4, 64)),
             ("flash_bf16_prefill", torch.bfloat16, (2, 4096)),
             ("flash_f32_gate", torch.float32, (4, 32)),
             ("flash_f32_prefill", torch.float32, (2, 4096)))
    for name, dtype, (B, S) in flash if "flash" in only else ():
        q, k, v = [torch.randn((B, S, n, 256), generator=gen, device="cuda")
                   .to(dtype).transpose(1, 2) for n in (10, 1, 1)]
        call = lambda: flash_attention(q, k, v, window=2048)  # noqa: E731
        out[name] = {"q": list(q.shape), "ms": event_ms(call, flush),
                     "loop_us": loop_us(call)}
        del q, k, v

    accum = (("frame_accum_kadabra", (4, 1 << 20)),
             ("frame_accum_wrs_hist", (4, 1 << 24)),
             ("frame_accum_wrs_scalar", (4, 1)),
             ("frame_accum_conformance", (2, 1)))
    for name, shape in accum if "frame_accum" in only else ():
        x = torch.randint(0, 1000, shape, generator=gen, device="cuda",
                          dtype=torch.int32)
        call = lambda: frame_accum(x)  # noqa: E731
        out[name] = {"shape": list(shape), "ms": event_ms(call, flush),
                     "loop_us": loop_us(call)}
        if shape[1] > 1:  # the streams: what the dirty lines cost them
            out[name]["ms_clean_l2"] = event_ms(call, flush, clean=True)
        del x

    rglru = (("rglru_eval", (4, 64, 2560)), ("rglru_prefill", (2, 4096, 2560)))
    for name, shape in rglru if "rglru" in only else ():
        a = torch.rand(shape, generator=gen, device="cuda") * 0.75 + 0.2
        b = torch.randn(shape, generator=gen, device="cuda")
        call = lambda: rglru_scan(a, b)  # noqa: E731
        out[name] = {"shape": list(shape), "ms": event_ms(call, flush),
                     "loop_us": loop_us(call)}
        del a, b

    if "flash_bwd" in only:
        time_flash_bwd(out, flush, gen)
    if "scan_bwd" in only:
        time_scan_bwd(out, flush, gen)
    if "alias" in only:
        time_alias_draw(out, flush, gen)
    if "conformance" in only:
        time_conformance(out, flush, args.reps)
    print(json.dumps(out), flush=True)
    return out


def time_flash_bwd(out, flush, gen):
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    for name, (B, H, KV, S, hd), window, dtype in (
            ("flash_bwd_danube", (1, 32, 8, 4096, 120), 4096, torch.bfloat16),
            ("flash_bwd_danube_f32", (1, 32, 8, 4096, 120), 4096, torch.float32),
            ("flash_bwd_rg", (1, 10, 1, 4096, 256), 2048, torch.bfloat16),
            ("flash_bwd_smollm_cli", (4, 15, 5, 512, 64), 0, torch.bfloat16)):
        q, k, v, do = [torch.randn((B, S, n, hd), generator=gen, device="cuda")
                       .to(dtype).transpose(1, 2) for n in (H, KV, KV, H)]
        o, lse = flash_attention(q, k, v, window=window, return_lse=True)
        call = lambda: flash_attention_bwd(q, k, v, o, lse, do, window=window)  # noqa: E731
        out[name] = {"q": list(q.shape), "kv": list(k.shape), "window": window,
                     "dtype": str(dtype).removeprefix("torch."),
                     "ms": event_ms(call, flush, reps=10), "loop_us": loop_us(call)}
        del q, k, v, do, o, lse


def time_scan_bwd(out, flush, gen):
    from repro_torch.kernels.rglru_scan import rglru_scan, rglru_scan_bwd
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd

    for name, shape, fwd, bwd in (
            ("rglru_scan_bwd", (1, 4096, 2560), rglru_scan, rglru_scan_bwd),
            ("ssm_scan_bwd", (1, 2048, 8192, 16), ssm_scan, ssm_scan_bwd)):
        a = torch.rand(shape, generator=gen, device="cuda") * 0.75 + 0.2
        g = torch.randn(shape, generator=gen, device="cuda")
        h = fwd(a, torch.randn(shape, generator=gen, device="cuda"))
        call = lambda: bwd(a, h, g)  # noqa: E731
        out[name] = {"shape": list(shape), "ms": event_ms(call, flush),
                     "loop_us": loop_us(call)}
        del a, g, h


def time_alias_draw(out, flush, gen):
    from repro_torch.kernels.alias_draw import alias_draw

    out["alias_draw"] = []
    for n, top, draws in ((1 << 24, 1.0, (1 << 18, 1 << 20, 1 << 22, 1 << 24)),
                          (1 << 24, 0.7, (1 << 18, 1 << 24)),
                          (256, 1.0, (128, 256, 512))):
        prob = torch.rand(n, generator=gen, device="cuda") * top
        alias = torch.randint(0, n, (n,), generator=gen, device="cuda",
                              dtype=torch.int32)
        for b in draws:
            u1 = torch.rand(b, generator=gen, device="cuda")
            u2 = torch.rand(b, generator=gen, device="cuda")
            bucket = (u1 * n).long().clamp(0, n - 1)
            call = lambda: alias_draw(prob, alias, u1, u2)  # noqa: E731
            out["alias_draw"].append({
                "n": n, "prob_below": top, "draws": b,
                "rejected": float((u2 >= prob[bucket]).float().mean()),
                "ms": event_ms(call, flush), "loop_us": loop_us(call)})
    n = 1 << 24
    prob = torch.rand(n, generator=gen, device="cuda")
    alias = torch.randint(0, n, (n,), generator=gen, device="cuda",
                          dtype=torch.int32)
    u1 = torch.rand(n, generator=gen, device="cuda")
    u2 = torch.rand(n, generator=gen, device="cuda")
    small = 1 << 16
    probes = {
        "as_drawn": (prob, alias, u1, u2),
        "table_in_l2": (prob[:small].clone(), alias[:small] % small, u1, u2),
        "prob_1_no_alias_gather": (torch.ones_like(prob), alias, u1, u2),
        "buckets_in_order": (prob, alias, torch.sort(u1).values, u2),
    }
    probe_ms = {name: event_ms(lambda: alias_draw(*args), flush)  # noqa: B023
                for name, args in probes.items()}
    probe_ms["streams_only_torch_add"] = event_ms(lambda: torch.add(u1, u2),
                                                  flush)
    out["alias_draw_probes"] = {"draws": n, **probe_ms}


def time_conformance(out, flush, reps):
    from repro_torch.core.conformance import run_all
    from repro_torch.kernels import ops
    from repro_torch.kernels.bfs_frontier import bfs_frontier

    # the warm-up run records the first inputs of each (lanes, n) shape
    seen = {}
    kernel = ops._bfs_kernel

    def recording(indptr, indices, sigma, dist, level):
        key = tuple(sigma.shape)
        if key not in seen:
            seen[key] = [0, tuple(t.clone() for t in (indptr, indices, sigma, dist)),
                         level]
        seen[key][0] += 1
        return kernel(indptr, indices, sigma, dist, level)

    ops._bfs_kernel = recording
    try:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        reports = run_all(device="cuda")
        torch.cuda.synchronize()
        warm = time.perf_counter() - t0
    finally:
        ops._bfs_kernel = kernel
    if not all(r.ok for r in reports.values()):
        raise AssertionError("a conformance cell failed")
    walls = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_all(device="cuda")
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
    out["conformance"] = {"first_s": warm, "wall_s": walls,
                          "bfs_frontier_calls": sum(c for c, _, _ in seen.values())}
    top = sorted(seen.items(), key=lambda kv: -kv[1][0])[:3]
    out["bfs_frontier"] = []
    for shape, (count, tensors, level) in top:
        call = lambda: bfs_frontier(*tensors, level)  # noqa: E731
        out["bfs_frontier"].append({"shape": list(shape), "calls": count,
                                    "ms": event_ms(call, flush),
                                    "loop_us": loop_us(call)})


if __name__ == "__main__":
    main()
