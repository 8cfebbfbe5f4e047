"""Time, on one CUDA card, the calls that the driven paths make most of with
the ``bfs_frontier`` and ``flash_attention`` kernels, so that two trees of
the port can be held side by side:

- ``flash_attention`` in bf16 at ``adaptive_eval``'s shape, q (4, 10, 64,
  256) and k/v (4, 1, 64, 256), window 2048, and at recurrentgemma-2b's
  prefill shape, q (2, 10, 4096, 256) and k/v (2, 1, 4096, 256), both as
  the model's (B, S, heads, hd) memory in (B, heads, S, hd) views;
- the conformance grid, ``run_all(device="cuda")`` (6 instances × 5
  strategies × W ∈ {1, 2, 4}), by its wall time, once to warm up and then
  ``--reps`` times;
- ``bfs_frontier`` on the inputs of the conformance grid's most frequent
  (lanes, vertices) shapes, as recorded in the warm-up run.

Each kernel time is the median of CUDA-event times with L2 flushed before
every call (``ms``), and the host's time a call in a loop of 200 calls
(``loop_us``), where launches and allocations show.  The package is the
one that ``PYTHONPATH`` gives, so the file can time another tree::

    PYTHONPATH=src python src/repro_torch/launch/time_kernels.py --label new
    PYTHONPATH=old/src python src/repro_torch/launch/time_kernels.py --label old

Prints one JSON line.
"""

from __future__ import annotations

import argparse
import json
import statistics
import time

import torch


def event_ms(fn, flush: torch.Tensor, reps: int = 25, warmup: int = 3) -> float:
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def loop_us(fn, calls: int = 200) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--label", default="")
    p.add_argument("--reps", type=int, default=3)
    args = p.parse_args(argv)

    import repro_torch
    from repro_torch.core.conformance import run_all
    from repro_torch.kernels import build, ops
    from repro_torch.kernels.bfs_frontier import bfs_frontier
    from repro_torch.kernels.flash_attention import flash_attention

    torch.backends.cuda.matmul.allow_tf32 = False
    t0 = time.time()
    build.build_all()
    out = {"label": args.label, "package": repro_torch.__file__,
           "card": torch.cuda.get_device_name(0), "build_s": time.time() - t0}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)

    for name, (B, S) in (("flash_bf16_eval", (4, 64)),
                         ("flash_bf16_prefill", (2, 4096))):
        q, k, v = [torch.randn((B, S, n, 256), generator=gen, device="cuda")
                   .to(torch.bfloat16).transpose(1, 2) for n in (10, 1, 1)]
        call = lambda: flash_attention(q, k, v, window=2048)  # noqa: E731
        out[name] = {"q": list(q.shape), "ms": event_ms(call, flush),
                     "loop_us": loop_us(call)}

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
    for _ in range(args.reps):
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
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
