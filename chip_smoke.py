#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing one JSON line (``{"phase": ...}``); any failure raises
and the script exits non-zero:

1. device    — the card (nvidia-smi name and power limit), torch and CUDA.
2. build     — nvcc builds every kernel from ``src/repro_torch/kernels/csrc``.
3. kernels   — each kernel against its plain PyTorch version at the main
               path's full-size shapes, with times (CUDA events, median),
               the bound and one library call as a yardstick.
4. accuracy  — KADABRA on erdos_renyi(1000, 5000) for all five strategies
               within ε of exact Brandes; INDEXED_FRAME bit-identical for
               W ∈ {1, 2, 4}; τ a whole number of frame units; SHARED == LOCAL.
5. full size — KADABRA on erdos_renyi(2**20, 8·2**20), ε = 0.02, δ = 0.1,
               batch 64, W = 4, 4 rounds per epoch, LOCAL and SHARED.
6. kernels   — every kernel with its launches on the main path (phases 4–5).

Then the card's name and power limit, then the result line
``{"ok": true, "device": {...}}``.  Imports no JAX and nothing of ``repro``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores

FULL_N = 2 ** 20
FULL_M = 8 * 2 ** 20
LANES = 256                 # W · batch of the full-size run


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / F32_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class Timer:
    """Median time of a call in ms, by CUDA events, with L2 flushed before
    every timed call (the callers on the main path find their inputs cold)."""

    def __init__(self, torch):
        self.torch = torch
        self.flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")

    def __call__(self, fn, reps: int = 25, warmup: int = 3) -> float:
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            self.flush.zero_()
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return statistics.median(times)


def phase_kernels(torch, timer, g):
    from repro_torch.graphs.bfs import bfs_sssp
    from repro_torch.kernels import ref
    from repro_torch.kernels.bfs_frontier import bfs_frontier
    from repro_torch.kernels.frame_accum import frame_accum

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    # frame_accum at the main path's (W=4, n=2^20) per-vertex int32 counts
    W, n = 4, FULL_N
    checks = {}
    for name, x, rtol, atol in [
        ("int32", torch.randint(0, 1000, (W, n), generator=gen, device="cuda",
                                dtype=torch.int32), 0.0, 0.0),
        ("float32", torch.randn((W, n), generator=gen, device="cuda"), 1e-6, 1e-6),
        ("bfloat16", torch.randn((W, n), generator=gen, device="cuda"
                                 ).to(torch.bfloat16), 2e-2, 1e-2),
    ]:
        got, exp = frame_accum(x), ref.frame_accum_ref(x)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, exp, rtol=rtol, atol=atol)
        checks[name] = float((got.float() - exp.float()).abs().max())
    x = torch.randint(0, 1000, (W, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    t_bound, by = bound_ms((W + 1) * n * 4, (W - 1) * n)
    rows["frame_accum"] = {
        "max_abs_err": checks["int32"],
        "ms": timer(lambda: frame_accum(x)),
        "plain_ms": timer(lambda: ref.frame_accum_ref(x)),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": timer(lambda: torch.sum(x, dim=0, dtype=torch.int32)),
    }
    emit({"phase": "kernels", "kernel": "frame_accum", "shape": [W, n],
          "max_abs_err_by_dtype": checks,
          "tolerance": "int32 exact; float32 rtol 1e-6 atol 1e-6; "
                       "bfloat16 rtol 2e-2 atol 1e-2", **rows["frame_accum"]})

    # bfs_frontier on the full graph, B = 256 lanes, at levels of a real BFS
    B = LANES
    src_v = torch.randint(0, g.n, (B,), generator=gen, device="cuda")
    deg = (g.indptr[1:] - g.indptr[:-1]).float()
    chunk = 16  # the plain version's (B, m) gathers are run 16 lanes at a time

    def plain(sigma, dist, level):
        return torch.cat([ref.bfs_frontier_ref(g.src, g.dst, sigma[i:i + chunk],
                                               dist[i:i + chunk], level)
                          for i in range(0, B, chunk)])

    max_err, timed = 0.0, None
    for level in (0, 2, 4, 5):
        dist, sigma = bfs_sssp(g, src_v, None, max_levels=level,
                               early_exit=False, device="cuda")
        got = bfs_frontier(g.indptr, g.indices_padded, sigma, dist, level)
        exp = plain(sigma, dist, level)
        torch.cuda.synchronize()
        # the plain version sums with atomics in arrival order: rtol 1e-5
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=0.0)
        if not torch.equal(got > 0, exp > 0):
            raise AssertionError(f"bfs_frontier: {{agg > 0}} differs at level {level}")
        max_err = max(max_err, float((got - exp).abs().max()))
        if level == 4:
            timed = (dist, sigma, level)
        del got, exp
    dist, sigma, level = timed
    front = dist == level
    front_arcs = float((front.float() @ deg).sum())
    nbytes = 4 * (g.n + 1) + 4 * g.m_arcs + 4 * B * g.n * 2 + 4 * float(front.sum())
    t_bound, by = bound_ms(nbytes, B * g.m_arcs + front_arcs)
    adj = torch.sparse_csr_tensor(
        g.indptr.long(), g.indices_padded[:g.m_arcs].long(),
        torch.ones(g.m_arcs, device="cuda"), size=(g.n, g.n))
    masked_t = torch.where(front, sigma, 0.0).t().contiguous()
    rows["bfs_frontier"] = {
        "max_abs_err": max_err,
        "ms": timer(lambda: bfs_frontier(g.indptr, g.indices_padded, sigma,
                                         dist, level)),
        "plain_ms": timer(lambda: plain(sigma, dist, level), reps=5, warmup=1),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": timer(lambda: torch.sparse.mm(adj, masked_t)),
    }
    emit({"phase": "kernels", "kernel": "bfs_frontier",
          "shape": {"lanes": B, "n": g.n, "arcs": g.m_arcs, "timed_level": level,
                    "frontier_entries": int(front.sum())},
          "levels_checked": [0, 2, 4, 5], "tolerance": "rtol 1e-5, {agg>0} equal",
          "library": "torch.sparse.mm(CSR adjacency, pre-masked sigma^T)",
          **rows["bfs_frontier"]})
    del adj, masked_t, dist, sigma, front
    torch.cuda.empty_cache()
    return rows


def phase_accuracy(torch):
    import numpy as np

    from repro_torch.core.frames import FrameStrategy as FS
    from repro_torch.graphs import (KadabraParams, brandes_exact, erdos_renyi,
                                    preprocess, run_kadabra)

    g = erdos_renyi(1000, 5000, seed=0, device="cuda")
    t0 = time.time()
    exact = brandes_exact(g)
    brandes_s = time.time() - t0
    params = KadabraParams(eps=0.05, delta=0.1, batch=64, rounds_per_epoch=4,
                           max_epochs=4096)
    pre = preprocess(g, params.eps, params.delta, device="cuda")
    cells = {}
    for strat, world in [(FS.LOCK, 1), (FS.BARRIER, 4), (FS.LOCAL_FRAME, 4),
                         (FS.SHARED_FRAME, 4), (FS.INDEXED_FRAME, 4),
                         (FS.INDEXED_FRAME, 1), (FS.INDEXED_FRAME, 2)]:
        t0 = time.time()
        b, res, _ = run_kadabra(g, params, strategy=strat, world=world, seed=0,
                                pre=pre, device="cuda")
        err = float(np.abs(b - exact).max())
        rounds = 1 if strat == FS.LOCK else params.rounds_per_epoch
        unit = params.batch * rounds
        key = f"{strat.value}-W{world}"
        cells[key] = (b, res)
        emit({"phase": "accuracy", "cell": key, "max_err": err,
              "eps": params.eps, "tau": res.num, "epochs": res.epochs,
              "stopped": res.stopped, "wall_s": time.time() - t0})
        if not res.stopped or err > params.eps:
            raise AssertionError(f"{key}: stopped={res.stopped}, max err {err} "
                                 f"> ε = {params.eps}")
        if res.num % unit:
            raise AssertionError(f"{key}: τ = {res.num} is not a whole number "
                                 f"of frame units ({unit})")
    ref_b, ref_res = cells["indexed-W4"]
    for w in (1, 2):
        b, res = cells[f"indexed-W{w}"]
        if res.num != ref_res.num or not np.array_equal(b, ref_b):
            raise AssertionError(f"INDEXED_FRAME W={w} differs from W=4")
    shared, local = cells["shared-W4"][1].data, cells["local-W4"][1].data
    if not (np.array_equal(shared[:g.n], local) and not shared[g.n:].any()):
        raise AssertionError("SHARED_FRAME reassembly differs from LOCAL_FRAME")
    emit({"phase": "accuracy", "graph": "erdos_renyi(1000, 5000, seed=0)",
          "brandes_s": brandes_s, "omega": pre.omega, "vd_upper": pre.vd_upper,
          "indexed_bit_identical_W124": True, "shared_equals_local": True})


def phase_full(torch, g):
    import numpy as np

    from repro_torch import device as dev_mod
    from repro_torch.core.frames import FrameStrategy as FS
    from repro_torch.graphs import KadabraParams, preprocess, run_kadabra
    from repro_torch.kernels import bfs_frontier as bfs_mod
    from repro_torch.kernels import frame_accum as accum_mod

    params = KadabraParams(eps=0.02, delta=0.1, batch=64, rounds_per_epoch=4,
                           max_epochs=4096)
    world = 4
    torch.cuda.synchronize()
    t0 = time.time()
    pre = preprocess(g, params.eps, params.delta, device="cuda")
    torch.cuda.synchronize()
    emit({"phase": "full", "step": "preprocess", "wall_s": time.time() - t0,
          "omega": pre.omega, "vd_upper": pre.vd_upper,
          "diam_levels": pre.diam_levels})
    out = {}
    for strat in (FS.LOCAL_FRAME, FS.SHARED_FRAME):
        torch.cuda.reset_peak_memory_stats()
        dev_mod.host_syncs = 0
        launched = (bfs_mod.launches, accum_mod.launches)
        torch.cuda.synchronize()
        t0 = time.time()
        b, res, _ = run_kadabra(g, params, strategy=strat, world=world, seed=0,
                                pre=pre, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        syncs = dev_mod.host_syncs
        out[strat] = res
        emit({"phase": "full", "strategy": strat.value, "world": world,
              "tau": res.num, "epochs": res.epochs, "stopped": res.stopped,
              "stop_epoch": res.stop_epoch, "wall_s": wall,
              "checked_samples_per_s": res.num / wall,
              "host_syncs": syncs, "host_syncs_per_epoch": syncs / res.epochs,
              "bfs_frontier_launches": bfs_mod.launches - launched[0],
              "frame_accum_launches": accum_mod.launches - launched[1],
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "max_btilde": float(b.max())})
        if not res.stopped:
            raise AssertionError(f"full size {strat.value}: the stop never fired")
        if not (np.isfinite(b).all() and (b >= 0).all() and (b <= 1).all()):
            raise AssertionError(f"full size {strat.value}: b̃ outside [0, 1]")
    local, shared = out[FS.LOCAL_FRAME], out[FS.SHARED_FRAME]
    if shared.data.shape != local.data.shape:
        raise AssertionError(f"SHARED reassembly shape {shared.data.shape} != "
                             f"LOCAL {local.data.shape}")
    if not np.array_equal(shared.data, local.data) or shared.num != local.num:
        raise AssertionError("full size: SHARED_FRAME total differs from LOCAL")


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))

    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    from repro_torch.kernels import bfs_frontier as bfs_mod
    from repro_torch.kernels import build
    from repro_torch.kernels import frame_accum as accum_mod
    t0 = time.time()
    build.build_all()
    emit({"phase": "build", "nvcc_s": time.time() - t0,
          "flags": " ".join(build.NVCC_FLAGS)})

    from repro_torch.graphs import erdos_renyi
    t0 = time.time()
    g = erdos_renyi(FULL_N, FULL_M, seed=0, device="cuda")
    emit({"phase": "graph", "n": g.n, "arcs": g.m_arcs,
          "max_degree": g.max_degree, "build_s": time.time() - t0})

    rows = phase_kernels(torch, Timer(torch), g)

    # the main path: launches counted from here to the end of phase 5
    accum_mod.launches = 0
    bfs_mod.launches = 0
    phase_accuracy(torch)
    phase_full(torch, g)
    launches = {"frame_accum": accum_mod.launches,
                "bfs_frontier": bfs_mod.launches}

    meta = {
        "frame_accum": ("src/repro_torch/kernels/csrc/frame_accum.cu",
                        "src/repro/kernels/frame_accum.py:28"),
        "bfs_frontier": ("src/repro_torch/kernels/csrc/bfs_frontier.cu",
                         "src/repro/kernels/bfs_frontier.py:40"),
    }
    kernels = [{"name": name, "route": "cuda", "source": meta[name][0],
                "replaces": meta[name][1], "launches": launches[name],
                **rows[name]} for name in ("frame_accum", "bfs_frontier")]
    for k in kernels:
        if k["launches"] <= 0:
            raise AssertionError(f"{k['name']} was not launched on the main path")
    leaked = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if leaked:
        raise AssertionError(f"the port imported {leaked}")
    emit({"kernels": kernels})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
