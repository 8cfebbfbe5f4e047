#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines (``{"phase": ...}``); any failure raises
and the script exits non-zero:

1. device      — the card (nvidia-smi name and power limit), torch and CUDA.
2. build       — nvcc builds the three kernels from
                 ``src/repro_torch/kernels/csrc``, all at once.
3. wrs table   — the 2**24-item alias table of the wrs full-size run
                 (Pareto(1.5) weights, the host's Vose loop, then the card).
4. kernels     — each kernel against its plain PyTorch version at the main
                 paths' full-size shapes, with times (CUDA events, median),
                 the bound and one library call as a yardstick where there
                 is one: ``frame_accum`` at (4, 2**20) and at the wrs
                 path's (4, 2**24) and (4, 1) int32 frames; ``alias_draw``
                 exactly (``torch.equal``) at n = 2**24 with b = 262,144,
                 65,536 and 2**24 draws, and on the edge uniforms 0 and
                 1−2⁻²⁴ at n = 1000.
5. accuracy    — KADABRA on erdos_renyi(1000, 5000) for all five strategies
                 within ε of exact Brandes; INDEXED_FRAME bit-identical for
                 W ∈ {1, 2, 4}; τ a whole number of frame units; SHARED == LOCAL.
6. full size   — KADABRA on erdos_renyi(2**20, 8·2**20), ε = 0.02, δ = 0.1,
                 batch 64, W = 4, 4 rounds per epoch, LOCAL and SHARED.
7. conformance — the instance layer's ``run_all`` on the card: 6 instances
                 × 5 strategies × W ∈ {1, 2, 4} at the registry's sizes, one
                 line per instance; any failed cell or cross check raises.
8. wrs full    — weighted-mean estimation over 2**24 items, rtol 0.001,
                 batch 65,536 per worker, LOCAL and SHARED at W = 4 and
                 INDEXED at W = 1 and 4: within 2·rtol·μ of the exact mean,
                 SHARED == LOCAL, INDEXED W = 1 == W = 4.
9. kernels     — every kernel with its launches on the three paths (phases
                 5–6, 7 and 8), each counted from 0 just before its path.

While phases 5–8 run, the kernels behind ``kernels.ops`` are wrapped so
that their calls are held against the plain versions on the same tensors:
every call on the conformance path, and elsewhere each call whose kernel,
shapes and types phase 4 or an earlier call has not compared yet.

Then the card's name and power limit, then the result line
``{"ok": true, "device": {...}}``.  Imports no JAX and nothing of ``repro``.
"""

from __future__ import annotations

import contextlib
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

WRS_ITEMS = 2 ** 24
WRS_WORLD = 4
WRS_BATCH = 65_536          # draws per worker per round


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


class PlainCheck:
    """Holds the port's kernels against their plain versions on the same
    tensors.  ``compare_*`` checks one kernel result; ``installed()`` wraps
    the three kernels behind ``kernels.ops`` for the length of a path, so
    that each call there is compared when its key (kernel, shapes, types)
    has not been compared in this run yet, or always with ``every``.  The
    kernel still runs once a call; the plain versions launch none of the
    port's kernels, so they move no count."""

    NAMES = ("frame_accum", "bfs_frontier", "alias_draw")
    TOLERANCE = {
        "frame_accum": "int32 exact; float32 rtol 1e-6 atol 1e-6; "
                       "bfloat16 rtol 2e-2 atol 1e-2",
        # the plain version sums with atomics in arrival order
        "bfs_frontier": "rtol 1e-5, {agg > 0} equal",
        "alias_draw": "exact (torch.equal)",
    }

    def __init__(self, torch):
        self.torch = torch
        self.seen = set()
        self.max_err = dict.fromkeys(self.NAMES, 0.0)
        self.calls = dict.fromkeys(self.NAMES, 0)

    def _done(self, name, key, got, exp):
        self.seen.add(key)
        self.calls[name] += 1
        err = float((got.float() - exp.float()).abs().max()) if got.numel() else 0.0
        self.max_err[name] = max(self.max_err[name], err)

    def compare_frame_accum(self, frames, got):
        from repro_torch.kernels import ref
        torch = self.torch
        exp = ref.frame_accum_ref(frames)
        torch.cuda.synchronize()
        tol = {torch.float32: (1e-6, 1e-6), torch.bfloat16: (2e-2, 1e-2)}
        rtol, atol = tol.get(frames.dtype, (0.0, 0.0))
        torch.testing.assert_close(got, exp, rtol=rtol, atol=atol,
                                   msg=lambda m: f"frame_accum {tuple(frames.shape)} "
                                                 f"{frames.dtype}: {m}")
        self._done("frame_accum", ("frame_accum", frames.dtype,
                                   tuple(frames.shape)), got, exp)

    def compare_bfs(self, indptr, indices, sigma, dist, level, got):
        """The plain version runs over the COO arcs of the kernel's own CSR,
        16 lanes at a time (its (B, m) gathers)."""
        from repro_torch.kernels import ref
        torch = self.torch
        n = indptr.numel() - 1
        m = int(indptr[-1])
        src = torch.repeat_interleave(
            torch.arange(n, device=indptr.device, dtype=torch.int32),
            (indptr[1:] - indptr[:-1]).long())
        dst = indices[:m]
        exp = torch.cat([ref.bfs_frontier_ref(src, dst, sigma[i:i + 16],
                                              dist[i:i + 16], level)
                         for i in range(0, sigma.shape[0], 16)])
        torch.cuda.synchronize()
        torch.testing.assert_close(got, exp, rtol=1e-5, atol=0.0,
                                   msg=lambda msg: f"bfs_frontier "
                                                   f"{tuple(sigma.shape)} level "
                                                   f"{level}: {msg}")
        if not torch.equal(got > 0, exp > 0):
            raise AssertionError(f"bfs_frontier {tuple(sigma.shape)}: "
                                 f"{{agg > 0}} differs at level {level}")
        self._done("bfs_frontier", ("bfs_frontier", tuple(sigma.shape),
                                    indices.numel()), got, exp)

    def compare_alias(self, prob, alias, u1, u2, got):
        from repro_torch.kernels import ref
        torch = self.torch
        exp = ref.alias_draw_ref(prob, alias, u1, u2)
        torch.cuda.synchronize()
        if not torch.equal(got, exp):
            raise AssertionError(f"alias_draw differs from its plain version at "
                                 f"n = {prob.numel()}, b = {u1.numel()}: "
                                 f"{int((got != exp).sum())} draws")
        self._done("alias_draw", ("alias_draw", prob.numel(), u1.numel()),
                   got, exp)

    @contextlib.contextmanager
    def installed(self, every: bool):
        """Compare the kernels' calls while the block runs; yields the
        number of comparisons made in it, by kernel."""
        from repro_torch.kernels import ops
        torch = self.torch
        kernels = {"frame_accum": ops._accum_kernel,
                   "bfs_frontier": ops._bfs_kernel,
                   "alias_draw": ops._alias_kernel}
        made = dict.fromkeys(self.NAMES, 0)

        def wrap(name, key_of, compare):
            kernel = kernels[name]

            def call(*args):
                got = kernel(*args)
                if every or key_of(*args) not in self.seen:
                    compare(*args, got)
                    made[name] += 1
                return got
            return call

        patched = {
            "_accum_kernel": wrap(
                "frame_accum",
                lambda f: ("frame_accum", f.dtype, tuple(f.shape)),
                self.compare_frame_accum),
            "_bfs_kernel": wrap(
                "bfs_frontier",
                lambda ip, ix, s, d, lv: ("bfs_frontier", tuple(s.shape),
                                          ix.numel()),
                self.compare_bfs),
            "_alias_kernel": wrap(
                "alias_draw",
                lambda p, a, u1, u2: ("alias_draw", p.numel(), u1.numel()),
                self.compare_alias),
        }
        saved = {attr: getattr(ops, attr) for attr in patched}
        for attr, fn in patched.items():
            setattr(ops, attr, fn)
        try:
            yield made
        finally:
            for attr, fn in saved.items():
                setattr(ops, attr, fn)
            torch.cuda.synchronize()


def profiled(torch, fn) -> dict:
    """Run ``fn`` once under ``torch.profiler`` and report the wall time,
    the summed time of the device's activities (kernels, copies and sets on
    one stream, so they do not overlap), the busy share, and the five
    activities that took the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.time()
        fn()
        torch.cuda.synchronize()
        wall = time.time() - t0
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            ms, count = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, count + 1)
    device_ms = sum(ms for ms, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:5]
    return {"profiled_wall_s": wall, "device_ms": device_ms,
            "device_busy_share": device_ms / 1e3 / wall if by_name else None,
            "device_events": sum(c for _, c in by_name.values()),
            "top_device": [{"name": name[:80], "ms": ms, "count": count}
                           for name, (ms, count) in top]}


def phase_kernels(torch, timer, check, g, table):
    from repro_torch.graphs.bfs import bfs_sssp
    from repro_torch.kernels import ref
    from repro_torch.kernels.bfs_frontier import bfs_frontier
    from repro_torch.kernels.frame_accum import frame_accum

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    # frame_accum at the kadabra path's (W=4, n=2^20) per-vertex counts, and
    # at the wrs full path's (4, 2^24) int32 hist and (4, 1) scalar leaves
    W, n = 4, FULL_N
    shapes = [(torch.int32, (W, n)), (torch.float32, (W, n)),
              (torch.bfloat16, (W, n)), (torch.int32, (WRS_WORLD, WRS_ITEMS)),
              (torch.int32, (WRS_WORLD, 1))]
    for dtype, shape in shapes:
        if dtype == torch.int32:
            x = torch.randint(0, 2 ** 20, shape, generator=gen, device="cuda",
                              dtype=dtype)
        else:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        check.compare_frame_accum(x, frame_accum(x))
        del x
    x = torch.randint(0, 1000, (W, n), generator=gen, device="cuda",
                      dtype=torch.int32)
    t_bound, by = bound_ms((W + 1) * n * 4, (W - 1) * n)
    rows["frame_accum"] = {
        "ms": timer(lambda: frame_accum(x)),
        "plain_ms": timer(lambda: ref.frame_accum_ref(x)),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": timer(lambda: torch.sum(x, dim=0, dtype=torch.int32)),
    }
    emit({"phase": "kernels", "kernel": "frame_accum", "shape": [W, n],
          "checked": [[str(d).split(".")[-1], list(sh)] for d, sh in shapes],
          "max_abs_err": check.max_err["frame_accum"],
          "tolerance": check.TOLERANCE["frame_accum"], **rows["frame_accum"]})

    # bfs_frontier on the full graph, B = 256 lanes, at levels of a real BFS
    B = LANES
    src_v = torch.randint(0, g.n, (B,), generator=gen, device="cuda")
    deg = (g.indptr[1:] - g.indptr[:-1]).float()
    chunk = 16  # the plain version's (B, m) gathers are run 16 lanes at a time

    def plain(sigma, dist, level):
        return torch.cat([ref.bfs_frontier_ref(g.src, g.dst, sigma[i:i + chunk],
                                               dist[i:i + chunk], level)
                          for i in range(0, B, chunk)])

    timed = None
    for level in (0, 2, 4, 5):
        dist, sigma = bfs_sssp(g, src_v, None, max_levels=level,
                               early_exit=False, device="cuda")
        check.compare_bfs(g.indptr, g.indices_padded, sigma, dist, level,
                          bfs_frontier(g.indptr, g.indices_padded, sigma,
                                       dist, level))
        if level == 4:
            timed = (dist, sigma, level)
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
        "ms": timer(lambda: bfs_frontier(g.indptr, g.indices_padded, sigma,
                                         dist, level)),
        "plain_ms": timer(lambda: plain(sigma, dist, level), reps=5, warmup=1),
        "bound_ms": t_bound, "bound_by": by,
        "library_ms": timer(lambda: torch.sparse.mm(adj, masked_t)),
    }
    emit({"phase": "kernels", "kernel": "bfs_frontier",
          "shape": {"lanes": B, "n": g.n, "arcs": g.m_arcs, "timed_level": level,
                    "frontier_entries": int(front.sum())},
          "levels_checked": [0, 2, 4, 5],
          "max_abs_err": check.max_err["bfs_frontier"],
          "tolerance": check.TOLERANCE["bfs_frontier"],
          "library": "torch.sparse.mm(CSR adjacency, pre-masked sigma^T)",
          **rows["bfs_frontier"]})
    del adj, masked_t, dist, sigma, front
    torch.cuda.empty_cache()
    rows["alias_draw"] = kernel_alias_draw(torch, timer, check, gen, table)
    return rows


def kernel_alias_draw(torch, timer, check, gen, table):
    """``alias_draw`` against its plain version, exactly, at the wrs main
    path's shapes (the 2**24 table, W·batch draws and one worker's batch)
    and at 2**24 draws, and on the edge uniforms at n = 1000."""
    import numpy as np

    from repro_torch.kernels import ref
    from repro_torch.kernels.alias_draw import alias_draw
    from repro_torch.sampling import build_alias_table

    edge = np.array([0.0, np.nextafter(np.float32(1), np.float32(0))], np.float32)
    small = build_alias_table(np.random.default_rng(1).pareto(1.5, 1000) + 1e-3,
                              device="cuda")
    u1 = torch.rand(4096, generator=gen, device="cuda")
    u2 = torch.rand(4096, generator=gen, device="cuda")
    u1[:4] = torch.from_numpy(edge[[0, 1, 0, 1]]).cuda()
    u2[:4] = torch.from_numpy(edge[[0, 0, 1, 1]]).cuda()
    got = alias_draw(small.prob, small.alias, u1, u2)
    check.compare_alias(small.prob, small.alias, u1, u2, got)
    edge_idx = got[:4].tolist()

    n = table.n
    u1 = torch.rand(WRS_BATCH, generator=gen, device="cuda")
    u2 = torch.rand(WRS_BATCH, generator=gen, device="cuda")
    check.compare_alias(table.prob, table.alias, u1, u2,
                        alias_draw(table.prob, table.alias, u1, u2))
    row = None
    for b in (WRS_WORLD * WRS_BATCH, n):
        u1 = torch.rand(b, generator=gen, device="cuda")
        u2 = torch.rand(b, generator=gen, device="cuda")
        got = alias_draw(table.prob, table.alias, u1, u2)
        check.compare_alias(table.prob, table.alias, u1, u2, got)
        bucket = (u1 * n).to(torch.int32).clamp(0, n - 1)
        reject = u2 >= table.prob[bucket.long()]
        distinct = int(torch.unique(bucket).numel())
        distinct_rejected = int(torch.unique(bucket[reject]).numel())
        rejected = int(reject.sum())
        # streamed u1, u2, idx + prob for each distinct bucket + alias for
        # each distinct bucket of a rejected draw; one multiply, one
        # compare a draw
        t_bound, by = bound_ms(12 * b + 4 * distinct + 4 * distinct_rejected,
                               2 * b)
        timed = {
            "ms": timer(lambda: alias_draw(table.prob, table.alias, u1, u2)),
            "plain_ms": timer(lambda: ref.alias_draw_ref(table.prob, table.alias,
                                                         u1, u2)),
            "bound_ms": t_bound, "bound_by": by, "library_ms": None,
        }
        # each random 4-byte gather of a table larger than L2 is a 32 B sector
        sector_ms = (12 * b + 32 * (b + rejected)) / HBM_BYTES_PER_S * 1e3
        emit({"phase": "kernels", "kernel": "alias_draw",
              "shape": {"n": n, "draws": b, "distinct_buckets": distinct,
                        "rejected_draws": rejected,
                        "distinct_rejected_buckets": distinct_rejected},
              "max_abs_err": check.max_err["alias_draw"],
              "tolerance": check.TOLERANCE["alias_draw"],
              "edge_uniforms_n1000_idx": edge_idx,
              "library": "none (no single PyTorch call)",
              "sector_bound_ms": sector_ms, **timed})
        if row is None:
            row = timed
        else:
            row["ms_2e24_draws"] = timed["ms"]
            row["plain_ms_2e24_draws"] = timed["plain_ms"]
            row["bound_ms_2e24_draws"] = timed["bound_ms"]
        del u1, u2, got, bucket, reject
    torch.cuda.empty_cache()
    return row


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
    prof = profiled(torch, lambda: run_kadabra(
        g, params, strategy=FS.LOCAL_FRAME, world=world, seed=0, pre=pre,
        device="cuda"))
    emit({"phase": "full", "strategy": "local", "world": world,
          "profile": prof})
    local, shared = out[FS.LOCAL_FRAME], out[FS.SHARED_FRAME]
    if shared.data.shape != local.data.shape:
        raise AssertionError(f"SHARED reassembly shape {shared.data.shape} != "
                             f"LOCAL {local.data.shape}")
    if not np.array_equal(shared.data, local.data) or shared.num != local.num:
        raise AssertionError("full size: SHARED_FRAME total differs from LOCAL")


def wrs_full_instance():
    from repro_torch.core.instances import WeightedSamplingInstance
    # 2**16 draws per worker per round: H&S's fixed-batch regime; the
    # 128 MB table does not fit the 50 MB L2.  max_samples = 2**21 keeps
    # the int32 moment sums exact (2**21·31² < 2**31).
    return WeightedSamplingInstance(name="wrs-full", n_items=WRS_ITEMS,
                                    rtol=0.001, delta=0.1, batch=WRS_BATCH,
                                    rounds_per_epoch=2, max_samples=2 ** 21)


def phase_wrs_table(torch, inst):
    torch.cuda.synchronize()
    t0 = time.time()
    table, values, mu = inst._setup(torch.device("cuda"))
    torch.cuda.synchronize()
    build_s = time.time() - t0
    emit({"phase": "wrs table", "n_items": table.n, "mu": mu,
          "table_bytes": table.n * 8, "build_s": build_s})
    return table, build_s


def phase_conformance(torch):
    import numpy as np

    from repro_torch.core.conformance import run_all

    from repro_torch.core.instances import get_instance

    t0 = time.time()
    reports = run_all(worlds=(1, 2, 4), seed=0, device="cuda")
    failed = []
    for name, rep in reports.items():
        eps = get_instance(name).build(world=1, device="cuda").eps
        emit({"phase": "conformance", "instance": name,
              "cells_ok": sum(c.ok for c in rep.cells),
              "cells": len(rep.cells),
              "tau": {f"{c.strategy.value}-W{c.world}": c.num for c in rep.cells},
              "max_oracle_err": float(np.max([c.err_oracle for c in rep.cells])),
              "eps": eps, "cross_failures": rep.cross_failures})
        failed += rep.failures
    emit({"phase": "conformance", "instances": len(reports),
          "cells": sum(len(r.cells) for r in reports.values()),
          "wall_s": time.time() - t0})
    if failed:
        raise AssertionError("conformance failed:\n" + "\n".join(failed))


def phase_wrs_full(torch, inst, table_build_s):
    import numpy as np

    from repro_torch import device as dev_mod
    from repro_torch.core.frames import FrameStrategy as FS
    from repro_torch.core.instances import run_instance
    from repro_torch.kernels import alias_draw as alias_mod

    out = {}
    for strat, world in [(FS.LOCAL_FRAME, WRS_WORLD), (FS.SHARED_FRAME, WRS_WORLD),
                         (FS.INDEXED_FRAME, 1), (FS.INDEXED_FRAME, WRS_WORLD)]:
        torch.cuda.reset_peak_memory_stats()
        dev_mod.host_syncs = 0
        launched = alias_mod.launches
        torch.cuda.synchronize()
        t0 = time.time()
        est, res, built = run_instance(inst, strategy=strat, world=world,
                                       seed=0, device="cuda")
        torch.cuda.synchronize()
        wall = time.time() - t0
        mu = float(built.oracle[0])
        rel = abs(float(est[0]) - mu) / mu
        key = f"{strat.value}-W{world}"
        out[key] = (res, built.trim(res.data))
        emit({"phase": "wrs full", "run": key, "table_build_s": table_build_s,
              "tau": res.num, "epochs": res.epochs, "stopped": res.stopped,
              "wall_s": wall, "checked_samples_per_s": res.num / wall,
              "host_syncs_per_epoch": dev_mod.host_syncs / res.epochs,
              "alias_draw_launches": alias_mod.launches - launched,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
              "mu": mu, "mu_hat": float(est[0]), "rel_err": rel,
              "rtol": inst.rtol, "tau_reached_max_samples":
                  res.num >= inst.max_samples})
        if not res.stopped:
            raise AssertionError(f"wrs full {key}: the stop never fired")
        if abs(float(est[0]) - mu) > built.eps:
            raise AssertionError(f"wrs full {key}: |μ̂ − μ| = "
                                 f"{abs(float(est[0]) - mu)} > 2·rtol·μ = "
                                 f"{built.eps}")

    def same(a, b):
        (ra, da), (rb, db) = out[a], out[b]
        return ra.num == rb.num and all(np.array_equal(da[k], db[k])
                                        for k in ("s1", "s2", "hist"))

    if not same("local-W4", "shared-W4"):
        raise AssertionError("wrs full: SHARED_FRAME differs from LOCAL_FRAME")
    if not same("indexed-W1", "indexed-W4"):
        raise AssertionError("wrs full: INDEXED_FRAME W = 1 differs from W = 4")
    prof = profiled(torch, lambda: run_instance(
        inst, strategy=FS.LOCAL_FRAME, world=WRS_WORLD, seed=0, device="cuda"))
    emit({"phase": "wrs full", "run": f"local-W{WRS_WORLD}", "profile": prof})
    emit({"phase": "wrs full", "shared_equals_local": True,
          "indexed_bit_identical_W14": True})


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

    from repro_torch.kernels import alias_draw as alias_mod
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

    wrs = wrs_full_instance()
    table, table_build_s = phase_wrs_table(torch, wrs)

    check = PlainCheck(torch)
    rows = phase_kernels(torch, Timer(torch), check, g, table)

    mods = {"frame_accum": accum_mod, "bfs_frontier": bfs_mod,
            "alias_draw": alias_mod}

    def drive(path, run, needs, every=False):
        """Run one path with every count set to 0 just before it and read
        just after; each kernel in ``needs`` must have launched.  Its kernel
        calls are held against the plain versions: each call with
        ``every``, else each (kernel, shape, type) not yet compared."""
        with check.installed(every) as compared:
            for m in mods.values():
                m.launches = 0
            run()
            counts = {name: m.launches for name, m in mods.items()}
        emit({"phase": "launches", "path": path, **counts,
              "compared_with_plain": compared,
              "every_call_compared": every})
        for name in needs:
            if counts[name] <= 0:
                raise AssertionError(f"{name} was not launched on the {path} path")
        return counts

    by_path = {
        "kadabra": drive("kadabra", lambda: (phase_accuracy(torch),
                                             phase_full(torch, g)),
                         ("frame_accum", "bfs_frontier")),
        "conformance": drive("conformance", lambda: phase_conformance(torch),
                             tuple(mods), every=True),
        "wrs full": drive("wrs full",
                          lambda: phase_wrs_full(torch, wrs, table_build_s),
                          ("frame_accum", "alias_draw")),
    }

    meta = {
        "frame_accum": ("src/repro_torch/kernels/csrc/frame_accum.cu",
                        "src/repro/kernels/frame_accum.py:28"),
        "bfs_frontier": ("src/repro_torch/kernels/csrc/bfs_frontier.cu",
                         "src/repro/kernels/bfs_frontier.py:40"),
        "alias_draw": ("src/repro_torch/kernels/csrc/alias_draw.cu",
                       "src/repro/kernels/alias_draw.py:33"),
    }
    kernels = [{"name": name, "route": "cuda", "source": meta[name][0],
                "replaces": meta[name][1],
                "launches": sum(c[name] for c in by_path.values()),
                "launches_by_path": {p: c[name] for p, c in by_path.items()},
                **rows[name], "max_abs_err": check.max_err[name],
                "compared_with_plain": check.calls[name]} for name in mods]
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
