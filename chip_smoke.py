#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines (``{"phase": ...}``); any failure raises
and the script exits non-zero:

1. device      — the card (nvidia-smi name and power limit), torch and CUDA.
2. build       — nvcc builds the six kernels from
                 ``src/repro_torch/kernels/csrc``, all at once, and prints
                 ptxas's registers, spills and shared memory of the five
                 redesigned kernels (``bfs_frontier``, ``flash_attention``,
                 ``rglru_scan``, ``alias_draw``, ``frame_accum``) and the
                 bf16 attention body's HMMA/HGMMA count in the SASS
                 (``cuobjdump -sass``); a missing ptxas report, a spill or
                 a bf16 body without tensor-core instructions fails.
3. wrs table   — the 2**24-item alias table of the wrs full-size run
                 (Pareto(1.5) weights, the host's Vose loop, then the card).
4. kernels     — each kernel against its plain PyTorch version at the main
                 paths' full-size shapes, with times (CUDA events, median),
                 the bound and one library call as a yardstick where there
                 is one: ``frame_accum`` at (4, 2**20), at the wrs
                 path's (4, 2**24) and (4, 1) int32 frames and at the
                 conformance grid's commonest (2, 1), timed at all four
                 with the host's time a call beside; ``bfs_frontier``
                 at 256 lanes on the full graph, timed at levels 0–7 of one
                 BFS, with ``torch.sparse.mm`` at levels 2, 4 and 5;
                 ``alias_draw``
                 exactly (``torch.equal``) at n = 2**24 with b = 262,144,
                 65,536 and 2**24 draws, and on the edge uniforms 0 and
                 1−2⁻²⁴ at n = 1000; ``flash_attention`` at recurrentgemma's
                 prefill shape q (2, 10, 4096, 256), k/v (2, 1, 4096, 256),
                 window 2048, in bf16 and f32, at S = 100 and window 0,
                 in bf16 at ``adaptive_eval``'s (4, 10, 64, 256) and in
                 f32 at the prefill-vs-decode gate's (4, 10, 32, 256);
                 ``rglru_scan`` exactly at the prefill's (2, 4096, 2560),
                 timed there and at ``adaptive_eval``'s (4, 64, 2560), and
                 at a ragged (3, 100, 1000) and (1, 7, 1001); ``ssm_scan``
                 exactly at falcon-mamba-7b's prefill (2, 4096, 8192, 16),
                 at ``adaptive_eval``'s (4, 64, 8192, 16) (both timed) and
                 at a ragged (3, 100, 125, 3).
5. accuracy    — KADABRA on erdos_renyi(1000, 5000) for all five strategies
                 within ε of exact Brandes; INDEXED_FRAME bit-identical for
                 W ∈ {1, 2, 4}; τ a whole number of frame units; SHARED == LOCAL.
6. full size   — KADABRA on erdos_renyi(2**20, 8·2**20), ε = 0.02, δ = 0.1,
                 batch 64, W = 4, 4 rounds per epoch, LOCAL and SHARED; the
                 LOCAL run's ``bfs_frontier`` calls by level, weighted by
                 phase 4's time at each level (an estimate, on the phase's
                 own line), beside the kernel's device time in a profile of
                 the LOCAL run (measured, also in the kernels line).
7. conformance — the instance layer's ``run_all`` on the card: 6 instances
                 × 5 strategies × W ∈ {1, 2, 4} at the registry's sizes, one
                 line per instance; any failed cell or cross check raises.
8. wrs full    — weighted-mean estimation over 2**24 items, rtol 0.001,
                 batch 65,536 per worker, LOCAL and SHARED at W = 4 and
                 INDEXED at W = 1 and 4: within 2·rtol·μ of the exact mean,
                 SHARED == LOCAL, INDEXED W = 1 == W = 4.
9. pool        — the adaptive-query pool (``repro_torch.serve``) at full
                 size: kadabra-full (phase 6's graph and configuration) and
                 wrs-full (phase 8's table) registered as instances, the
                 queries ``POOL_QUERIES`` (kadabra-full SHARED and LOCAL at
                 W = 4, wrs-full SHARED and INDEXED at W = 4, and the CLI's
                 wrs:local:2 and triangles:local:2:1) through
                 ``EpochScheduler`` (2 in flight, a pool of 4 worker slots,
                 shrink-regrow pressure, a checkpoint every tick), in an
                 order in which a full-size SHARED session is shrunk and
                 later regrown; each query's (τ, estimate, stop epoch) equal
                 to its solo session's and each solo session's to
                 ``run_instance``'s; a second drain stopped after 2 ticks
                 and resumed from its checkpoints, with the same results;
                 one checkpoint of the kadabra-full SHARED session timed
                 (save, restore, bytes); ``--pool``, then ``--resume``.
9a. substrate  — the shard_map substrate (``torch.distributed``, one worker
                 a process) at phase 6's size: kadabra-full LOCAL and SHARED
                 in one NCCL rank against VMAP and SEQUENTIAL at W = 1; in W
                 gloo ranks sharing the card (NCCL puts one rank on each
                 card) at W = 2 (LOCAL, SHARED) and W = 4 (LOCAL, SHARED
                 F = 4, SHARED F = 2 — the grouped reduce-scatter and
                 all-reduce —, INDEXED) against VMAP at the same W and
                 INDEXED W = 4 against W = 1; then the six registered
                 instances' substrate-equivalence grid at W = 1 (NCCL) and
                 W ∈ {2, 4} (gloo).  The graph goes to the ranks as files;
                 each rank holds its kernel calls against the plain
                 versions, counts its launches and checks that it imported
                 no jax or repro.  W processes on one card: no line is a
                 multi-GPU number.
10. rg serve   — recurrentgemma-2b at full width (26 layers, d 2560, vocab
                 256,000, bf16, random weights from seed 0) through the
                 port's serving entry points: ``make_prefill_step`` on
                 B = 2, S = 4096 (twice the local window) with a profile;
                 ``generate`` at B = 4, prompt 32, gen 16, with a profile;
                 prefill's last logits against 32 decode steps of the same
                 prompt, in bf16 and in f32; ``adaptive_eval`` at B = 4,
                 seq 64, ε = 0.5, δ = 0.1, and a profile of one sample.
11. mamba serve — falcon-mamba-7b at full width and depth (64 layers,
                 d 4096, d_inner 8192, N 16, vocab 65,024, bf16, random
                 weights from seed 0), once recurrentgemma's model is freed,
                 through the same steps as phase 10: prefill B = 2, S = 4096,
                 ``generate``, prefill against decode, ``adaptive_eval``.
12. kernels    — every kernel with its launches on the seven paths (phases
                 5–6, 7, 8, 9, 9a — this process's and its worker
                 processes' —, 10 and 11), each counted from 0 just before
                 its path; each path's line also splits its kernel calls by
                 shape.

While phases 5–11 run, in this process and in the worker processes of 9a,
the kernels behind ``kernels.ops`` are wrapped so
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
# at import, so that the worker processes of the substrate phase, which
# import this script without running main(), find the port too
sys.path.insert(0, str(SRC))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory
F32_OPS_PER_S = 67e12       # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12     # H100 SXM bf16 tensor cores, dense

FULL_N = 2 ** 20
FULL_M = 8 * 2 ** 20
LANES = 256                 # W · batch of the full-size run

WRS_ITEMS = 2 ** 24
WRS_WORLD = 4
WRS_BATCH = 65_536          # draws per worker per round

RG_ARCH = "recurrentgemma-2b"
RG_PREFILL = (2, 4096)      # batch, prompt length: twice the local window
RG_PARAMS = 3_549_934_080
SERVE_GEN = (4, 32, 16)     # the serving CLI's defaults: batch, prompt, gen
SERVE_EVAL = {"batch": 4, "seq": 64, "eps": 0.5, "delta": 0.1}
# prefill against decode, gates on |Δ|max / |logit|max: f32 1e-3 (a wrong
# kernel moves the logits by their own size; ≤ 2e-7 measured on the reduced
# configs on the CPU), bf16 0.15 (the two paths round at other places, over
# all the layers; 0.009–0.019 on the reduced configs)
SERVE_GATES = {"bf16": 0.15, "f32": 1e-3}

MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_PREFILL = (2, 4096)   # batch, prompt length
# the parameters the model holds; the config's closed form leaves out each
# layer's conv_b and the final norm (64·8192 + 4096 = 528,384 fewer)
MAMBA_PARAMS = 7_272_665_088


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def bound_ms(nbytes: float, ops: float, ops_per_s: float = F32_OPS_PER_S):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / ops_per_s * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


KERNEL_NAMES = {  # device kernels of the port's wrappers, by name part
    "frame_accum": ("frame_accum",),
    "bfs_frontier": ("bfs_pack_kernel", "bfs_pull_kernel"),
    "alias_draw": ("alias_draw_kernel",),
    "flash_attention": ("flash_bf16_kernel", "flash_f32_kernel"),
    "rglru_scan": ("rglru_scan_kernel",),
    "ssm_scan": ("ssm_scan",),
}


def kernel_label(mangled: str) -> str:
    """``flash_f32_kernel<256, 4>`` from a mangled kernel name of the port:
    the last length-prefixed identifier that starts with a name part in
    ``KERNEL_NAMES`` and is followed by its template arguments or the end
    of its nested name, and those template arguments (int literals,
    builtin types and plain names)."""
    import re

    parts = "|".join(p for ps in KERNEL_NAMES.values() for p in ps)
    found = None
    for m in re.finditer(rf"\d+(?={parts})", mangled):
        digits = m.group()
        for k in range(len(digits)):  # the length may be a suffix of the run
            end = m.end() + int(digits[k:])
            name = mangled[m.end():end]
            if re.fullmatch(r"[a-z0-9_]+", name) and mangled[end:end + 1] in "IE":
                found = (name, end)
                break
    if found is None:
        return mangled
    name, i = found
    args = []
    if mangled[i:i + 1] == "I":
        i += 1
        while i < len(mangled) and mangled[i] != "E":
            if mangled[i] == "L":                    # L<type><value>E
                end = mangled.index("E", i)
                args.append(mangled[i + 2:end])
                i = end + 1
            elif mangled[i].isdigit():               # <length><name>
                digits = re.match(r"\d+", mangled[i:]).group()
                i += len(digits)
                args.append(mangled[i:i + int(digits)])
                i += int(digits)
            else:                                    # a builtin type
                args.append({"i": "int", "f": "float"}.get(mangled[i], mangled[i]))
                i += 1
    return name + (f"<{', '.join(args)}>" if args else "")


def ptxas_report(log: str) -> list:
    """Registers, spills and static shared memory of each kernel in nvcc's
    ``-Xptxas -v`` output."""
    import re

    out = []
    for part in log.split("Compiling entry function '")[1:]:
        label = kernel_label(part.split("'", 1)[0])
        regs = re.search(r"Used (\d+) registers", part)
        spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", part)
        smem = re.search(r"(\d+) bytes smem", part)
        out.append({"kernel": label, "registers": int(regs.group(1)) if regs else None,
                    "spill_stores": int(spill.group(1)) if spill else None,
                    "spill_loads": int(spill.group(2)) if spill else None,
                    "static_smem": int(smem.group(1)) if smem else 0})
    return out


def sass_mma_counts(lib: Path, nvcc: str) -> dict | None:
    """``HMMA``/``HGMMA`` instructions in the SASS of each kernel of a built
    library, by ``cuobjdump -sass``; None where the toolkit has none."""
    import re
    import shutil

    tool = Path(nvcc).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=120).stdout
    counts = {}
    for part in sass.split("Function : ")[1:]:
        label = kernel_label(part.split("\n", 1)[0].strip())
        counts[label] = {"HMMA": len(re.findall(r"\bHMMA\.", part)),
                         "HGMMA": len(re.findall(r"\bHGMMA\.", part))}
    return counts


def phase_build(torch) -> None:
    """Build every kernel at once; print ptxas's registers, spills and
    shared memory of the five redesigned kernels (from the log kept beside
    each library, so also when it was built before) and the bf16 attention
    body's tensor-core instructions in the SASS.  A missing report, a spill
    or a bf16 body without tensor-core instructions fails."""
    from repro_torch.kernels import build

    t0 = time.time()
    build.build_all()
    emit({"phase": "build", "nvcc_s": time.time() - t0,
          "flags": " ".join(build.NVCC_FLAGS)})
    for name in ("bfs_frontier", "flash_attention", "rglru_scan", "alias_draw",
                 "frame_accum"):
        report = ptxas_report(build.ptxas_log(name))
        emit({"phase": "build", "source": f"csrc/{name}.cu", "ptxas": report})
        if not report or any(r["spill_stores"] != 0 or r["spill_loads"] != 0
                             for r in report):
            raise AssertionError(f"csrc/{name}.cu: no ptxas report, or a "
                                 f"kernel spills: {report}")
    mma = sass_mma_counts(build.library_path("flash_attention"), build._nvcc())
    emit({"phase": "build", "source": "csrc/flash_attention.cu",
          "sass_tensor_core_ops": mma})
    if mma is not None:
        bf16 = {k: c for k, c in mma.items() if "flash_bf16" in k}
        if not bf16 or not all(c["HMMA"] + c["HGMMA"] > 0 for c in bf16.values()):
            raise AssertionError(f"flash_attention bf16: no tensor-core "
                                 f"instructions in its SASS: {mma}")


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
    the kernels behind ``kernels.ops`` for the length of a path, so
    that each call there is compared when its key (kernel, shapes, types)
    has not been compared in this run yet, or always with ``every``.  The
    kernel still runs once a call; the plain versions launch none of the
    port's kernels, so they move no count."""

    NAMES = ("frame_accum", "bfs_frontier", "alias_draw", "flash_attention",
             "rglru_scan", "ssm_scan")
    TOLERANCE = {
        "frame_accum": "int32 exact; float32 rtol 1e-6 atol 1e-6; "
                       "bfloat16 rtol 2e-2 atol 1e-2",
        # the plain version sums with atomics in arrival order
        "bfs_frontier": "rtol 1e-5, {agg > 0} equal",
        "alias_draw": "exact (torch.equal)",
        # f32 in both, summed in other orders; bf16: one rounding of the
        # f32 output (the reference's kernel tests use 2e-5 and 2e-2)
        "flash_attention": "float32 rtol 1e-5 atol 1e-5; "
                           "bfloat16 rtol 2e-2 atol 2e-2",
        "rglru_scan": "exact (torch.equal; one FMA a step in both)",
        "ssm_scan": "exact (torch.equal; one FMA a step in both)",
    }
    FLASH_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}

    def __init__(self, torch):
        self.torch = torch
        self.seen = set()
        self.max_err = dict.fromkeys(self.NAMES, 0.0)
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.compare_s = 0.0  # host seconds spent in the comparisons

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

    @staticmethod
    def flash_key(q, k, v, window):
        return ("flash_attention", str(q.dtype), tuple(q.shape),
                tuple(k.shape), window)

    def compare_flash(self, q, k, v, window, got):
        from repro_torch.kernels import ref
        torch = self.torch
        exp = ref.flash_attention_ref(q, k, v, window=window)
        torch.cuda.synchronize()
        tol = self.FLASH_TOL[str(q.dtype)]
        torch.testing.assert_close(got, exp, rtol=tol, atol=tol,
                                   msg=lambda m: f"flash_attention q "
                                                 f"{tuple(q.shape)} k "
                                                 f"{tuple(k.shape)} {q.dtype} "
                                                 f"window {window}: {m}")
        self._done("flash_attention", self.flash_key(q, k, v, window), got, exp)

    def compare_rglru(self, a, b, got):
        from repro_torch.kernels import ref
        torch = self.torch
        exp = ref.rglru_scan_ref(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, exp):
            raise AssertionError(f"rglru_scan differs from its plain version "
                                 f"at {tuple(a.shape)}: "
                                 f"{int((got != exp).sum())} values")
        self._done("rglru_scan", ("rglru_scan", tuple(a.shape)), got, exp)

    def compare_ssm(self, a, b, got):
        from repro_torch.kernels import ref
        torch = self.torch
        exp = ref.ssm_scan_ref(a, b)
        torch.cuda.synchronize()
        if not torch.equal(got, exp):
            raise AssertionError(f"ssm_scan differs from its plain version "
                                 f"at {tuple(a.shape)}: "
                                 f"{int((got != exp).sum())} values")
        self._done("ssm_scan", ("ssm_scan", tuple(a.shape)), got, exp)

    @contextlib.contextmanager
    def installed(self, every: bool):
        """Compare the kernels' calls while the block runs; yields the
        number of comparisons made in it, by kernel, and the number of
        calls by kernel and key (shapes, and type where it has one)."""
        from repro_torch.kernels import ops
        torch = self.torch
        kernels = {"frame_accum": ops._accum_kernel,
                   "bfs_frontier": ops._bfs_kernel,
                   "alias_draw": ops._alias_kernel,
                   "flash_attention": ops._flash_kernel,
                   "rglru_scan": ops._rglru_kernel,
                   "ssm_scan": ops._ssm_kernel}
        made = dict.fromkeys(self.NAMES, 0)
        by_shape = {name: {} for name in self.NAMES}

        def wrap(name, key_of, compare):
            kernel = kernels[name]

            def call(*args, **kwargs):
                got = kernel(*args, **kwargs)
                args = args + tuple(kwargs.values())
                key = key_of(*args)
                shape = str(key[1] if len(key) == 2 else key[1:])
                by_shape[name][shape] = by_shape[name].get(shape, 0) + 1
                if every or key not in self.seen:
                    t0 = time.time()
                    compare(*args, got)
                    self.compare_s += time.time() - t0
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
            "_flash_kernel": wrap("flash_attention", self.flash_key,
                                  self.compare_flash),
            "_rglru_kernel": wrap(
                "rglru_scan", lambda a, b: ("rglru_scan", tuple(a.shape)),
                self.compare_rglru),
            "_ssm_kernel": wrap(
                "ssm_scan", lambda a, b: ("ssm_scan", tuple(a.shape)),
                self.compare_ssm),
        }
        saved = {attr: getattr(ops, attr) for attr in patched}
        for attr, fn in patched.items():
            setattr(ops, attr, fn)
        try:
            yield made, by_shape
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
    ours = {}
    for kernel, parts in KERNEL_NAMES.items():
        hit = [(ms, c) for name, (ms, c) in by_name.items()
               if any(p in name for p in parts)]
        if hit:
            ours[kernel] = {"ms": sum(ms for ms, _ in hit),
                            "device_launches": sum(c for _, c in hit)}
    return {"profiled_wall_s": wall, "device_ms": device_ms,
            "device_busy_share": device_ms / 1e3 / wall if by_name else None,
            "device_events": sum(c for _, c in by_name.values()),
            "top_device": [{"name": name[:80], "ms": ms, "count": count}
                           for name, (ms, count) in top],
            "port_kernels": ours}


def device_ms_by(torch, fn, parts, reps: int = 3) -> dict:
    """Mean device time a call of ``fn`` (warm, under ``torch.profiler``)
    of the kernels whose names hold each of ``parts``."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    ms = dict.fromkeys(parts, 0.0)
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            for part in parts:
                if part in e.name:
                    ms[part] += e.time_range.elapsed_us() / 1e3 / reps
    return ms


def phase_kernels(torch, timer, check, g, table):
    from repro_torch.kernels import ref
    from repro_torch.kernels.frame_accum import frame_accum
    from repro_torch.launch.time_kernels import loop_us

    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    rows = {}

    # frame_accum at the kadabra path's (W=4, n=2^20) per-vertex counts, at
    # the wrs full path's (4, 2^24) int32 hist and (4, 1) scalar leaves, and
    # at conformance's commonest frame (2, 1)
    W, n = 4, FULL_N
    shapes = [(torch.int32, (W, n)), (torch.float32, (W, n)),
              (torch.bfloat16, (W, n)), (torch.int32, (WRS_WORLD, WRS_ITEMS)),
              (torch.int32, (WRS_WORLD, 1)), (torch.int32, (2, 1))]
    for dtype, shape in shapes:
        if dtype == torch.int32:
            x = torch.randint(0, 2 ** 20, shape, generator=gen, device="cuda",
                              dtype=dtype)
        else:
            x = torch.randn(shape, generator=gen, device="cuda").to(dtype)
        check.compare_frame_accum(x, frame_accum(x))
        del x
    # timed in int32 at the kadabra path's (4, 2^20), the wrs path's
    # (4, 2^24) and (4, 1), and conformance's commonest frame (2, 1); the
    # small ones are bound by the host's time a call (loop_us)
    timed = {}
    for shape in ((W, n), (WRS_WORLD, WRS_ITEMS), (WRS_WORLD, 1), (2, 1)):
        x = torch.randint(0, 1000, shape, generator=gen, device="cuda",
                          dtype=torch.int32)
        w, m = shape
        t_bound, by = bound_ms((w + 1) * m * 4, (w - 1) * m)
        timed[shape] = {
            "ms": timer(lambda: frame_accum(x)),
            "loop_us": loop_us(lambda: frame_accum(x)),
            "plain_ms": timer(lambda: ref.frame_accum_ref(x)),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": timer(lambda: torch.sum(x, dim=0, dtype=torch.int32)),
        }
        emit({"phase": "kernels", "kernel": "frame_accum", "shape": list(shape),
              "checked": [[str(d).split(".")[-1], list(sh)] for d, sh in shapes],
              "max_abs_err": check.max_err["frame_accum"],
              "tolerance": check.TOLERANCE["frame_accum"], **timed[shape]})
        del x
    rows["frame_accum"] = dict(timed[(W, n)])
    for shape, tag in (((WRS_WORLD, WRS_ITEMS), "wrs_hist"),
                       ((WRS_WORLD, 1), "wrs_scalar"), ((2, 1), "conformance")):
        rows["frame_accum"].update({f"{key}_{tag}": val
                                    for key, val in timed[shape].items()
                                    if key != "bound_by"})

    rows["bfs_frontier"] = kernel_bfs_frontier(torch, timer, check, gen, g)
    rows["alias_draw"] = kernel_alias_draw(torch, timer, check, gen, table)
    rows["flash_attention"] = kernel_flash_attention(torch, timer, check, gen)
    rows["rglru_scan"] = kernel_rglru_scan(torch, timer, check, gen)
    rows["ssm_scan"] = kernel_ssm_scan(torch, timer, check, gen)
    return rows


BFS_TIMED_LEVELS = tuple(range(8))    # the kernel timed at each
BFS_LIBRARY_LEVELS = (2, 4, 5)        # and torch.sparse.mm beside it


def kernel_bfs_frontier(torch, timer, check, gen, g):
    """``bfs_frontier`` on the full graph, B = 256 lanes, at levels 0–7 of
    one real BFS (``bfs_sssp`` from random sources, no early exit): checked
    against the plain version at levels 0, 2, 4 and 5, timed at every level
    (each call is two launches, pack and pull, also profiled apart), with
    the bound and ``torch.sparse.mm`` at levels 2, 4 and 5 and the plain
    version at 4."""
    from repro_torch.graphs.bfs import bfs_sssp
    from repro_torch.kernels import ref
    from repro_torch.kernels.bfs_frontier import bfs_frontier

    B = LANES
    src_v = torch.randint(0, g.n, (B,), generator=gen, device="cuda")
    deg = (g.indptr[1:] - g.indptr[:-1]).float()
    chunk = 16  # the plain version's (B, m) gathers are run 16 lanes at a time

    def plain(sigma, dist, level):
        return torch.cat([ref.bfs_frontier_ref(g.src, g.dst, sigma[i:i + chunk],
                                               dist[i:i + chunk], level)
                          for i in range(0, B, chunk)])

    adj = torch.sparse_csr_tensor(
        g.indptr.long(), g.indices_padded[:g.m_arcs].long(),
        torch.ones(g.m_arcs, device="cuda"), size=(g.n, g.n))
    by_level, row = {}, None
    for level in BFS_TIMED_LEVELS:
        dist, sigma = bfs_sssp(g, src_v, None, max_levels=level,
                               early_exit=False, device="cuda")
        if level in (0, 2, 4, 5):
            check.compare_bfs(g.indptr, g.indices_padded, sigma, dist, level,
                              bfs_frontier(g.indptr, g.indices_padded, sigma,
                                           dist, level))
        front = dist == level
        entries = int(front.sum())
        front_arcs = float((front.float() @ deg).sum())
        # indptr, indices, dist read and agg written once, the frontier's σ
        nbytes = 4 * (g.n + 1) + 4 * g.m_arcs + 4 * B * g.n * 2 + 4 * entries
        t_bound, by = bound_ms(nbytes, B * g.m_arcs + front_arcs)
        call = lambda: bfs_frontier(g.indptr, g.indices_padded, sigma, dist,  # noqa: E731
                                    level)
        timed = {"ms": timer(call), "bound_ms": t_bound, "bound_by": by,
                 "warm_ms_by_launch": device_ms_by(
                     torch, call, ("bfs_pack_kernel", "bfs_pull_kernel"))}
        if level in BFS_LIBRARY_LEVELS:
            masked_t = torch.where(front, sigma, 0.0).t().contiguous()
            timed["library_ms"] = timer(lambda: torch.sparse.mm(adj, masked_t))
            del masked_t
        if level == 4:
            timed["plain_ms"] = timer(lambda: plain(sigma, dist, level),
                                      reps=5, warmup=1)
            # what one call allocates: agg and the pack's scratch
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            call()
            torch.cuda.synchronize()
            timed["call_alloc_peak_bytes"] = torch.cuda.max_memory_allocated() - base
            row = dict(timed)
        by_level[level] = {"frontier_entries": entries,
                           "frontier_arcs": front_arcs, **timed}
        emit({"phase": "kernels", "kernel": "bfs_frontier", "level": level,
              "lanes": B, "n": g.n, "arcs": g.m_arcs, **by_level[level]})
        del dist, sigma, front
    emit({"phase": "kernels", "kernel": "bfs_frontier", "timed_level": 4,
          "levels_checked": [0, 2, 4, 5],
          "max_abs_err": check.max_err["bfs_frontier"],
          "tolerance": check.TOLERANCE["bfs_frontier"],
          "library": "torch.sparse.mm(CSR adjacency, pre-masked sigma^T)",
          "launches_a_call": 2, **row})
    row["by_level"] = by_level
    del adj
    torch.cuda.empty_cache()
    return row


def attention_pairs(S: int, window: int) -> int:
    """Admissible (q, k) pairs of one (batch, head): k ≤ q, and
    k > q − window with a window."""
    if window <= 0:
        return S * (S + 1) // 2
    w = min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def kernel_flash_attention(torch, timer, check, gen):
    """``flash_attention`` against its plain version at recurrentgemma-2b's
    prefill shape (MQA, hd 256, window 2048) in bf16 and f32, then at
    S = 100 (ragged tiles) and with window 0; the bf16 and f32 full shapes
    timed beside the bound and ``scaled_dot_product_attention`` with the
    same boolean mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.time_kernels import loop_us

    B, S = RG_PREFILL
    H, KV, hd, window = 10, 1, 256, 2048

    def qkv(b, s, dtype):
        # the model's (B, S, heads, hd) layout, as (B, heads, S, hd) views
        return [torch.randn((b, s, n, hd), generator=gen, device="cuda")
                .to(dtype).transpose(1, 2) for n in (H, KV, KV)]

    row, timed = None, {}
    for dtype in (torch.bfloat16, torch.float32):
        q, k, v = qkv(B, S, dtype)
        check.compare_flash(q, k, v, window, flash_attention(q, k, v, window=window))
        es = q.element_size()
        pairs = B * H * attention_pairs(S, window)
        nbytes = es * (2 * q.numel() + k.numel() + v.numel())
        ops = 4 * hd * pairs
        rate = BF16_OPS_PER_S if dtype == torch.bfloat16 else F32_OPS_PER_S
        t_bound, by = bound_ms(nbytes, ops, rate)
        pos = torch.arange(S, device="cuda")
        mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - window)
        ke, ve = k.expand(B, H, S, hd), v.expand(B, H, S, hd)
        timed[str(dtype)] = {
            "ms": timer(lambda: flash_attention(q, k, v, window=window)),
            "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v, window=window),
                              reps=5, warmup=1),
            "bound_ms": t_bound, "bound_by": by,
            "library_ms": timer(lambda: F.scaled_dot_product_attention(
                q, ke, ve, attn_mask=mask)),
        }
        emit({"phase": "kernels", "kernel": "flash_attention",
              "dtype": str(dtype).split(".")[-1],
              "shape": {"q": list(q.shape), "kv": list(k.shape), "window": window,
                        "layout": "(B, S, heads, hd) memory as (B, heads, S, hd) views"},
              "admissible_pairs": pairs, "flops": ops, "bytes": nbytes,
              "f32_core_bound_ms": ops / F32_OPS_PER_S * 1e3,
              "max_abs_err": check.max_err["flash_attention"],
              "tolerance": check.TOLERANCE["flash_attention"],
              "library": "F.scaled_dot_product_attention(q, k, v expanded to H "
                         "heads, boolean window mask)",
              **timed[str(dtype)]})
        del q, k, v, ke, ve, mask
        torch.cuda.empty_cache()
    row = dict(timed["torch.bfloat16"])
    row.update({f"{key}_f32": val for key, val in timed["torch.float32"].items()
                if key != "bound_by"})
    checked = []
    for dtype in (torch.bfloat16, torch.float32):
        for s, w in ((100, window), (100, 0), (100, 32), (S, 0)):
            q, k, v = qkv(1 if s == S else B, s, dtype)
            check.compare_flash(q, k, v, w, flash_attention(q, k, v, window=w))
            checked.append([str(dtype).split(".")[-1], list(q.shape), w])
    emit({"phase": "kernels", "kernel": "flash_attention", "checked": checked,
          "max_abs_err": check.max_err["flash_attention"]})

    # adaptive_eval's shape: B = 4, S = 64, one kv tile a block, launch-bound
    Be, Se = SERVE_EVAL["batch"], SERVE_EVAL["seq"]
    q, k, v = qkv(Be, Se, torch.bfloat16)
    check.compare_flash(q, k, v, window, flash_attention(q, k, v, window=window))
    pos = torch.arange(Se, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    ke, ve = k.expand(Be, H, Se, hd), v.expand(Be, H, Se, hd)
    pairs = Be * H * attention_pairs(Se, window)
    t_bound, by = bound_ms(2 * (2 * q.numel() + k.numel() + v.numel()),
                           4 * hd * pairs, BF16_OPS_PER_S)
    eval_row = {"ms": timer(lambda: flash_attention(q, k, v, window=window)),
                "bound_ms": t_bound, "bound_by": by,
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    q, ke, ve, attn_mask=mask))}
    emit({"phase": "kernels", "kernel": "flash_attention", "dtype": "bfloat16",
          "shape": {"q": list(q.shape), "kv": list(k.shape), "window": window},
          "path": "adaptive_eval", **eval_row})
    row.update({f"{key}_eval_shape": val for key, val in eval_row.items()
                if key != "bound_by"})

    # the f32 prefill-vs-decode gate's shape: B = 4, S = 32, one kv tile
    Bg, Sg = SERVE_GEN[0], SERVE_GEN[1]
    q, k, v = qkv(Bg, Sg, torch.float32)
    check.compare_flash(q, k, v, window, flash_attention(q, k, v, window=window))
    pos = torch.arange(Sg, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    ke, ve = k.expand(Bg, H, Sg, hd), v.expand(Bg, H, Sg, hd)
    pairs = Bg * H * attention_pairs(Sg, window)
    t_bound, by = bound_ms(4 * (2 * q.numel() + k.numel() + v.numel()),
                           4 * hd * pairs)
    call = lambda: flash_attention(q, k, v, window=window)  # noqa: E731
    gate_row = {"ms": timer(call), "loop_us": loop_us(call),
                "bound_ms": t_bound, "bound_by": by,
                "library_ms": timer(lambda: F.scaled_dot_product_attention(
                    q, ke, ve, attn_mask=mask))}
    emit({"phase": "kernels", "kernel": "flash_attention", "dtype": "float32",
          "shape": {"q": list(q.shape), "kv": list(k.shape), "window": window},
          "path": "prefill vs decode (f32)", **gate_row})
    row.update({f"{key}_f32_gate_shape": val for key, val in gate_row.items()
                if key != "bound_by"})
    torch.cuda.empty_cache()
    return row


def kernel_rglru_scan(torch, timer, check, gen):
    """``rglru_scan`` exactly against its plain version at a ragged
    (3, 100, 1000) and (1, 7, 1001) (the 4-byte body), at
    ``adaptive_eval``'s (4, 64, 2560) and at the full-width prefill's
    (2, 4096, 2560); timed at the last two."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.rglru_scan import rglru_scan

    eval_shape = (SERVE_EVAL["batch"], SERVE_EVAL["seq"], 2560)
    prefill_shape = (RG_PREFILL[0], RG_PREFILL[1], 2560)
    checked, timed = [], {}
    for shape in ((3, 100, 1000), (1, 7, 1001), eval_shape, prefill_shape):
        a = torch.rand(shape, generator=gen, device="cuda") * 0.75 + 0.2
        b = torch.randn(shape, generator=gen, device="cuda")
        check.compare_rglru(a, b, rglru_scan(a, b))
        checked.append(list(shape))
        if shape not in (eval_shape, prefill_shape):
            continue
        t_bound, by = bound_ms(3 * 4 * a.numel(), 2 * a.numel())
        timed[shape] = {
            "ms": timer(lambda: rglru_scan(a, b)),
            "plain_ms": timer(lambda: ref.rglru_scan_ref(a, b), reps=3,
                              warmup=1),
            "bound_ms": t_bound, "bound_by": by, "library_ms": None}
    for shape, path in ((eval_shape, "adaptive_eval"), (prefill_shape, "prefill")):
        emit({"phase": "kernels", "kernel": "rglru_scan", "shape": list(shape),
              "path": path, "checked": checked,
              "max_abs_err": check.max_err["rglru_scan"],
              "tolerance": check.TOLERANCE["rglru_scan"],
              "library": "none (no single PyTorch call runs a linear "
                         "recurrence)", **timed[shape]})
    row = dict(timed[prefill_shape])
    row.update({f"{key}_eval_shape": val for key, val in timed[eval_shape].items()
                if key not in ("bound_by", "library_ms")})
    return row


def kernel_ssm_scan(torch, timer, check, gen):
    """``ssm_scan`` exactly against its plain version at a ragged
    (3, 100, 125, 3), at ``adaptive_eval``'s (4, 64, 8192, 16) (timed
    there) and at falcon-mamba-7b's full-width prefill (2, 4096, 8192, 16):
    4.3 GB a tensor.  The plain version walks the 4096 steps once, with no
    warm-up."""
    from repro_torch.kernels import ref
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.launch.time_kernels import loop_us

    checked = []
    eval_shape = (SERVE_EVAL["batch"], SERVE_EVAL["seq"], 8192, 16)
    for shape in ((3, 100, 125, 3), eval_shape, (*MAMBA_PREFILL, 8192, 16)):
        a = torch.rand(shape, generator=gen, device="cuda") * 0.89 + 0.1
        b = torch.randn(shape, generator=gen, device="cuda")
        check.compare_ssm(a, b, ssm_scan(a, b))
        checked.append(list(shape))
        if shape == eval_shape:
            # adaptive_eval's shape, where most of the path's launches are
            t_bound, by = bound_ms(3 * 4 * a.numel(), 2 * a.numel())
            eval_row = {"ms": timer(lambda: ssm_scan(a, b)),
                        "loop_us": loop_us(lambda: ssm_scan(a, b)),
                        "bound_ms": t_bound, "bound_by": by}
            emit({"phase": "kernels", "kernel": "ssm_scan", "shape": list(shape),
                  "path": "adaptive_eval", **eval_row})
    torch.cuda.empty_cache()
    t_bound, by = bound_ms(3 * 4 * a.numel(), 2 * a.numel())
    row = {"ms": timer(lambda: ssm_scan(a, b)),
           "plain_ms": timer(lambda: ref.ssm_scan_ref(a, b), reps=1, warmup=0),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None}
    emit({"phase": "kernels", "kernel": "ssm_scan", "shape": list(shape),
          "checked": checked, "max_abs_err": check.max_err["ssm_scan"],
          "tolerance": check.TOLERANCE["ssm_scan"],
          "library": "none (no single PyTorch call runs a linear recurrence)",
          **row})
    del a, b
    torch.cuda.empty_cache()
    row.update({f"{key}_eval_shape": val for key, val in eval_row.items()
                if key != "bound_by"})
    return row


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
        rejected = int(reject.sum())

        def distinct(x):
            return int(torch.unique(x).numel())

        # the bound: streamed u1, u2, idx, and the table read once in 32 B
        # sectors (8 buckets): each sector of prob that a draw touches, each
        # sector of alias that a rejected draw touches; one multiply, one
        # compare a draw
        sectors = distinct(bucket >> 3), distinct(bucket[reject] >> 3)
        t_bound, by = bound_ms(12 * b + 32 * sum(sectors), 2 * b)
        # the table counted in 4 B buckets, and in a sector for each gather
        # (this kernel's access pattern: one DRAM access a gather)
        buckets = distinct(bucket), distinct(bucket[reject])
        byte_ms = (12 * b + 4 * sum(buckets)) / HBM_BYTES_PER_S * 1e3
        gather_ms = (12 * b + 32 * (b + rejected)) / HBM_BYTES_PER_S * 1e3
        timed = {
            "ms": timer(lambda: alias_draw(table.prob, table.alias, u1, u2)),
            "plain_ms": timer(lambda: ref.alias_draw_ref(table.prob, table.alias,
                                                         u1, u2)),
            "bound_ms": t_bound, "bound_by": by, "library_ms": None,
            "byte_bound_ms": byte_ms, "sector_per_gather_ms": gather_ms,
        }
        emit({"phase": "kernels", "kernel": "alias_draw",
              "shape": {"n": n, "draws": b, "rejected_draws": rejected,
                        "distinct_buckets": buckets[0],
                        "distinct_rejected_buckets": buckets[1],
                        "distinct_prob_sectors": sectors[0],
                        "distinct_rejected_alias_sectors": sectors[1]},
              "max_abs_err": check.max_err["alias_draw"],
              "tolerance": check.TOLERANCE["alias_draw"],
              "edge_uniforms_n1000_idx": edge_idx,
              "library": "none (no single PyTorch call)",
              "bound": "12 B a draw + 32 B a distinct table sector", **timed})
        if row is None:
            row = timed
        else:
            for key in ("ms", "plain_ms", "bound_ms", "byte_bound_ms",
                        "sector_per_gather_ms"):
                row[f"{key}_2e24_draws"] = timed[key]
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


def phase_full(torch, g, full):
    """Full-size KADABRA, LOCAL and SHARED at W = 4; ``full`` gets the
    LOCAL run's ``bfs_frontier`` calls by BFS level (``"levels"``) and the
    profile of a LOCAL run (``"profile"``)."""
    import numpy as np

    from repro_torch import device as dev_mod
    from repro_torch.core.frames import FrameStrategy as FS
    from repro_torch.graphs import KadabraParams, preprocess, run_kadabra
    from repro_torch.kernels import bfs_frontier as bfs_mod
    from repro_torch.kernels import frame_accum as accum_mod
    from repro_torch.kernels import ops

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
        kernel = ops._bfs_kernel

        def counted(indptr, indices, sigma, dist, level):
            if strat == FS.LOCAL_FRAME:
                full["levels"][level] = full["levels"].get(level, 0) + 1
            return kernel(indptr, indices, sigma, dist, level)

        ops._bfs_kernel = counted
        try:
            torch.cuda.synchronize()
            t0 = time.time()
            b, res, _ = run_kadabra(g, params, strategy=strat, world=world,
                                    seed=0, pre=pre, device="cuda")
            torch.cuda.synchronize()
            wall = time.time() - t0
        finally:
            ops._bfs_kernel = kernel
        syncs = dev_mod.host_syncs
        out[strat] = res
        full.setdefault("walls", {})[strat] = wall
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
    full["profile"] = prof
    full["pre"] = pre
    full["runs"] = out
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


POOL_QUERIES = ("kadabra-full:shared:4:0", "kadabra-full:local:4:1",
                "wrs-full:shared:4:0", "wrs-full:indexed:4:1",
                "wrs:local:2", "triangles:local:2:1")
POOL_SLOTS = 4              # DevicePool(4): worker slots of the vmap sessions
POOL_IN_FLIGHT = 2


def kadabra_full_instance():
    """Phase 6's configuration as a registered instance; the pool reuses
    phase 6's graph and preprocessing (no oracle at this size)."""
    from repro_torch.core.instances import KadabraInstance
    return KadabraInstance(name="kadabra-full", n_vertices=FULL_N,
                           n_edges=FULL_M, graph_seed=0, eps=0.02, delta=0.1,
                           batch=64, rounds_per_epoch=4, compute_oracle=False)


def pool_order(solo) -> list:
    """The queries in submission order, chosen from their solo epochs so
    that a full-size SHARED session X is shrunk and later regrown: the other
    width-4 queries, then the other width-2 one, then X, then the width-2
    query Y with the fewest epochs.  X takes the pool's 4 slots; the next
    tick the pressure policy halves it to admit Y and empties the queue, and
    once Y retires X grows back — if X still has an epoch to run then,
    which needs Y's steps ≤ X's steps − 2."""
    steps = {q: solo[q][1].epochs - 1 for q in POOL_QUERIES}
    x = max((q for q in POOL_QUERIES if q.endswith(":shared:4:0")),
            key=lambda q: steps[q])
    y = min((q for q in POOL_QUERIES if q.split(":")[2] == "2"),
            key=lambda q: steps[q])
    if steps[y] > steps[x] - 2:
        raise AssertionError(f"no order shrinks and regrows a full-size SHARED "
                             f"session: steps {steps}")
    rest = [q for q in POOL_QUERIES if q not in (x, y)]
    return [q for q in rest if q.split(":")[2] == "4"] + \
        [q for q in rest if q.split(":")[2] == "2"] + [x, y]


def phase_pool(torch, kad, wrs, graph=None, device="cuda"):
    """The adaptive-query pool at full size: ``POOL_QUERIES`` through
    ``EpochScheduler`` (2 in flight, 4 slots, shrink-regrow, a checkpoint
    every tick), each query held against its solo session and the solo
    session against ``run_instance``; a second drain stopped after 2 ticks
    and resumed from its checkpoints; a checkpoint of the kadabra-full
    SHARED session timed; the ``--pool`` CLI, then ``--resume``.
    ``graph`` is phase 6's (graph, preprocessing), which ``kad``'s build
    then finds in the instance cache instead of building them again."""
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.core import instances
    from repro_torch.core.instances import register_instance, run_instance
    from repro_torch.launch import serve as serve_cli
    from repro_torch.serve import (AdaptiveSession, DevicePool, EpochScheduler,
                                   PressurePolicy, SessionSpec, StepperCache)

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    if graph is not None:
        instances._CACHE[("kadabra", kad, torch.device(device))] = (
            *graph, np.full((kad.n_vertices,), np.nan))
    for inst in (kad, wrs):
        register_instance(inst, overwrite=True)
    specs = {q: SessionSpec.parse(q) for q in POOL_QUERIES}
    qid = {q: q.replace(":", "-") for q in POOL_QUERIES}

    # 1. each query alone, and against run_instance
    solo_cache = StepperCache(device)
    solo = {}
    for q, spec in specs.items():
        session = AdaptiveSession.create(spec, cache=solo_cache)
        sync()
        session.start().run()
        sync()
        est, res = session.result()
        est_i, res_i, built = run_instance(
            spec.instance, strategy=spec.strategy, world=spec.world,
            seed=spec.seed, device=device)
        same = (res.num, res.epochs, res.stop_epoch) == \
            (res_i.num, res_i.epochs, res_i.stop_epoch) and \
            np.array_equal(est, est_i)
        emit({"phase": "pool", "solo": q, "tau": res.num,
              "epochs": res.epochs, "stop_epoch": res.stop_epoch,
              "wall_s": session.wall_s, "equals_run_instance": same,
              "estimate_head": [float(v) for v in np.ravel(est)[:3]]})
        if not (same and res.stopped):
            raise AssertionError(f"pool: solo {q} (τ {res.num}, epochs "
                                 f"{res.epochs}, stopped {res.stopped}) differs "
                                 f"from run_instance (τ {res_i.num}, epochs "
                                 f"{res_i.epochs})")
        if spec.instance == wrs.name and \
                abs(float(est[0]) - float(built.oracle[0])) > built.eps:
            raise AssertionError(f"pool: {q}: |μ̂ − μ| > 2·rtol·μ = {built.eps}")
        solo[q] = (est, res, session.wall_s)
    order = pool_order(solo)

    def scheduler(**kw):
        return EpochScheduler(max_in_flight=POOL_IN_FLIGHT,
                              pool=DevicePool(POOL_SLOTS),
                              pressure=PressurePolicy.parse("shrink-regrow"),
                              checkpoint_every=1, device=device, **kw)

    def check_results(results, what):
        for q in POOL_QUERIES:
            r = results[qid[q]]
            est, res, _ = solo[q]
            if not (r.stopped and (r.tau, r.epochs, r.stop_epoch) ==
                    (res.num, res.epochs, res.stop_epoch)
                    and np.array_equal(r.estimate, est)):
                raise AssertionError(f"pool: {what} {q}: τ {r.tau}, epochs "
                                     f"{r.epochs} differ from its solo run "
                                     f"(τ {res.num}, epochs {res.epochs})")

    # the pool's checkpoint writes, timed apart from its stepping
    saves = {"s": 0.0, "n": 0}
    save = AdaptiveSession.save

    def timed_save(session, directory):
        t0 = time.time()
        path = save(session, directory)
        saves["s"] += time.time() - t0
        saves["n"] += 1
        return path

    tmp = Path(tempfile.mkdtemp(prefix="repro-pool-"))
    try:
        # 2. the pool
        sched = scheduler(checkpoint_dir=tmp / "drain")
        for q in order:
            sched.submit(specs[q], qid=qid[q])
        AdaptiveSession.save = timed_save
        events, ticks = [], []   # ticks: (in flight after admission, s)
        sync()
        t0 = time.time()
        try:
            while not sched.idle:
                t1 = time.time()
                events.append(sched.tick())
                sync()
                ticks.append((sched.in_flight + len(events[-1].retired),
                              time.time() - t1))
        finally:
            AdaptiveSession.save = save
        wall = time.time() - t0
        ckpt_bytes = sum(f.stat().st_size for f in (tmp / "drain").rglob("*")
                         if f.is_file())
        shutil.rmtree(tmp / "drain")
        check_results(sched.results, "pool")
        reshards = [(ev.tick, q, old, new) for ev in events
                    for q, old, new in ev.resharded]
        for q in order:
            r = sched.results[qid[q]]
            emit({"phase": "pool", "query": q, "tau": r.tau,
                  "epochs": r.epochs, "wait_ticks": r.wait_ticks,
                  "placement_wait_ticks": r.placement_wait_ticks,
                  "devices_leased": r.devices_leased, "final_world":
                      r.spec.world, "wall_s": r.wall_s,
                  "equals_solo": True})
        x = order[-2]
        shrunk = [t for t, q, old, new in reshards if q == qid[x] and new < old]
        regrown = [t for t, q, old, new in reshards
                   if q == qid[x] and new > old and shrunk and t > shrunk[0]]
        taus = sum(r.tau for r in sched.results.values())
        stepping = sum(r.wall_s for r in sched.results.values())
        emit({"phase": "pool", "order": order, "ticks": sched.tick_count,
              "wall_s": wall, "checked_samples_per_s": taus / wall,
              "samples": taus, "solo_wall_s_sum":
                  sum(w for _, _, w in solo.values()),
              "stepping_s": stepping, "checkpoint_save_s": saves["s"],
              "checkpoint_saves": saves["n"],
              "other_s": wall - stepping - saves["s"],
              "tick_s": [t for _, t in ticks],
              "in_flight": [n for n, _ in ticks],
              "reshards": reshards, "checkpoint_bytes_written": ckpt_bytes,
              "steppers_built": len(sched.cache)})
        if not (shrunk and regrown):
            raise AssertionError(f"pool: {x} was not shrunk and regrown: "
                                 f"{reshards}")

        # 3. a second drain stopped after 2 ticks, resumed from disk
        sched = scheduler(checkpoint_dir=tmp / "resume")
        for q in order:
            sched.submit(specs[q], qid=qid[q])
        sched.tick()
        sched.tick()
        early = dict(sched.results)
        del sched
        sync()
        t0 = time.time()
        resumed = EpochScheduler.resume(
            tmp / "resume", max_in_flight=POOL_IN_FLIGHT,
            pool=DevicePool(POOL_SLOTS),
            pressure=PressurePolicy.parse("shrink-regrow"),
            checkpoint_every=1, device=device)
        pending = resumed.pending
        # the resumed drain under the profiler: the card's busy share
        prof = None
        if torch.device(device).type == "cuda":
            prof = profiled(torch, resumed.drain)
        else:
            resumed.drain()
        check_results({**early, **resumed.results}, "resumed")
        emit({"phase": "pool", "resume": "after 2 ticks",
              "retired_before": sorted(early), "resumed_pending": pending,
              "unresumed": resumed.unresumed, "resumed_wall_s":
                  time.time() - t0, "equals_solo": True, "profile": prof})
        shutil.rmtree(tmp / "resume")

        # 4. one checkpoint of the kadabra-full SHARED session, timed
        spec = specs["kadabra-full:shared:4:0"]
        session = AdaptiveSession.create(spec, cache=solo_cache).start()
        session.step()
        sync()
        t0 = time.time()
        path = session.save(tmp / "ckpt")
        save_s = time.time() - t0
        nbytes = sum(f.stat().st_size for f in path.iterdir())
        t0 = time.time()
        back = AdaptiveSession.restore(tmp / "ckpt", cache=solo_cache)
        sync()
        restore_s = time.time() - t0
        est, res = back.run().result()
        ref_est, ref_res, _ = solo["kadabra-full:shared:4:0"]
        if res.num != ref_res.num or not np.array_equal(est, ref_est):
            raise AssertionError("pool: the restored kadabra-full SHARED "
                                 "session differs from its solo run")
        emit({"phase": "pool", "checkpoint": "kadabra-full:shared:4:0",
              "epoch": session.epoch, "save_s": save_s,
              "restore_s": restore_s, "bytes_per_tick": nbytes,
              "leaves": len(json.loads((path / "manifest.json").read_text())
                            ["leaves"]), "restored_equals_solo": True})

        # 5. the CLI at its default queries, then --resume
        cli = ["--pool", "--device", str(device), "--checkpoint-dir",
               str(tmp / "cli")]
        for argv in (cli, cli + ["--resume"]):
            rc = serve_cli.main(argv)
            emit({"phase": "pool", "cli": " ".join(argv[5:]) or "drain",
                  "rc": rc})
            if rc != 0:
                raise AssertionError(f"pool: serve --pool {argv} returned {rc}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phase 9a: (world, backend) → the (strategy, F) runs of kadabra-full in
# that many ranks on the one card (F = 0: F = W)
SUBSTRATE_RUNS = {
    (1, "nccl"): (("local", 0), ("shared", 0)),
    (2, "gloo"): (("local", 0), ("shared", 0)),
    (4, "gloo"): (("local", 0), ("shared", 0), ("shared", 2), ("indexed", 0)),
}
SUBSTRATE_INSTANCES = ("diameter", "gradvar", "kadabra", "reachability",
                       "triangles", "wrs")
SUBSTRATE_TIMEOUT_S = 300.0
GRAPH_ARRAYS = ("indptr", "indices_padded", "src", "dst", "components")


def kernel_modules() -> dict:
    from repro_torch.kernels import alias_draw as alias_mod
    from repro_torch.kernels import bfs_frontier as bfs_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import frame_accum as accum_mod
    from repro_torch.kernels import rglru_scan as rglru_mod
    from repro_torch.kernels import ssm_scan as ssm_mod
    return {"frame_accum": accum_mod, "bfs_frontier": bfs_mod,
            "alias_draw": alias_mod, "flash_attention": flash_mod,
            "rglru_scan": rglru_mod, "ssm_scan": ssm_mod}


@contextlib.contextmanager
def probed(group, every: bool):
    """In a worker process: hold the kernels' calls against their plain
    versions (every call, or each new shape), count the launches from 0,
    and yield (report, check); the report is filled when the block ends:
    launches, comparisons and calls by shape per kernel, the largest
    error, the seconds spent comparing, and the jax/repro modules the
    process imported (raises if there are any)."""
    import torch
    mods = kernel_modules()
    check = PlainCheck(torch)
    report = {"rank": group.rank, "world": group.world,
              "backend": group.backend}
    with check.installed(every) as (compared, by_shape):
        for m in mods.values():
            m.launches = 0
        yield report, check
        report["launches"] = {name: m.launches for name, m in mods.items()}
    report["compared"] = dict(compared)
    report["by_shape"] = {k: v for k, v in by_shape.items() if v}
    report["max_err"] = dict(check.max_err)
    report["compare_s"] = check.compare_s
    report["leaked"] = sorted(m for m in sys.modules
                              if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    if report["leaked"]:
        raise AssertionError(f"rank {group.rank} imported {report['leaked']}")


@contextlib.contextmanager
def rank_probe(group):
    """``probed`` with every call compared, yielding the report only: the
    ``rank_probe`` of ``run_substrate_equivalence_all``."""
    with probed(group, every=True) as (report, _):
        yield report


def substrate_rank(group, graph_dir, runs):
    """One rank of phase 9a: phase 6's graph and preprocessing from
    ``graph_dir`` on the rank's card, kadabra-full registered over them
    (the registry is per process), and each (strategy, F) of ``runs`` as
    SHARD_MAP in ``group``.  Returns, per run, τ, epochs, the wall, the
    collectives issued and a digest of (τ, trimmed data, estimate), rank 0
    with the data and estimate themselves; and the rank's probe report."""
    import hashlib

    import numpy as np
    import torch

    from repro_torch.core import distributed, instances
    from repro_torch.core.instances import register_instance, run_instance
    from repro_torch.graphs.csr import graph_from_arrays
    from repro_torch.graphs.kadabra import Preprocessed

    d = Path(graph_dir)
    meta = json.loads((d / "meta.json").read_text())
    a = {k: np.load(d / f"{k}.npy") for k in GRAPH_ARRAYS}
    dev = group.device
    g = graph_from_arrays(meta["n"], a["indptr"], a["indices_padded"],
                          a["src"], a["dst"], dev)
    pre = Preprocessed(omega=meta["omega"], vd_upper=meta["vd_upper"],
                       components=torch.from_numpy(a["components"]).to(dev),
                       diam_levels=meta["diam_levels"])
    kad = kadabra_full_instance()
    instances._CACHE[("kadabra", kad, dev)] = (g, pre,
                                               np.full((g.n,), np.nan))
    register_instance(kad, overwrite=True)
    # the first collective sets up the backend's connections (NCCL's
    # communicator): take it before the timed runs
    distributed.all_reduce(torch.zeros(1, dtype=torch.int32, device=dev),
                           group.pg)
    out = []
    with probed(group, every=False) as (report, check):
        for strat, F in runs:
            torch.cuda.synchronize()
            t0, c0 = time.time(), check.compare_s
            with distributed.record_collectives() as calls:
                est, res, built = run_instance(
                    kad.name, strategy=strat, world=group.world, seed=0,
                    substrate="shard_map", frame_shards=F, group=group)
            torch.cuda.synchronize()
            wall = time.time() - t0
            data = np.ascontiguousarray(built.trim(res.data))
            ops = {}
            for op, _, _, where in calls:
                ops[f"{op} ({where})"] = ops.get(f"{op} ({where})", 0) + 1
            out.append({
                "strategy": strat, "F": F, "tau": res.num,
                "epochs": res.epochs, "stop_epoch": res.stop_epoch,
                "stopped": res.stopped, "wall_s": wall,
                "plain_compare_s": check.compare_s - c0, "collectives": ops,
                "digest": hashlib.sha256(
                    np.int64(res.num).tobytes() + data.tobytes()
                    + np.ascontiguousarray(est).tobytes()).hexdigest(),
                **({"data": data, "est": est} if group.rank == 0 else {})})
    return out, report


def phase_substrate(torch, g, full, check, rank_reports):
    """Phase 9a: the shard_map substrate on the card.

    a. kadabra-full (phase 6's configuration) LOCAL and SHARED in one NCCL
       rank, against VMAP and SEQUENTIAL at W = 1 in this process.
    b. the same at W = 2 (LOCAL, SHARED) and W = 4 (LOCAL, SHARED F = 4,
       SHARED F = 2 — the grouped form —, INDEXED) in W gloo ranks sharing
       the card (NCCL puts one rank on each card), each against VMAP at
       the same W (phase 6's W = 4 LOCAL and SHARED runs), and INDEXED
       W = 4 against INDEXED W = 1.
    c. ``run_substrate_equivalence_all`` over the six registered instances
       at W = 1 (NCCL) and W ∈ {2, 4} (gloo), every cell required.

    Every rank holds its kernel calls against their plain versions and
    counts its launches (``probed``); the reports go to ``rank_reports``.
    A wall includes the comparisons made in it, whose seconds each line
    gives (``plain_compare_s``; ``check`` is this process's).  Nothing falls back: a rank that fails or runs past
    ``SUBSTRATE_TIMEOUT_S`` fails the phase."""
    import tempfile

    import numpy as np

    from repro_torch.core import instances
    from repro_torch.core.conformance import run_substrate_equivalence_all
    from repro_torch.core.frames import FrameStrategy
    from repro_torch.core.instances import register_instance, run_instance
    from repro_torch.launch.spawn import spawn_workers

    kad = kadabra_full_instance()
    pre = full["pre"]
    instances._CACHE[("kadabra", kad, torch.device("cuda"))] = (
        g, pre, np.full((g.n,), np.nan))
    register_instance(kad, overwrite=True)

    def one_process(strat, world, F, substrate="vmap"):
        torch.cuda.synchronize()
        t0, c0 = time.time(), check.compare_s
        est, res, built = run_instance(kad.name, strategy=strat, world=world,
                                       seed=0, substrate=substrate,
                                       frame_shards=F, device="cuda")
        torch.cuda.synchronize()
        return {"tau": res.num, "data": np.asarray(built.trim(res.data)),
                "est": est, "wall_s": time.time() - t0,
                "plain_compare_s": check.compare_s - c0}

    ref = {}
    for strat in ("local", "shared"):  # phase 6's W = 4 runs
        res = full["runs"][FrameStrategy(strat)]
        data = np.asarray(res.data[: g.n])
        ref[(strat, 4, 0, "vmap")] = {
            "tau": res.num, "data": data, "plain_compare_s": None,
            "wall_s": full["walls"][FrameStrategy(strat)],
            "est": data.astype(np.float64) / max(float(res.num), 1.0)}
    need = [(s, w, F, "vmap") for (w, _), runs in SUBSTRATE_RUNS.items()
            for s, F in runs] + [("local", 1, 0, "sequential"),
                                 ("shared", 1, 0, "sequential"),
                                 ("indexed", 1, 0, "vmap")]
    for key in need:
        if key not in ref:
            ref[key] = one_process(key[0], key[1], key[2], key[3])

    def same(a, b):
        return a["tau"] == b["tau"] and np.array_equal(a["data"], b["data"]) \
            and np.array_equal(a["est"], b["est"])

    with tempfile.TemporaryDirectory(prefix="chip_smoke_graph_") as tmp:
        arrays = {"indptr": g.indptr, "indices_padded": g.indices_padded,
                  "src": g.src, "dst": g.dst, "components": pre.components}
        for name in GRAPH_ARRAYS:
            np.save(Path(tmp) / f"{name}.npy", arrays[name].cpu().numpy())
        (Path(tmp) / "meta.json").write_text(json.dumps(
            {"n": g.n, "omega": pre.omega, "vd_upper": pre.vd_upper,
             "diam_levels": pre.diam_levels}))
        for (world, backend), runs in SUBSTRATE_RUNS.items():
            t0 = time.time()
            out = spawn_workers(substrate_rank, world, backend=backend,
                                device="cuda", args=(tmp, runs),
                                timeout=SUBSTRATE_TIMEOUT_S)
            spawn_wall = time.time() - t0
            rank_reports += [report for _, report in out]
            for i, (strat, F) in enumerate(runs):
                rows = [ranks_runs[i] for ranks_runs, _ in out]
                got = rows[0]
                if len({r["digest"] for r in rows}) != 1:
                    raise AssertionError(f"substrate: the {world} ranks of "
                                         f"{strat} F={F} hold different results")
                checks = {"vmap": ref[(strat, world, F, "vmap")]}
                if world == 1:
                    checks["sequential"] = ref[(strat, 1, F, "sequential")]
                if strat == "indexed":
                    checks["indexed W=1"] = ref[("indexed", 1, 0, "vmap")]
                equal = {k: same(got, v) for k, v in checks.items()}
                emit({"phase": "substrate", "step": "a" if world == 1 else "b",
                      "instance": kad.name, "backend": backend, "world": world,
                      "frame_shards": F or world, "strategy": strat,
                      "processes": f"{world} process(es) on one card, not a "
                                   f"multi-GPU number",
                      "tau": got["tau"], "epochs": got["epochs"],
                      "stop_epoch": got["stop_epoch"], "wall_s": got["wall_s"],
                      "checked_samples_per_s": got["tau"] / got["wall_s"],
                      "plain_compare_s": got["plain_compare_s"],
                      "first_run_in_ranks": i == 0,
                      "vmap_wall_s": checks["vmap"]["wall_s"],
                      "vmap_plain_compare_s": checks["vmap"]["plain_compare_s"],
                      "spawn_wall_s": spawn_wall,
                      "collectives_rank0": got["collectives"],
                      "equals": equal})
                if not (got["stopped"] and all(equal.values())):
                    raise AssertionError(f"substrate: {backend} W={world} "
                                         f"{strat} F={F or world} differs: "
                                         f"{equal}")

    t0 = time.time()
    failed = []
    for worlds, backend in (((1,), "nccl"), ((2, 4), "gloo")):
        reports = run_substrate_equivalence_all(
            SUBSTRATE_INSTANCES, worlds=worlds, seed=0, require_all=True,
            backend=backend, device="cuda", rank_probe=rank_probe,
            timeout=SUBSTRATE_TIMEOUT_S)
        for name, rep in reports.items():
            emit({"phase": "substrate", "step": "c", "instance": name,
                  "backend": backend, "worlds": list(worlds),
                  "cells_ok": sum(c.ok for c in rep.cells),
                  "cells": len(rep.cells),
                  "ran": sorted({s for c in rep.cells for s in c.ran})})
            failed += rep.failures
        rank_reports += [r for w in worlds for r in
                         next(iter(reports.values())).rank_reports[w]]
    emit({"phase": "substrate", "step": "c", "wall_s": time.time() - t0,
          "worker_processes": len(rank_reports),
          "imported_jax_or_repro": sorted({m for r in rank_reports
                                           for m in r["leaked"]})})
    if failed:
        raise AssertionError("substrate equivalence failed:\n"
                             + "\n".join(failed))


def serve_model(torch, arch, path, expect_params):
    """A model of the zoo at full width, random weights drawn on the card
    from seed 0 by the port's own initialiser; it must hold
    ``expect_params`` parameters."""
    from repro_torch.models import Model, resolve_config

    cfg = resolve_config(arch)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.time()
    model = Model(cfg, device="cuda").init(gen)
    torch.cuda.synchronize()
    params = list(model.parameters())
    count = sum(p.numel() for p in params)
    emit({"phase": path, "step": "weights", "arch": cfg.name,
          "layers": cfg.n_layers, "d_model": cfg.d_model, "vocab": cfg.vocab,
          "params": count, "param_count_formula": cfg.param_count(),
          "weight_gb": sum(p.numel() * p.element_size() for p in params) / 1e9,
          "init_s": time.time() - t0})
    if count != expect_params:
        raise AssertionError(f"{arch}: {count} parameters, expected "
                             f"{expect_params}")
    return model


def decode_prompt(torch, model, prompts):
    """Feed a (B, P) prompt through ``decode_step`` one token at a time, as
    ``generate`` does; → the logits after its last token."""
    B, P = prompts.shape
    cache = model.init_cache(B, P)
    for t in range(P):
        cache, logits = model.decode_step(cache, {
            "tokens": prompts[:, t],
            "pos": torch.full((B,), t, dtype=torch.int32, device="cuda")})
    return logits


def phase_serve(torch, model, path, prefill_shape):
    """A model's serving path at full width: prefill at ``prefill_shape``,
    greedy generation at the CLI's defaults, prefill against decode in bf16
    and f32 (``SERVE_GATES``), adaptive evaluation (``SERVE_EVAL``)."""
    import math

    from repro_torch.data import TokenStream
    from repro_torch.launch.serve import adaptive_eval, generate
    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model

    cfg = model.cfg
    with torch.inference_mode():
        # 1. prefill
        B, S = prefill_shape
        batch = TokenStream(vocab=cfg.vocab, seq_len=S, batch=B,
                            seed=0).batch_at(0, device="cuda")
        prefill = make_prefill_step(model)
        walls = []
        for _ in range(3):
            torch.cuda.reset_peak_memory_stats()
            torch.cuda.synchronize()
            t0 = time.time()
            logits = prefill(batch)
            torch.cuda.synchronize()
            walls.append(time.time() - t0)
        peak = torch.cuda.max_memory_allocated() / 1e9
        finite = bool(torch.isfinite(logits).all())
        emit({"phase": path, "step": "prefill", "batch": B, "seq": S,
              "window": cfg.local_window, "wall_s": walls,
              "tokens_per_s": B * S / min(walls[1:]), "peak_mem_gb": peak,
              "logits_shape": list(logits.shape), "finite": finite})
        if not finite or tuple(logits.shape) != (B, cfg.padded_vocab):
            raise AssertionError(f"{path} prefill: logits {tuple(logits.shape)}, "
                                 f"finite {finite}")
        prof = profiled(torch, lambda: prefill(batch))
        emit({"phase": path, "step": "prefill", "profile": prof})
        del logits, batch
        torch.cuda.empty_cache()

        # 2. greedy generation with the serving CLI's defaults
        Bg, P, G = SERVE_GEN
        prompts = TokenStream(vocab=cfg.vocab, seq_len=P, batch=Bg,
                              seed=0).batch_at(0, device="cuda")["tokens"]
        generate(model, prompts[:, :4], 2)          # warm-up
        torch.cuda.synchronize()
        t0 = time.time()
        out = generate(model, prompts, G)
        torch.cuda.synchronize()
        dt = time.time() - t0
        ok = tuple(out.shape) == (Bg, P + G) and torch.equal(out[:, :P], prompts) \
            and int(out.min()) >= 0 and int(out.max()) < cfg.padded_vocab
        emit({"phase": path, "step": "generate", "batch": Bg,
              "prompt": P, "gen": G, "wall_s": dt,
              "decode_steps": P + G - 1,
              "new_tokens_per_s": Bg * G / dt,
              "tokens_per_s_incl_prompt": Bg * (P + G - 1) / dt,
              "sample_row": out[0, -G:].tolist()})
        if not ok:
            raise AssertionError(f"{path} generate: bad output tokens")
        prof = profiled(torch, lambda: generate(model, prompts, G))
        emit({"phase": path, "step": "generate", "profile": prof})

        # 3. prefill's last logits against decoding the same prompt token by
        # token, in the model's bf16 and in an f32 copy of the same weights
        m32 = Model(cfg, device="cuda").float()
        m32.load_state_dict(model.state_dict())
        for m, gate in ((model, SERVE_GATES["bf16"]), (m32, SERVE_GATES["f32"])):
            full = make_prefill_step(m)({"tokens": prompts}).float()
            dec = decode_prompt(torch, m, prompts).float()
            err = float((full - dec).abs().max())
            rel = err / float(full.abs().max())
            agree = float((full.argmax(-1) == dec.argmax(-1)).float().mean())
            emit({"phase": path, "step": "prefill vs decode",
                  "dtype": str(m.dtype).split(".")[-1], "batch": Bg, "prompt": P,
                  "max_abs_err": err, "max_abs_logit": float(full.abs().max()),
                  "rel_err": rel, "gate_rel": gate, "argmax_agree": agree})
            if not (math.isfinite(rel) and rel <= gate):
                raise AssertionError(f"{path} prefill vs decode ({m.dtype}): "
                                     f"relative error {rel} > {gate}")
        del m32, full, dec
        torch.cuda.empty_cache()

        # 4. adaptive evaluation of the mean per-token loss
        e = SERVE_EVAL
        stream = TokenStream(vocab=cfg.vocab, seq_len=e["seq"], batch=e["batch"],
                             seed=0)
        t0 = time.time()
        mean, res = adaptive_eval(model, stream, eps=e["eps"], delta=e["delta"])
        dt = time.time() - t0
        emit({"phase": path, "step": "adaptive eval", **e,
              "value_range": 15.0, "strategy": "local", "rounds_per_epoch": 2,
              "max_epochs": 200, "mean_loss": mean, "tau": res.num,
              "epochs": res.epochs, "stopped": res.stopped,
              "half_width": float(res.aux["half_width"]),
              "tau_predicted": "308-312", "wall_s": dt,
              "samples_per_s": res.num / dt})
        if not (res.stopped and math.isfinite(mean) and 0.0 < mean < 15.0):
            raise AssertionError(f"{path} adaptive eval: stopped={res.stopped}, "
                                 f"mean {mean}")
        one = stream.batch_at(1, device="cuda")
        prof = profiled(torch, lambda: model.train_loss(one))
        emit({"phase": path, "step": "adaptive eval",
              "profile_of_one_sample": prof})


def main() -> int:
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print("chip_smoke.py: src/repro_torch not found beside this script",
              file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device", file=sys.stderr)
        return 2

    smi = nvidia_smi()
    emit({"phase": "device", "nvidia_smi": smi, "torch": torch.__version__,
          "cuda": torch.version.cuda, "python": sys.version.split()[0]})

    # a reference states and sets both: float32 products in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    mods = kernel_modules()
    phase_build(torch)

    from repro_torch.graphs import erdos_renyi
    t0 = time.time()
    g = erdos_renyi(FULL_N, FULL_M, seed=0, device="cuda")
    emit({"phase": "graph", "n": g.n, "arcs": g.m_arcs,
          "max_degree": g.max_degree, "build_s": time.time() - t0})

    wrs = wrs_full_instance()
    table, table_build_s = phase_wrs_table(torch, wrs)

    check = PlainCheck(torch)
    rows = phase_kernels(torch, Timer(torch), check, g, table)

    def drive(path, run, needs, every=False, ranks=None):
        """Run one path with every count set to 0 just before it and read
        just after; each kernel in ``needs`` must have launched.  Its kernel
        calls are held against the plain versions: each call with
        ``every``, else each (kernel, shape, type) not yet compared.
        ``ranks`` collects the reports of the worker processes the path
        starts (``rank_probe``); their launches, comparisons and calls by
        shape are added to this process's, and each kernel in ``needs``
        must have launched in them too."""
        with check.installed(every) as (compared, by_shape):
            for m in mods.values():
                m.launches = 0
            run()
            counts = {name: m.launches for name, m in mods.items()}
        in_ranks = dict.fromkeys(mods, 0)
        for r in ranks or ():
            for name in mods:
                in_ranks[name] += r["launches"][name]
                compared[name] += r["compared"][name]
                check.calls[name] += r["compared"][name]
                check.max_err[name] = max(check.max_err[name],
                                          r["max_err"][name])
                for shape, n in r["by_shape"].get(name, {}).items():
                    by_shape[name][shape] = by_shape[name].get(shape, 0) + n
        counts = {name: counts[name] + in_ranks[name] for name in mods}
        emit({"phase": "launches", "path": path, **counts,
              **({"in_worker_processes": in_ranks,
                  "worker_processes": len(ranks)} if ranks is not None else {}),
              "compared_with_plain": compared,
              "every_call_compared": every,
              "calls_by_shape": {k: v for k, v in by_shape.items() if v}})
        for name in needs:
            if counts[name] <= 0 or (ranks is not None and in_ranks[name] <= 0):
                raise AssertionError(f"{name} was not launched on the {path} path")
        return counts

    full = {"levels": {}}  # the full-size LOCAL run's calls and profile
    by_path = {
        "kadabra": drive("kadabra", lambda: (phase_accuracy(torch),
                                             phase_full(torch, g, full)),
                         ("frame_accum", "bfs_frontier")),
        "conformance": drive("conformance", lambda: phase_conformance(torch),
                             ("frame_accum", "bfs_frontier", "alias_draw"),
                             every=True),
        "wrs full": drive("wrs full",
                          lambda: phase_wrs_full(torch, wrs, table_build_s),
                          ("frame_accum", "alias_draw")),
    }
    # an estimate of bfs_frontier's time on the full-size LOCAL run, from its
    # calls by level and phase 4's time at each level (all 256 lanes active
    # there; a level past phase 4's last is taken at the last), beside the
    # time the LOCAL run's profile measured
    by_level = rows["bfs_frontier"].pop("by_level")
    levels = full["levels"]
    last = max(by_level)
    weighted = sum(c * by_level[min(lv, last)]["ms"] for lv, c in levels.items())
    measured = full["profile"]["port_kernels"]["bfs_frontier"]
    rows["bfs_frontier"]["kadabra_local_profiled_ms"] = measured["ms"]
    emit({"phase": "full", "bfs_frontier_calls_by_level":
              {str(k): v for k, v in sorted(levels.items())},
          "bfs_frontier_ms_weighted": weighted,
          "bfs_frontier_ms_profiled": measured["ms"],
          "levels_past_timed": sum(c for lv, c in levels.items() if lv > last)})
    by_path["pool"] = drive(
        "pool", lambda: phase_pool(torch, kadabra_full_instance(), wrs,
                                   graph=(g, full["pre"])),
        ("frame_accum", "bfs_frontier", "alias_draw"))
    substrate_ranks = []
    by_path["substrate"] = drive(
        "substrate",
        lambda: phase_substrate(torch, g, full, check, substrate_ranks),
        ("bfs_frontier", "alias_draw"), every=False, ranks=substrate_ranks)
    del g, table, wrs
    torch.cuda.empty_cache()
    model = serve_model(torch, RG_ARCH, "rg serve", RG_PARAMS)
    by_path["rg serve"] = drive(
        "rg serve", lambda: phase_serve(torch, model, "rg serve", RG_PREFILL),
        ("flash_attention", "rglru_scan"))
    del model
    torch.cuda.empty_cache()
    model = serve_model(torch, MAMBA_ARCH, "mamba serve", MAMBA_PARAMS)
    by_path["mamba serve"] = drive(
        "mamba serve",
        lambda: phase_serve(torch, model, "mamba serve", MAMBA_PREFILL),
        ("ssm_scan",))
    del model
    torch.cuda.empty_cache()

    meta = {
        "frame_accum": ("src/repro_torch/kernels/csrc/frame_accum.cu",
                        "src/repro/kernels/frame_accum.py:28"),
        "bfs_frontier": ("src/repro_torch/kernels/csrc/bfs_frontier.cu",
                         "src/repro/kernels/bfs_frontier.py:40"),
        "alias_draw": ("src/repro_torch/kernels/csrc/alias_draw.cu",
                       "src/repro/kernels/alias_draw.py:33"),
        "flash_attention": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                            "src/repro/kernels/flash_attention.py:81"),
        "rglru_scan": ("src/repro_torch/kernels/csrc/rglru_scan.cu",
                       "src/repro/kernels/rglru_scan.py:24"),
        "ssm_scan": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                     "src/repro/kernels/ssm_scan.py:32"),
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
