#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (``src/repro_torch``) once on one CUDA card.

    python3 chip_smoke.py

Phases, each printing JSON lines (``{"phase": ...}``); any failure raises
and the script exits non-zero:

1. device      — the card (nvidia-smi name and power limit), torch and CUDA.
2. build       — nvcc builds the six kernel sources from
                 ``src/repro_torch/kernels/csrc``, all at once, and prints
                 ptxas's registers, spills and shared memory of every
                 kernel of the six sources, and the HMMA/HGMMA count in
                 the SASS (``cuobjdump -sass``) of the bf16 attention
                 forward and of the bf16 and f32 (3xTF32) backward's dK/dV
                 and dQ kernels; a missing ptxas report, a spill, or an
                 instance of those without tensor-core instructions (TF32
                 HMMAs in the f32 backward's) fails.
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
                 and at phase 12's shapes (``FLASH_FAMILY_SHAPES``:
                 h2o-danube-3-4b's hd 120 prefill in bf16 and f32, its
                 ``adaptive_eval`` and f32 gate shapes, smollm-360m's hd 64,
                 qwen3-moe's hd 128), each timed beside its bound at the
                 true hd, the plain version and SDPA;
                 ``rglru_scan`` exactly at the prefill's (2, 4096, 2560),
                 timed there and at ``adaptive_eval``'s (4, 64, 2560), and
                 at a ragged (3, 100, 1000) and (1, 7, 1001); ``ssm_scan``
                 exactly at falcon-mamba-7b's prefill (2, 4096, 8192, 16),
                 at ``adaptive_eval``'s (4, 64, 8192, 16) (both timed) and
                 at a ragged (3, 100, 125, 3).  The backward kernels:
                 ``flash_attention``'s (with the forward's logsumexp) at
                 h2o-danube-3-4b's train shape (1, 32, 4096, 120) kv 8
                 window 4096 (in bf16 and in f32), recurrentgemma-2b's (1, 10, 4096, 256)
                 kv 1 window 2048 and the training CLI's smollm-360m
                 (4, 15, 512, 64) kv 5 in bf16 (timed beside the bound, the
                 plain backward and ``torch.autograd.grad`` through SDPA)
                 and a ragged f32 (2, 4, 100, 64); ``ssm_scan``'s exactly
                 at (1, 2048, 8192, 16) and ``rglru_scan``'s at
                 (1, 4096, 2560) (both timed) and at a ragged shape.
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
9b. pool-ranks — the pool's process-group sessions: a ``RankPool`` of 4
                 gloo ranks sharing the card, which load phase 6's graph
                 and phase 8's alias table from files written once;
                 ``POOL_QUERIES`` as shard_map sessions through phase 9's
                 drain (each equal to its phase 9 solo VMAP result), with
                 the spawn wall, drain wall, checked samples/s, each tick's
                 wall and the bytes and seconds of each pull and push (by
                 checkpoint and reshard); a drain stopped after 2 ticks and
                 resumed; two W = 2 kadabra-full sessions alone and then at
                 once on disjoint ranks; ``compressed_psum`` of a 2**24
                 f32 leaf over the 4 ranks, within its bounds.  The ranks'
                 launches join the ``pool-ranks`` path.
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
12. families   — the dense, moe, vlm and encdec families (random weights
                 from seed 0, each model freed before the next):
                 h2o-danube-3-4b at full width and depth (24 layers, d 3840,
                 32 heads on 8, hd 120, window 4096, bf16) through phase
                 10's steps (prefill B = 2, S = 8192, ``generate``, prefill
                 vs decode in bf16 and f32, ``adaptive_eval``);
                 smollm-360m (full size) through prefill B = 2, S = 4096,
                 ``generate`` and prefill vs decode; one prefill each of
                 internlm2-20b (full size, B = 1, S = 4096, peak memory),
                 mixtral-8x22b and qwen3-moe-235b-a22b (full width, 2
                 layers, B = 1, S = 4096, tokens dropped per expert, and
                 prefill vs decode at a capacity no expert overflows),
                 internvl2-76b (full width, 2 layers, 256 patches + 3840
                 tokens) and seamless-m4t-large-v2 (full size, B = 2,
                 S = 4096, 1024 frames).  ``flash_attention`` must run at
                 hd 120, 64 and 128 there.
13. train      — training on the card (``phase_train``): ``train_loss``'s
                 gradients in f32 on the card (every kernel forward and
                 backward) against the CPU's (the plain versions) for the
                 reduced h2o-danube-3-4b, recurrentgemma-2b,
                 falcon-mamba-7b and mixtral-8x22b, each leaf within 1e-4
                 of its largest magnitude; h2o-danube-3-4b at full size,
                 3 steps of ``make_train_step`` (AdamW, remat "full") on
                 2 micro-batches of (1, 4096), tokens/s, loss, grad norm,
                 peak memory, and a profile of a fourth step;
                 recurrentgemma-2b at full size and falcon-mamba-7b at full
                 width (4 of 64 layers), 3 steps each (the first cold);
                 the training CLI
                 (``launch/train.py``'s ``main``) on smollm-360m: 4 steps,
                 and a run preempted at 2 and resumed with the same losses
                 and final checkpoint (its ``--adaptive`` run is phase
                 16's ``train_adaptive_torch``).
16. examples   — (runs after phase 13, in this process) the examples'
                 analogues (``examples/*_torch.py``), each ``main(argv)``
                 called with its output captured (``EXAMPLE_RUNS``):
                 quickstart (its OK line); kadabra_bc on ER n = 300,
                 ε = 0.05 and on the 17 × 17 grid at W = 8 (each
                 strategy's max error ≤ ε); instances_demo at LOCAL W = 4
                 and INDEXED W = 4 (each instance's error ≤ its ε);
                 serve_adaptive's four flows (both pools drain 2 queries,
                 the second shrinks a session, 64 tokens generated, a
                 finite adaptive eval); train_adaptive on lm-100m
                 (124,667,904 parameters) at sequence 128 for 60 steps
                 with ``--adaptive`` (micro-batches ≤ 4, finite losses,
                 checkpoints at steps 50 and 60, their bytes and the
                 seconds they block).  A line a run: its wall and the
                 figures it printed.
14. zoo-mesh   — the model zoo on a mesh (``launch/sharded.py``,
                 ``launch/pipeline.py``): h2o-danube-3-4b at full width
                 cut in depth (seed 0, bf16; ``ZOO_DANUBE``) in this
                 process, then on one pool of 4 gloo ranks sharing the
                 card, the weights drawn shard by shard from seed 0,
                 under the default flags: 4 blocks on the (data 2,
                 model 2) mesh (a warm-up prefill, then the timed
                 prefill B = 2, S = 4096, and 2 decode steps from an
                 empty cache of 4096 slots at positions 2047 and 2048,
                 across the model ranks' halves of the slots) and 2
                 blocks on the (data 1, model 4) mesh (8 q heads and 2 kv
                 heads a rank; prefill B = 1, S = 2048, the same decode
                 steps), each logit within the bf16 gate of the
                 one-process run's; GPipe pipelines of one block a stage
                 over the 4 blocks (4 stages, 4 micro-batches of (1,
                 2048)) and the 2 blocks (ranks 0–1, 2 micro-batches of
                 (1, 1024)), each bit-equal to the blocks in a loop
                 (``torch.equal``, else the phase fails); every
                 ``flash_attention`` call on the ranks held against its
                 plain version; then on the same ranks
                 qwen3-moe-235b-a22b (2 layers), recurrentgemma-2b (5),
                 falcon-mamba-7b (1), internvl2-76b (1) and
                 seamless-m4t-large-v2 (4 + 4) at full width under their
                 full configs' default flags, each against the same
                 prefill and 2 decode steps in this process, within the
                 bf16 gate, every kernel call on the ranks held against
                 its plain version (recurrentgemma's and falcon-mamba's
                 each new kernel, shape and type: ``ZOO_SCAN_ONCE``).
                 Wall per step, weight bytes and peak memory per rank, the
                 collectives by kind (``analysis.comms``), moe's dropped
                 share.  The pool of 4 ranks is spawned once for phases
                 14 and 15.
15. train-mesh — sharded training of every family
                 (``launch/sharded.py`` ``train_rank``, AdamW on
                 DTensors, ZeRO-1, ``TRAIN_MESH_CASES``): h2o-danube-3-4b
                 at full width cut to 2 of 24 layers, two steps of
                 (n_micro 2, mb 2, S 2048); mixtral-8x22b (1 of 56
                 layers), falcon-mamba-7b (2 of 64), recurrentgemma-2b
                 (3 of 26: one unit), internvl2-76b (1 of 80; 256
                 patches + 1792 tokens) and seamless-m4t-large-v2 (2 + 2
                 of 24 + 24; 512 frames), one step each of (n_micro 1,
                 mb 2, S 2048); remat "full", bf16, seed 0, each in this
                 process first (its calls not compared), then on the
                 (data 2, model 2) mesh of phase 14's ranks under its
                 full config's default policy; each step's loss within
                 1e-2 and grad norm within 5e-2 (relative) of this
                 process's, each leaf's ``mu`` after the last step within
                 0.15 of its largest magnitude; every kernel call on the
                 ranks, forward and backward, held against its plain
                 version (remat's recompute of a forward call, on
                 bit-equal arguments, bit-equal to the compared call's
                 result); mixtral's ranks replay the one-process top-k
                 choices, each rank's own differing in at most 3 % of its
                 rows.  A line a model: a rank's step wall, weight,
                 gradient and optimizer-state bytes, peak memory,
                 collectives by kind (forward, backward, optimizer),
                 host-staged messages, moe's dropped share.
17. kernels    — every kernel (the three backward kernels too) with its
                 launches on the thirteen paths (phases 5–6, 7, 8, 9, 9a
                 and 9b — this process's and its worker processes' —, 10,
                 11, 12, 13, 16, 14 and 15), each counted from 0 just
                 before its path;
                 each path's line also splits its kernel calls by shape (the
                 kernels line repeats ``flash_attention``'s on the
                 families path).

While phases 5–16 run, in this process and in the worker processes of 9a,
9b, 14 and 15, the kernels behind ``kernels.ops`` (forward and backward) are
wrapped so that their calls are held against the plain versions on the
same tensors:
every call on the conformance path, and elsewhere each call whose kernel,
shapes and types phase 4 or an earlier call has not compared yet.

Then the card's name and power limit, then the result line
``{"ok": true, "device": {...}}``.  Imports no JAX and nothing of ``repro``.
"""

from __future__ import annotations

import contextlib
import gc
import json
import os
import re
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
TF32_OPS_PER_S = 495e12     # H100 SXM TF32 tensor cores, dense

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

# phase 12: the dense, moe, vlm and encdec families (random weights, seed 0)
DANUBE_ARCH = "h2o-danube-3-4b"   # the slice's main model, full width and depth
DANUBE_PREFILL = (2, 8192)        # twice the window of 4096
DANUBE_PARAMS = 3_961_839_360     # the config's closed form + the final norm
SMOLLM_ARCH = "smollm-360m"
SMOLLM_PREFILL = (2, 4096)
SMOLLM_PARAMS = 409_007_040
# (arch, depth kept or None for the full depth, parameters held, prefill
# (B, S)): one prefill each, the moe ones also prefill vs decode
FAMILY_PREFILLS = (
    ("internlm2-20b", None, 19_861_149_696, (1, 4096)),
    ("mixtral-8x22b", 2, 5_410_781_184, (1, 4096)),
    ("qwen3-moe-235b-a22b", 2, 6_220_173_312, (1, 4096)),
    ("internvl2-76b", 2, 3_812_663_296, (1, 4096)),        # 256 patches + 3840 tokens
    ("seamless-m4t-large-v2", None, 2_034_886_656, (2, 4096)),  # 1024 frames
)
# flash_attention at the families' shapes (phase 4): name, (B, H, KV, S, hd),
# window, dtype
FLASH_FAMILY_SHAPES = (
    ("danube prefill", (2, 32, 8, 8192, 120), 4096, "bfloat16"),
    ("danube adaptive_eval", (4, 32, 8, 64, 120), 4096, "bfloat16"),
    ("danube prefill f32", (2, 32, 8, 8192, 120), 4096, "float32"),
    ("danube f32 gate", (4, 32, 8, 32, 120), 4096, "float32"),
    ("smollm prefill", (2, 15, 5, 4096, 64), 0, "bfloat16"),
    ("qwen3-moe prefill", (1, 64, 4, 4096, 128), 0, "bfloat16"),
)

MAMBA_ARCH = "falcon-mamba-7b"
MAMBA_PREFILL = (2, 4096)   # batch, prompt length
# the parameters the model holds; the config's closed form leaves out each
# layer's conv_b and the final norm (64·8192 + 4096 = 528,384 fewer)
MAMBA_PARAMS = 7_272_665_088

# phase 13, train: the backward kernels' shapes in phase 4, then the steps
FLASH_BWD_SHAPES = (  # (name, (B, H, KV, S, hd), window, dtype, timed)
    ("h2o-danube-3-4b train", (1, 32, 8, 4096, 120), 4096, "bfloat16", True),
    # the f32 body (3xTF32 on the tensor cores, ``tf3::``) at the same shape
    ("h2o-danube-3-4b train f32", (1, 32, 8, 4096, 120), 4096, "float32", True),
    ("recurrentgemma-2b train", (1, 10, 1, 4096, 256), 2048, "bfloat16", True),
    # the training CLI's smollm-360m micro-batch, the train path's most
    # frequent backward call (2,560 a run), launch-sized
    ("smollm-360m CLI train", (4, 15, 5, 512, 64), 0, "bfloat16", True),
    ("ragged f32", (2, 4, 2, 100, 64), 0, "float32", False),
    # 16 key tiles, the last ragged, a window across tile edges
    ("tiles and window f32", (1, 8, 2, 1000, 120), 300, "float32", False),
    ("tiles and window bf16", (1, 8, 2, 1000, 120), 300, "bfloat16", False),
)
SSM_BWD_SHAPE = (1, 2048, 8192, 16)     # falcon-mamba-7b's train step
RGLRU_BWD_SHAPE = (1, 4096, 2560)       # recurrentgemma-2b's train step
TRAIN_GRAD_ARCHS = ("h2o-danube-3-4b-reduced", "recurrentgemma-2b-reduced",
                    "falcon-mamba-7b-reduced", "mixtral-8x22b-reduced")
TRAIN_GRAD_BATCH = (2, 160)  # three key tiles of flash_attention_bwd
TRAIN_GRAD_TOL = 1e-4       # of each leaf's largest magnitude (the CPU tests')
DANUBE_TRAIN = (2, 1, 4096)  # n_micro, micro-batch, S: 8,192 tokens a step
DANUBE_TRAIN_STEPS = 3
RG_TRAIN = (1, 4096)
MAMBA_TRAIN = (1, 2048)
OTHER_TRAIN_STEPS = 3        # rg's and mamba's: the first is cold, the rest warm
MAMBA_TRAIN_LAYERS = 4       # 64 → 4: its AdamW state at full depth is ~87 GB
MAMBA_TRAIN_PARAMS = 953_929_728
CLI_ARGS = ("--arch", "smollm-360m", "--batch", "8", "--seq", "512",
            "--micro", "2", "--log-every", "1")
# 4 steps, preempted at 2: cut from 20 and 5 to keep the script inside its
# time limit once phase 14 ran every family, and from 10 and 3 once phase
# 15 trained every family; once phase 15 joined, no periodic checkpoint
# (every 5 before): a run saves at its preemption and at its end only (4.1
# GB of train state, ~10 s a save on the card's host)
CLI_STEPS, CLI_CKPT_EVERY, CLI_PREEMPT = 4, 20, 2


T0 = time.monotonic()


def emit(obj) -> None:
    """One JSON line; a phase's line gets ``t_s``, the seconds since the
    script started."""
    if "phase" in obj:
        obj = {**obj, "t_s": time.monotonic() - T0}
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
    "ssm_scan": ("ssm_scan_kernel",),
    # D, then dK/dV and dQ: the f32 3xTF32 body's and the bf16 body's (with
    # the sum of its dK/dV parts where it splits that grid)
    "flash_attention_bwd": ("flash_bwd_dot_kernel", "flash_bwd_tf3_dkdv_kernel",
                            "flash_bwd_tf3_dq_kernel", "flash_bwd_tc_dkdv_kernel",
                            "flash_bwd_tc_dq_kernel", "flash_bwd_tc_sum_kernel"),
    # rglru_scan_bwd's and ssm_scan_bwd's: the lane body and the ring body
    "scan_bwd": ("scan_bwd_kernel", "scan_bwd_ring_kernel"),
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
    library, by ``cuobjdump -sass``, and of them the ``HMMA``s on TF32
    operands (``HMMA_TF32``); None where the toolkit has none."""
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
                         "HMMA_TF32": len(re.findall(r"\bHMMA\.\S*TF32", part)),
                         "HGMMA": len(re.findall(r"\bHGMMA\.", part))}
    return counts


def phase_build(torch) -> None:
    """Build every kernel at once; print ptxas's registers, spills and
    shared memory of every source's kernels (from the log kept beside
    each library, so also when it was built before) and the attention
    bodies' tensor-core instructions in the SASS.  A missing report, a
    spill, or a tensor-core body without them (TF32 ones in the f32
    backward's) fails."""
    from repro_torch.kernels import build

    t0 = time.time()
    build.build_all()
    emit({"phase": "build", "nvcc_s": time.time() - t0,
          "flags": " ".join(build.NVCC_FLAGS)})
    for name in ("bfs_frontier", "flash_attention", "rglru_scan", "ssm_scan",
                 "alias_draw", "frame_accum"):
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
        # the bf16 forward, the bf16 backward's dK/dV and dQ kernels and the
        # f32 backward's (3xTF32: TF32 HMMAs), at every padded HD and copy
        # width (the backward's D kernel is a dot product over hd, bytes only)
        any_mma, tf32 = ("HMMA", "HGMMA"), ("HMMA_TF32",)
        for body, keys in (("flash_bf16", any_mma), ("flash_bwd_tc_dkdv", any_mma),
                           ("flash_bwd_tc_dq", any_mma), ("flash_bwd_tf3_dkdv", tf32),
                           ("flash_bwd_tf3_dq", tf32)):
            found = {k: c for k, c in mma.items() if k.startswith(body + "_kernel<")}
            if len(found) != 15 or not all(sum(c[k] for k in keys) > 0
                                           for c in found.values()):
                raise AssertionError(f"{body}: not 15 instances (5 head dims "
                                     f"× 3 copy widths), or one without "
                                     f"tensor-core instructions ({'/'.join(keys)}) "
                                     f"in its SASS: {found}")


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
    port's kernels, so they move no count.  ``paused()`` leaves the calls
    of a block uncompared (this process's reference runs beside ranks that
    compare theirs).  With ``recompute``, a call whose arguments are bit-
    equal to an earlier compared call's (remat's recompute of a forward)
    is held ``torch.equal`` to that call's result, which its plain version
    passed; any other call is compared with its plain version.  Only the
    forward kernels' compared calls are kept for this (the backward's
    never repeat), each until its one recompute."""

    RECOMPUTED = ("flash_attention", "rglru_scan", "ssm_scan")

    NAMES = ("frame_accum", "bfs_frontier", "alias_draw", "flash_attention",
             "rglru_scan", "ssm_scan", "flash_attention_bwd", "rglru_scan_bwd",
             "ssm_scan_bwd")
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
        # f32 sums in other orders; bf16 rounds P and dS as the products'
        # operands and dq, dk, dv once
        "flash_attention_bwd": "each (b, head, position) row of dq, dk, dv: "
                               "max |err| ≤ tol · the row's max |plain| + hd · "
                               "2^-24 · the row's max of the backward over "
                               "absolute values; float32 tol 1e-4, bfloat16 "
                               "tol 2e-2",
        "rglru_scan_bwd": "exact (torch.equal; one FMA a step in both)",
        "ssm_scan_bwd": "exact (torch.equal; one FMA a step in both)",
    }
    FLASH_TOL = {"torch.float32": 1e-5, "torch.bfloat16": 2e-2}
    FLASH_BWD_TOL = {"torch.float32": 1e-4, "torch.bfloat16": 2e-2}

    def __init__(self, torch):
        self.torch = torch
        self.seen = set()
        self.max_err = dict.fromkeys(self.NAMES, 0.0)
        self.calls = dict.fromkeys(self.NAMES, 0)
        self.compare_s = 0.0  # host seconds spent in the comparisons
        self.flash_bwd_rows = []
        self.paused_now = False
        self.recomputed = dict.fromkeys(self.NAMES, 0)  # held to an earlier call
        self.compared = {}  # key → [(arguments, result)] of the compared calls

    @contextlib.contextmanager
    def paused(self):
        was, self.paused_now = self.paused_now, True
        try:
            yield
        finally:
            self.paused_now = was

    def _same(self, x, y) -> bool:
        torch = self.torch
        if isinstance(x, torch.Tensor) or isinstance(y, torch.Tensor):
            return isinstance(x, torch.Tensor) and isinstance(y, torch.Tensor) \
                and x.dtype == y.dtype and torch.equal(x, y)
        if isinstance(x, (tuple, list)) or isinstance(y, (tuple, list)):
            return isinstance(x, (tuple, list)) and isinstance(y, (tuple, list)) \
                and len(x) == len(y) and all(map(self._same, x, y))
        return x == y

    def _copy(self, x):
        if isinstance(x, self.torch.Tensor):
            return x.detach().clone()
        if isinstance(x, (tuple, list)):
            return tuple(self._copy(v) for v in x)
        return x

    def held_to_earlier(self, name, key, args, got) -> bool:
        """``got`` bit-equal to the result of an earlier compared call of
        ``key`` on bit-equal arguments: counted as compared, and that
        call's copy dropped."""
        kept = self.compared.get(key, [])
        for i, (a, g) in enumerate(kept):
            if self._same(a, args) and self._same(g, got):
                del kept[i]
                self.calls[name] += 1
                self.recomputed[name] += 1
                return True
        return False

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
    def flash_key(q, k, v, window, return_lse=False):
        return ("flash_attention", str(q.dtype), tuple(q.shape),
                tuple(k.shape), window, bool(return_lse))

    def compare_flash(self, q, k, v, window, *rest):
        """``rest``: (got,), or (return_lse, got) as the autograd forward
        calls the kernel; with the logsumexp, it is held within 1e-5 of
        max(max |plain|, 1)."""
        from repro_torch.kernels import ref
        torch = self.torch
        with_lse, got = (rest[0], rest[1]) if len(rest) == 2 else (False, rest[0])
        exp = ref.flash_attention_ref(q, k, v, window=window,
                                      return_lse=bool(with_lse))
        torch.cuda.synchronize()
        if with_lse:
            (got, lse), (exp, lse_exp) = got, exp
            err = float((lse - lse_exp).abs().max())
            if not err <= 1e-5 * max(float(lse_exp.abs().max()), 1.0):
                raise AssertionError(f"flash_attention lse q {tuple(q.shape)} "
                                     f"{q.dtype} window {window}: |err| {err}")
        tol = self.FLASH_TOL[str(q.dtype)]
        torch.testing.assert_close(got, exp, rtol=tol, atol=tol,
                                   msg=lambda m: f"flash_attention q "
                                                 f"{tuple(q.shape)} k "
                                                 f"{tuple(k.shape)} {q.dtype} "
                                                 f"window {window}: {m}")
        self._done("flash_attention",
                   self.flash_key(q, k, v, window, with_lse), got, exp)

    @staticmethod
    def flash_bwd_key(q, k, v, o, lse, do, window):
        return ("flash_attention_bwd", str(q.dtype), tuple(q.shape),
                tuple(k.shape), window)

    def compare_flash_bwd(self, q, k, v, o, lse, do, window, got):
        """Each gradient row by row (``ref.flash_attention_bwd_check``);
        the gradients' errors, largest plain values and worst rows are
        kept in ``flash_bwd_rows``, one entry a comparison."""
        from repro_torch.kernels import ref
        torch = self.torch
        torch.cuda.synchronize()
        tol = self.FLASH_BWD_TOL[str(q.dtype)]
        res = ref.flash_attention_bwd_check(q, k, v, o, lse, do, got,
                                            window=window, tol=tol)
        for name, r in res.items():
            if not r["worst"] <= 1.0:
                raise AssertionError(
                    f"flash_attention_bwd {name} q {tuple(q.shape)} k "
                    f"{tuple(k.shape)} {q.dtype} window {window}: a row's "
                    f"error is {r['worst']} times its allowance ({r})")
            self.max_err["flash_attention_bwd"] = max(
                self.max_err["flash_attention_bwd"], r["max_abs_err"])
        self.flash_bwd_rows.append({"q": list(q.shape), "kv": list(k.shape),
                                    "dtype": str(q.dtype), "window": window,
                                    **res})
        self.seen.add(self.flash_bwd_key(q, k, v, o, lse, do, window))
        self.calls["flash_attention_bwd"] += 1

    def compare_scan_bwd(self, name, a, h, g, got):
        from repro_torch.kernels import ref
        torch = self.torch
        exp = ref.scan_bwd_ref(a, h, g)
        torch.cuda.synchronize()
        for part, x, e in zip(("da", "db"), got, exp):
            if not torch.equal(x, e):
                raise AssertionError(f"{name} {part} differs from its plain "
                                     f"version at {tuple(a.shape)}: "
                                     f"{int((x != e).sum())} values")
        self.seen.add((name, tuple(a.shape)))
        self.calls[name] += 1

    def compare_rglru(self, a, b, got):
        """The plain version on the host: its loop launches some 17
        kernels a step, which on the card is launch-bound (seconds a call
        at the prefill's shapes, the more so in ranks that share the
        card); the f64 arithmetic that emulates the FMA gives the same
        bits there."""
        from repro_torch.kernels import ref
        torch = self.torch
        exp = ref.rglru_scan_ref(a.cpu(), b.cpu())
        got = got.cpu()
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
    def installed(self, every: bool, recompute: bool = False):
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
                   "ssm_scan": ops._ssm_kernel,
                   "flash_attention_bwd": ops._flash_bwd_kernel,
                   "rglru_scan_bwd": ops._rglru_bwd_kernel,
                   "ssm_scan_bwd": ops._ssm_bwd_kernel}
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
                if not self.paused_now and (every or key not in self.seen):
                    t0 = time.time()
                    if not (recompute and self.held_to_earlier(name, key, args,
                                                               got)):
                        compare(*args, got)
                        if recompute and name in self.RECOMPUTED:
                            self.compared.setdefault(key, []).append(
                                (self._copy(args), self._copy(got)))
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
            "_flash_bwd_kernel": wrap("flash_attention_bwd", self.flash_bwd_key,
                                      self.compare_flash_bwd),
            "_rglru_bwd_kernel": wrap(
                "rglru_scan_bwd", lambda a, h, g: ("rglru_scan_bwd", tuple(a.shape)),
                lambda a, h, g, got: self.compare_scan_bwd("rglru_scan_bwd", a,
                                                           h, g, got)),
            "_ssm_bwd_kernel": wrap(
                "ssm_scan_bwd", lambda a, h, g: ("ssm_scan_bwd", tuple(a.shape)),
                lambda a, h, g, got: self.compare_scan_bwd("ssm_scan_bwd", a, h,
                                                           g, got)),
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


def device_events(torch, prof):
    """(name, ms) of each device activity ``prof`` recorded, read from the
    profiler's own (kineto) events: the durations ``prof.events()`` gives,
    without building its tree of Python events, which cost a profile of
    a decode loop more host time than the loop itself."""
    cuda = torch.autograd.DeviceType.CUDA
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == cuda and \
                not getattr(e, "is_hidden_event", lambda: False)():
            yield e.name(), e.duration_ns() / 1e6


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
    for name, t in device_events(torch, prof):
        ms, count = by_name.get(name, (0.0, 0))
        by_name[name] = (ms + t, count + 1)
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
    for name, t in device_events(torch, prof):
        for part in parts:
            if part in name:
                ms[part] += t / reps
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
    rows["flash_attention_bwd"] = kernel_flash_attention_bwd(torch, timer, check, gen)
    rows["rglru_scan_bwd"] = kernel_scan_bwd(torch, timer, check, gen, "rglru_scan")
    rows["ssm_scan_bwd"] = kernel_scan_bwd(torch, timer, check, gen, "ssm_scan")
    return rows


def kernel_flash_attention_bwd(torch, timer, check, gen):
    """``flash_attention``'s backward kernel against its plain backward at
    ``FLASH_BWD_SHAPES``: h2o-danube-3-4b's, recurrentgemma-2b's and the
    training CLI's smollm-360m train shapes in bf16 and danube's in f32
    (timed beside the bound, the plain backward and ``torch.autograd.grad``
    through ``scaled_dot_product_attention``), a small ragged f32 one, and
    one of 16 key tiles with a window across tile edges in both types; each
    row reports every gradient's largest error and plain value.  The bound:
    5 products × 2 × hd × admissible pairs × B × H at the dtype's rate,
    against the bytes of q, k, v, o, dO, lse (read) and dq, dk, dv
    (written); in f32 also the bound of the body's own arithmetic,
    ``bound_tf32x3_ms``: 3xTF32 runs each product three times at the TF32
    tensor-core rate.  The library call is the fastest of SDPA with the
    boolean mask and ``enable_gqa`` and, where the mask is plain causal (no
    window, or one of S or more), SDPA with ``is_causal`` on K and V as given
    (``enable_gqa``) and on K and V repeated to the query heads inside the
    differentiated graph (the group's sum in its backward)."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import (flash_attention,
                                                     flash_attention_bwd)

    out = []
    for name, (B, H, KV, S, hd), window, dtype, timed in FLASH_BWD_SHAPES:
        dt = getattr(torch, dtype)
        q, k, v, do = [torch.randn((B, S, n, hd), generator=gen, device="cuda")
                       .to(dt).transpose(1, 2) for n in (H, KV, KV, H)]
        o, lse = flash_attention(q, k, v, window=window, return_lse=True)
        check.compare_flash(q, k, v, window, True, (o, lse))
        bwd = lambda: flash_attention_bwd(q, k, v, o, lse, do, window=window)  # noqa: E731
        check.compare_flash_bwd(q, k, v, o, lse, do, window, bwd())
        row = {"shape_name": name, "dtype": dtype, "q": list(q.shape),
               "kv": list(k.shape), "window": window,
               "grads": {g: check.flash_bwd_rows[-1][g] for g in ("dq", "dk", "dv")}}
        if timed:
            pairs = B * H * attention_pairs(S, window)
            es = q.element_size()
            nbytes = es * (4 * q.numel() + 4 * k.numel()) + 4 * lse.numel()
            ops = 5 * 2 * hd * pairs
            t_bound, by = bound_ms(nbytes, ops, BF16_OPS_PER_S if dt == torch.bfloat16
                                   else F32_OPS_PER_S)
            pos = torch.arange(S, device="cuda")
            mask = pos[None, :] <= pos[:, None]
            if window > 0:
                mask &= pos[None, :] > pos[:, None] - window
            leaves = [t.detach().clone().requires_grad_() for t in (q, k, v)]
            G = H // KV
            graphs = {"boolean mask, enable_gqa": F.scaled_dot_product_attention(
                *leaves, attn_mask=mask, enable_gqa=True)}
            if window == 0 or window >= S:
                graphs["is_causal, enable_gqa"] = F.scaled_dot_product_attention(
                    *leaves, is_causal=True, enable_gqa=True)
                graphs["is_causal, K and V repeated to the query heads"] = \
                    F.scaled_dot_product_attention(
                        leaves[0], leaves[1].repeat_interleave(G, dim=1),
                        leaves[2].repeat_interleave(G, dim=1), is_causal=True)
            library = {how: timer(lambda y=y: torch.autograd.grad(
                y, leaves, do, retain_graph=True), reps=10) for how, y in graphs.items()}
            fastest = min(library, key=library.get)
            row.update({
                "admissible_pairs": pairs, "flops": ops, "bytes": nbytes,
                "forward_bound_ms": bound_ms(es * (2 * q.numel() + 2 * k.numel()),
                                             4 * hd * pairs, BF16_OPS_PER_S)[0],
                "ms": timer(bwd, reps=10),
                "plain_ms": timer(lambda: ref.flash_attention_bwd_ref(
                    q, k, v, o, lse, do, window=window), reps=3, warmup=1),
                "bound_ms": t_bound, "bound_by": by,
                **({"bound_tf32x3_ms": bound_ms(nbytes, 3 * ops, TF32_OPS_PER_S)[0]}
                   if dt == torch.float32 else {}),
                "library_ms": library[fastest],
                "library": "torch.autograd.grad through F.scaled_dot_product_"
                           f"attention({fastest})",
                "library_variants_ms": library})
            del leaves, graphs, mask
        emit({"phase": "kernels", "kernel": "flash_attention_bwd",
              "max_abs_err": check.max_err["flash_attention_bwd"],
              "tolerance": check.TOLERANCE["flash_attention_bwd"], **row})
        out.append(row)
        del q, k, v, do, o, lse
        torch.cuda.empty_cache()
    main = dict(out[0])
    main["shapes"] = out[1:]
    return main


def kernel_scan_bwd(torch, timer, check, gen, name):
    """A scan's backward kernel exactly against its plain backward at the
    train step's shape (``RGLRU_BWD_SHAPE``, ``SSM_BWD_SHAPE``) and at a
    ragged one, timed at the former beside its bound: bytes, 5 × 4 an
    element (read a, h, g; write da, db)."""
    from repro_torch.kernels import ref
    from repro_torch.kernels import rglru_scan as rglru_mod
    from repro_torch.kernels import ssm_scan as ssm_mod

    mod = rglru_mod if name == "rglru_scan" else ssm_mod
    fwd, bwd = getattr(mod, name), getattr(mod, f"{name}_bwd")
    full = RGLRU_BWD_SHAPE if name == "rglru_scan" else SSM_BWD_SHAPE
    ragged = (3, 70, 1001) if name == "rglru_scan" else (2, 33, 125, 3)
    for shape in (ragged, full):
        a = torch.rand(shape, generator=gen, device="cuda") * 0.75 + 0.2
        b = torch.randn(shape, generator=gen, device="cuda")
        g = torch.randn(shape, generator=gen, device="cuda")
        h = fwd(a, b)
        check.compare_scan_bwd(f"{name}_bwd", a, h, g, bwd(a, h, g))
    t_bound, by = bound_ms(5 * 4 * a.numel(), 3 * a.numel())
    row = {"shape": list(full), "checked": [list(ragged), list(full)],
           "ms": timer(lambda: bwd(a, h, g)),
           "plain_ms": timer(lambda: ref.scan_bwd_ref(a, h, g), reps=1, warmup=0),
           "bound_ms": t_bound, "bound_by": by, "library_ms": None}
    emit({"phase": "kernels", "kernel": f"{name}_bwd",
          "max_abs_err": check.max_err[f"{name}_bwd"],
          "tolerance": check.TOLERANCE[f"{name}_bwd"],
          "library": "none (no single PyTorch call runs a linear recurrence "
                     "or its gradient)", **row})
    del a, b, g, h
    torch.cuda.empty_cache()
    return row


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
    row["families_shapes"] = [flash_family_shape(torch, timer, check, gen, *spec)
                              for spec in FLASH_FAMILY_SHAPES]
    return row


def flash_family_shape(torch, timer, check, gen, name, shape, window, dtype):
    """``flash_attention`` at one of phase 12's shapes, held against its
    plain version and timed beside its bound, counted at the true hd (the
    kernel pads hd to 16, 32, 64, 128 or 256), the plain version and
    ``scaled_dot_product_attention`` on the same GQA inputs and boolean
    mask."""
    import torch.nn.functional as F

    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import PADDED_HEAD_DIMS, flash_attention

    B, H, KV, S, hd = shape
    dt = getattr(torch, dtype)
    q, k, v = [torch.randn((B, S, n, hd), generator=gen, device="cuda")
               .to(dt).transpose(1, 2) for n in (H, KV, KV)]
    check.compare_flash(q, k, v, window, flash_attention(q, k, v, window=window))
    pairs = B * H * attention_pairs(S, window)
    nbytes = q.element_size() * (2 * q.numel() + k.numel() + v.numel())
    ops = 4 * hd * pairs
    padded = min(p for p in PADDED_HEAD_DIMS if p >= hd)
    t_bound, by = bound_ms(nbytes, ops, BF16_OPS_PER_S if dt == torch.bfloat16
                           else F32_OPS_PER_S)
    pos = torch.arange(S, device="cuda")
    mask = pos[None, :] <= pos[:, None]
    if window > 0:
        mask &= pos[None, :] > pos[:, None] - window
    row = {"name": name, "dtype": dtype, "q": list(q.shape), "kv": list(k.shape),
           "window": window, "padded_hd": padded,
           "padded_products_share": 1 - hd / padded,
           "admissible_pairs": pairs, "flops_true_hd": ops, "bytes": nbytes,
           "ms": timer(lambda: flash_attention(q, k, v, window=window)),
           "plain_ms": timer(lambda: ref.flash_attention_ref(q, k, v, window=window),
                             reps=3, warmup=1),
           "bound_ms": t_bound, "bound_by": by,
           "library_ms": timer(lambda: F.scaled_dot_product_attention(
               q, k, v, attn_mask=mask, enable_gqa=True)),
           "library": "F.scaled_dot_product_attention(enable_gqa=True, "
                      "boolean mask)"}
    emit({"phase": "kernels", "kernel": "flash_attention", "path": "families",
          "max_abs_err": check.max_err["flash_attention"],
          "tolerance": check.TOLERANCE["flash_attention"], **row})
    del q, k, v, mask
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


def phase_pool(torch, kad, wrs, graph=None, device="cuda", solo_out=None):
    """The adaptive-query pool at full size: ``POOL_QUERIES`` through
    ``EpochScheduler`` (2 in flight, 4 slots, shrink-regrow, a checkpoint
    every tick), each query held against its solo session and the solo
    session against ``run_instance``; a second drain stopped after 2 ticks
    and resumed from its checkpoints; a checkpoint of the kadabra-full
    SHARED session timed; the ``--pool`` CLI, then ``--resume``.
    ``graph`` is phase 6's (graph, preprocessing), which ``kad``'s build
    then finds in the instance cache instead of building them again; each
    query's solo (estimate, result, wall) goes into ``solo_out``."""
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
    if solo_out is not None:
        solo_out.update(solo)
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


class BwdCounter:
    """A wrapper module's backward launch counter (``bwd_launches``) under
    the name ``launches``, as ``drive`` and ``probed`` read and reset it."""

    def __init__(self, mod):
        self.mod = mod

    @property
    def launches(self):
        return self.mod.bwd_launches

    @launches.setter
    def launches(self, n):
        self.mod.bwd_launches = n


def kernel_modules() -> dict:
    from repro_torch.kernels import alias_draw as alias_mod
    from repro_torch.kernels import bfs_frontier as bfs_mod
    from repro_torch.kernels import flash_attention as flash_mod
    from repro_torch.kernels import frame_accum as accum_mod
    from repro_torch.kernels import rglru_scan as rglru_mod
    from repro_torch.kernels import ssm_scan as ssm_mod
    return {"frame_accum": accum_mod, "bfs_frontier": bfs_mod,
            "alias_draw": alias_mod, "flash_attention": flash_mod,
            "rglru_scan": rglru_mod, "ssm_scan": ssm_mod,
            "flash_attention_bwd": BwdCounter(flash_mod),
            "rglru_scan_bwd": BwdCounter(rglru_mod),
            "ssm_scan_bwd": BwdCounter(ssm_mod)}


@contextlib.contextmanager
def probed(group, every: bool, recompute: bool = False):
    """In a worker process: hold the kernels' calls against their plain
    versions (every call, or each new shape; ``recompute`` as in
    ``PlainCheck``), count the launches from 0, and yield (report,
    check); the report is filled when the block ends: launches,
    comparisons (of them, those held to an earlier call's result) and
    calls by shape per kernel, the largest error, the seconds spent
    comparing, and the jax/repro modules the process imported (raises if
    there are any)."""
    import torch
    mods = kernel_modules()
    check = PlainCheck(torch)
    report = {"rank": group.rank, "world": group.world,
              "backend": group.backend}
    with check.installed(every, recompute) as (compared, by_shape):
        for m in mods.values():
            m.launches = 0
        yield report, check
        report["launches"] = {name: m.launches for name, m in mods.items()}
    check.compared.clear()
    report["compared"] = dict(compared)
    report["held_to_earlier_call"] = {k: v for k, v in check.recomputed.items()
                                      if v}
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


def write_graph(d: Path, g, pre) -> None:
    """Phase 6's graph and preprocessing as files for the worker
    processes (``load_graph``)."""
    import numpy as np
    arrays = {"indptr": g.indptr, "indices_padded": g.indices_padded,
              "src": g.src, "dst": g.dst, "components": pre.components}
    for name in GRAPH_ARRAYS:
        np.save(d / f"{name}.npy", arrays[name].cpu().numpy())
    (d / "meta.json").write_text(json.dumps(
        {"n": g.n, "omega": pre.omega, "vd_upper": pre.vd_upper,
         "diam_levels": pre.diam_levels}))


def load_graph(d: Path, dev):
    """In a worker process: kadabra-full registered over the graph and
    preprocessing ``write_graph`` wrote (the registry and the instance
    cache are per process), on ``dev``."""
    import numpy as np
    import torch

    from repro_torch.core import instances
    from repro_torch.core.instances import register_instance
    from repro_torch.graphs.csr import graph_from_arrays
    from repro_torch.graphs.kadabra import Preprocessed

    meta = json.loads((d / "meta.json").read_text())
    a = {k: np.load(d / f"{k}.npy") for k in GRAPH_ARRAYS}
    g = graph_from_arrays(meta["n"], a["indptr"], a["indices_padded"],
                          a["src"], a["dst"], dev)
    pre = Preprocessed(omega=meta["omega"], vd_upper=meta["vd_upper"],
                       components=torch.from_numpy(a["components"]).to(dev),
                       diam_levels=meta["diam_levels"])
    kad = kadabra_full_instance()
    instances._CACHE[("kadabra", kad, dev)] = (g, pre,
                                               np.full((g.n,), np.nan))
    register_instance(kad, overwrite=True)
    return kad


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

    from repro_torch.core import distributed
    from repro_torch.core.instances import run_instance

    dev = group.device
    kad = load_graph(Path(graph_dir), dev)
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
        write_graph(Path(tmp), g, pre)
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


# phase 9b: the pool's process-group sessions on a rank pool sharing the card
POOL_RANKS = 4              # gloo ranks on cuda:0 (NCCL: one rank a card)
POOL_RANKS_PAIR = ("kadabra-full:local:2:0", "kadabra-full:local:2:1")
COMPRESS_ELEMENTS = 16 * 2 ** 20
COMPRESS_STEPS = 3
_RANK_PROBE: dict = {}


def pool_rank_setup(group, graph_dir, wrs_dir):
    """A rank of phase 9b's pool: kadabra-full over phase 6's graph and
    wrs-full over phase 8's alias table, from the files the controller
    wrote (no graph build, no Vose loop), then its kernel calls held
    against their plain versions and counted from 0 until
    ``pool_rank_report``."""
    import numpy as np
    import torch

    from repro_torch.core import instances
    from repro_torch.core.instances import register_instance
    from repro_torch.sampling.alias import AliasTable

    dev = group.device
    load_graph(Path(graph_dir), dev)
    d = Path(wrs_dir)
    wrs = wrs_full_instance()
    a = {k: torch.from_numpy(np.load(d / f"{k}.npy")).to(dev)
         for k in ("prob", "alias", "values")}
    mu = json.loads((d / "meta.json").read_text())["mu"]
    instances._CACHE[("wrs", wrs, dev)] = (
        AliasTable(n=a["prob"].shape[0], prob=a["prob"], alias=a["alias"]),
        a["values"], mu)
    register_instance(wrs, overwrite=True)
    probe = probed(group, every=False)
    _RANK_PROBE["probe"] = probe
    _RANK_PROBE["report"] = probe.__enter__()[0]


def pool_rank_report(group):
    """The rank's probe report (``probed``), its launches since
    ``pool_rank_setup``."""
    _RANK_PROBE.pop("probe").__exit__(None, None, None)
    return _RANK_PROBE.pop("report")


def tree_bytes(tree) -> int:
    from repro_torch.core.epoch import map_tree
    n = [0]
    map_tree(lambda x: n.__setitem__(0, n[0] + x.numel() * x.element_size()),
             tree)
    return n[0]


@contextlib.contextmanager
def moves_timed(stats):
    """Time each pull and push of a state between the ranks and this
    process, by what moved it (``checkpoint`` in ``save``, ``reshard`` in
    the scheduler's reshards): {kind: {"pull"/"push": [n, s, bytes]}},
    and {"bytes_by_shape": {shape: bytes of its last pull}}."""
    from repro_torch.serve import scheduler as sched_mod
    from repro_torch.serve.ranks import RankStepper
    from repro_torch.serve.session import AdaptiveSession
    saved = (RankStepper.pull, RankStepper.push, AdaptiveSession.save,
             sched_mod.reshard_session)
    kind = ["other"]

    def timed(name, fn):
        def call(self, arg):
            t0 = time.time()
            out = fn(self, arg)
            rec = stats.setdefault(kind[0], {}).setdefault(name, [0, 0.0, 0])
            rec[0] += 1
            rec[1] += time.time() - t0
            nbytes = tree_bytes(out if name == "pull" else arg)
            rec[2] += nbytes
            if name == "pull":
                spec = self.spec
                stats.setdefault("bytes_by_shape", {})[
                    f"{spec.instance}:{spec.strategy}:{spec.world}"] = nbytes
            return out
        return call

    def labelled(label, fn):
        def call(*a, **kw):
            kind[0] = label
            try:
                return fn(*a, **kw)
            finally:
                kind[0] = "other"
        return call

    RankStepper.pull = timed("pull", saved[0])
    RankStepper.push = timed("push", saved[1])
    AdaptiveSession.save = labelled("checkpoint", saved[2])
    sched_mod.reshard_session = labelled("reshard", saved[3])
    try:
        yield stats
    finally:
        (RankStepper.pull, RankStepper.push, AdaptiveSession.save,
         sched_mod.reshard_session) = saved


def phase_pool_ranks(torch, g, pre, wrs, table, solo, rank_reports,
                     device="cuda"):
    """Phase 9b: the pool's process-group sessions.  A rank pool of
    ``POOL_RANKS`` gloo ranks sharing the card; ``POOL_QUERIES`` as
    shard_map sessions (each on the ranks of its lease) through
    ``EpochScheduler`` with phase 9's settings (shrink-regrow over 4
    slots, a checkpoint every tick, phase 9's order), each equal to
    phase 9's solo VMAP result (``solo``); a drain stopped after 2 ticks
    and resumed; the two W = 2 sessions ``POOL_RANKS_PAIR`` alone and then
    at once on disjoint ranks; ``compressed_psum`` of a
    ``COMPRESS_ELEMENTS`` f32 leaf over the 4 ranks.  The ranks' probe
    reports go to ``rank_reports``."""
    import dataclasses
    import shutil
    import tempfile

    import numpy as np

    from repro_torch.launch.spawn import RankPool, foreign_modules, rank_info
    from repro_torch.optim.compress import compress_on_rank
    from repro_torch.serve import (AdaptiveSession, DevicePool,
                                   EpochScheduler, PressurePolicy, SessionSpec,
                                   StepperCache)
    from repro_torch.serve.ranks import make_groups

    def sync():
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    qid = {q: q.replace(":", "-") for q in POOL_QUERIES}
    order = pool_order(solo)

    def same(r, q):
        est, res, _ = solo[q]
        return r.stopped and (r.tau, r.epochs, r.stop_epoch) == \
            (res.num, res.epochs, res.stop_epoch) and \
            np.array_equal(r.estimate, est)

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_ranks_"))
    pool = None
    try:
        (tmp / "graph").mkdir()
        write_graph(tmp / "graph", g, pre)
        (tmp / "wrs").mkdir()
        values = wrs._setup(torch.device(device))[1]
        for k, v in (("prob", table.prob), ("alias", table.alias),
                     ("values", values)):
            np.save(tmp / "wrs" / f"{k}.npy", v.cpu().numpy())
        (tmp / "wrs" / "meta.json").write_text(json.dumps(
            {"mu": wrs._setup(torch.device(device))[2]}))

        t0 = time.time()
        pool = RankPool(POOL_RANKS, backend="gloo", device=device,
                        timeout=SUBSTRATE_TIMEOUT_S)
        spawn_s = time.time() - t0
        t0 = time.time()
        pool.call(pool_rank_setup, str(tmp / "graph"), str(tmp / "wrs"))
        setup_s = time.time() - t0
        t0 = time.time()
        for _ in range(50):   # a round trip to the ranks that samples nothing
            pool.call(rank_info)
        emit({"phase": "pool-ranks", "ranks": POOL_RANKS, "backend": "gloo",
              "processes": f"{POOL_RANKS} processes on one card, not a "
                           f"multi-GPU number",
              "spawn_wall_s": spawn_s, "setup_s": setup_s,
              "round_trip_ms": (time.time() - t0) / 50 * 1e3})

        def scheduler(**kw):
            return EpochScheduler(max_in_flight=POOL_IN_FLIGHT,
                                  substrate="shard_map",
                                  pool=DevicePool(POOL_SLOTS),
                                  pressure=PressurePolicy.parse("shrink-regrow"),
                                  checkpoint_every=1, device=device,
                                  ranks=pool, **kw)

        # 1. the drain: phase 9's queries and order, on the ranks
        stats = {}
        sched = scheduler(checkpoint_dir=tmp / "drain")
        for q in order:
            sched.submit(SessionSpec.parse(q), qid=qid[q])
        events, ticks = [], []
        with moves_timed(stats):
            sync()
            t0 = time.time()
            while not sched.idle:
                t1 = time.time()
                events.append(sched.tick())
                ticks.append((sched.in_flight + len(events[-1].retired),
                              time.time() - t1))
            wall = time.time() - t0
        differ = [q for q in POOL_QUERIES if not same(sched.results[qid[q]], q)]
        for q in order:
            r = sched.results[qid[q]]
            emit({"phase": "pool-ranks", "query": q, "tau": r.tau,
                  "epochs": r.epochs, "final_world": r.spec.world,
                  "final_placement": r.spec.placement,
                  "devices_leased": r.devices_leased, "wall_s": r.wall_s,
                  "vmap_solo_wall_s": solo[q][2],
                  "equals_vmap_solo": q not in differ})
        taus = sum(r.tau for r in sched.results.values())
        reshards = [(ev.tick, q, old, new) for ev in events
                    for q, old, new in ev.resharded]
        pull_bytes = stats.pop("bytes_by_shape")
        moves = {k: {op: {"n": n, "s": sec, "bytes": nb,
                          "s_each": sec / max(n, 1),
                          "bytes_each": nb / max(n, 1)}
                     for op, (n, sec, nb) in v.items()}
                 for k, v in stats.items()}
        emit({"phase": "pool-ranks", "order": order, "ticks": sched.tick_count,
              "drain_wall_s": wall, "checked_samples_per_s": taus / wall,
              "samples": taus, "tick_s": [t for _, t in ticks],
              "in_flight": [n for n, _ in ticks], "reshards": reshards,
              "moves": moves, "pull_bytes_by_shape": pull_bytes,
              "steppers_built": len(sched.cache)})
        if differ:
            raise AssertionError(f"pool-ranks: {differ} differ from their "
                                 f"solo VMAP sessions")
        if not any(new < old for _, _, old, new in reshards) or \
                not any(new > old for _, _, old, new in reshards):
            raise AssertionError(f"pool-ranks: no shrink and regrow: "
                                 f"{reshards}")
        shutil.rmtree(tmp / "drain")

        # 2. a drain stopped after 2 ticks, resumed from its checkpoints
        sched = scheduler(checkpoint_dir=tmp / "resume")
        for q in order:
            sched.submit(SessionSpec.parse(q), qid=qid[q])
        sched.tick()
        sched.tick()
        early = dict(sched.results)
        del sched
        sync()
        t0 = time.time()
        resumed = EpochScheduler.resume(
            tmp / "resume", max_in_flight=POOL_IN_FLIGHT,
            substrate="shard_map", pool=DevicePool(POOL_SLOTS),
            pressure=PressurePolicy.parse("shrink-regrow"),
            checkpoint_every=1, device=device, ranks=pool)
        pending = resumed.pending
        resumed.drain()
        results = {**early, **resumed.results}
        differ = [q for q in POOL_QUERIES if not same(results[qid[q]], q)]
        emit({"phase": "pool-ranks", "resume": "after 2 ticks",
              "retired_before": sorted(early), "resumed_pending": pending,
              "resumed_wall_s": time.time() - t0,
              "equals_vmap_solo": not differ})
        if differ:
            raise AssertionError(f"pool-ranks: resumed {differ} differ")

        # 3. two W = 2 sessions alone, then at once on disjoint ranks
        specs = [dataclasses.replace(SessionSpec.parse(q), substrate="shard_map",
                                     placement=ids)
                 for q, ids in zip(POOL_RANKS_PAIR, ((0, 1), (2, 3)))]
        vmap = StepperCache(device)
        alone = []
        for spec in specs:
            ref = AdaptiveSession.create(dataclasses.replace(
                spec, substrate="vmap", placement=None), cache=vmap)
            ref.start().run()
            session = AdaptiveSession.create(spec, cache=StepperCache(
                device, ranks=pool))
            sync()
            t0 = time.time()
            session.start().run()
            alone.append((time.time() - t0, session.result(), ref.result(),
                          ref.wall_s))
            session.close()
        sched = EpochScheduler(max_in_flight=2, pool=DevicePool(POOL_SLOTS),
                               device=device, ranks=pool)
        for i, spec in enumerate(specs):
            sched.submit(dataclasses.replace(spec, placement=None), qid=str(i))
        sync()
        t0 = time.time()
        sched.drain()
        both = time.time() - t0
        equal = []
        for i, (_, (est, res), (ref_est, ref_res), _) in enumerate(alone):
            r = sched.results[str(i)]
            equal.append(r.spec.placement == specs[i].placement
                         and (r.tau, r.stop_epoch) == (res.num, res.stop_epoch)
                         and np.array_equal(r.estimate, est)
                         and (res.num, res.stop_epoch) ==
                         (ref_res.num, ref_res.stop_epoch)
                         and np.array_equal(est, ref_est))
        emit({"phase": "pool-ranks", "concurrent": list(POOL_RANKS_PAIR),
              "placements": [s.placement for s in specs],
              "alone_wall_s": [a[0] for a in alone],
              "vmap_solo_wall_s": [a[3] for a in alone],
              "together_wall_s": both,
              "together_over_alone_sum": both / sum(a[0] for a in alone),
              "equal_to_alone_and_vmap": equal})
        if not all(equal):
            raise AssertionError(f"pool-ranks: concurrent sessions differ "
                                 f"from their solo runs: {equal}")

        # 4. compressed_psum of a 16 M-element f32 leaf over the 4 ranks
        ids = tuple(range(POOL_RANKS))
        pool.call(make_groups, ids, 0)
        outs = pool.call(compress_on_rank, ids, None, (COMPRESS_ELEMENTS,), 0,
                         COMPRESS_STEPS)
        worst = {k: max(max(o[k]) for o in outs)
                 for k in ("mean_err_over_scale", "ef_over_scale")}
        emit({"phase": "pool-ranks", "compressed_psum": COMPRESS_ELEMENTS,
              "steps": COMPRESS_STEPS, "scale": [float(v[0])
                                                 for v in outs[0]["scale"]],
              "step_s": outs[0]["step_s"], **worst,
              "mean_over_steps_err": max(o["mean_over_steps_err"]
                                         for o in outs),
              "collectives_rank0": outs[0]["calls"],
              "bound": "first step |mean − exact| ≤ scale, |ef| ≤ scale"})
        if worst["mean_err_over_scale"] > 1.0 or worst["ef_over_scale"] > 1.0:
            raise AssertionError(f"pool-ranks: compressed_psum out of its "
                                 f"bounds: {worst}")

        reports = pool.call(pool_rank_report)
        leaked = sorted({m for ms in pool.call(foreign_modules) for m in ms})
        rank_reports += reports
        if leaked:
            raise AssertionError(f"pool-ranks: the ranks imported {leaked}")
    finally:
        if pool is not None:
            pool.close()
        shutil.rmtree(tmp, ignore_errors=True)


def serve_model(torch, arch, path, expect_params, layers=None):
    """A model of the zoo at full width, random weights drawn on the card
    from seed 0 by the port's own initialiser, at the config's depth or cut
    to ``layers``; it must hold ``expect_params`` parameters."""
    import dataclasses

    from repro_torch.models import Model, resolve_config

    cfg = resolve_config(arch)
    full_depth = cfg.n_layers
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    torch.cuda.synchronize()
    t0 = time.time()
    model = Model(cfg, device="cuda").init(gen)
    torch.cuda.synchronize()
    params = list(model.parameters())
    count = sum(p.numel() for p in params)
    emit({"phase": path, "step": "weights", "arch": cfg.name,
          "family": cfg.family, "layers": cfg.n_layers,
          "depth_cut": None if layers is None else
          f"{full_depth} → {layers} layers, every width kept",
          "d_model": cfg.d_model, "vocab": cfg.vocab,
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


def prefill_vs_decode(torch, model, path, prompts):
    """Prefill's last logits against decoding the same prompt token by
    token, in the model's bf16 and in an f32 copy of the same weights,
    gated by ``SERVE_GATES``."""
    import math

    from repro_torch.launch.steps import make_prefill_step
    from repro_torch.models import Model

    Bg, P = prompts.shape
    m32 = Model(model.cfg, device="cuda").float()
    m32.load_state_dict(model.state_dict())
    for m, gate in ((model, SERVE_GATES["bf16"]), (m32, SERVE_GATES["f32"])):
        full = make_prefill_step(m)({"tokens": prompts}).float()
        dec = decode_prompt(torch, m, prompts).float()
        err = float((full - dec).abs().max())
        rel = err / float(full.abs().max())
        agree = float((full.argmax(-1) == dec.argmax(-1)).float().mean())
        emit({"phase": path, "step": "prefill vs decode", "arch": model.cfg.name,
              "dtype": str(m.dtype).split(".")[-1], "batch": Bg, "prompt": P,
              "max_abs_err": err, "max_abs_logit": float(full.abs().max()),
              "rel_err": rel, "gate_rel": gate, "argmax_agree": agree})
        if not (math.isfinite(rel) and rel <= gate):
            raise AssertionError(f"{path} prefill vs decode ({m.dtype}): "
                                 f"relative error {rel} > {gate}")
    del m32, full, dec
    torch.cuda.empty_cache()


def phase_serve(torch, model, path, prefill_shape, evaluate=True):
    """A model's serving path at full width: prefill at ``prefill_shape``,
    greedy generation at the CLI's defaults, prefill against decode in bf16
    and f32 (``SERVE_GATES``), adaptive evaluation (``SERVE_EVAL``) unless
    ``evaluate`` is False."""
    import math

    from repro_torch.data import TokenStream
    from repro_torch.launch.serve import adaptive_eval, generate
    from repro_torch.launch.steps import make_prefill_step

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
        emit({"phase": path, "step": "prefill", "arch": cfg.name,
              "batch": B, "seq": S,
              "window": cfg.local_window or cfg.window, "wall_s": walls,
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
        emit({"phase": path, "step": "generate", "arch": cfg.name, "batch": Bg,
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
        prefill_vs_decode(torch, model, path, prompts)
        if not evaluate:
            return

        # 4. adaptive evaluation of the mean per-token loss
        e = SERVE_EVAL
        stream = TokenStream(vocab=cfg.vocab, seq_len=e["seq"], batch=e["batch"],
                             seed=0)
        t0 = time.time()
        mean, res = adaptive_eval(model, stream, eps=e["eps"], delta=e["delta"])
        dt = time.time() - t0
        emit({"phase": path, "step": "adaptive eval", "arch": cfg.name, **e,
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


@contextlib.contextmanager
def moe_drops(torch):
    """Count, while the block runs, the (token, choice) pairs that each
    expert's capacity dropped, summed over the one-hot dispatch's routing
    calls (``moe._topk_slots``; on a mesh, each rank's own groups or a
    straddling group whole): yields a dict that gets ``chosen`` and
    ``dropped`` (E,) lists, the calls, and ``by_group`` {group size:
    [choices, dropped]}."""
    from repro_torch.models import moe

    slots = moe._topk_slots
    out = {"calls": 0, "by_group": {}}

    def counted(logits, k, capacity):
        res = slots(logits, k, capacity)
        topi = moe._route(logits, k)[2]
        E = logits.shape[-1]
        chosen = torch.bincount(topi.flatten(), minlength=E)
        dropped = chosen - res[0].sum((0, 1, 3)).long()
        for key, val in (("chosen", chosen), ("dropped", dropped)):
            out[key] = out[key] + val if key in out else val
        by = out["by_group"].setdefault(int(logits.shape[1]), [0, 0])
        by[0] += int(chosen.sum())
        by[1] += int(dropped.sum())
        out["calls"] += 1
        return res

    moe._topk_slots = counted
    try:
        yield out
    finally:
        moe._topk_slots = slots
        for key in ("chosen", "dropped"):
            if key in out:
                out[key] = out[key].tolist()


def family_prefill(torch, model, path, shape):
    """One prefill of ``data.family_batch``'s layout (patches for vlm,
    frames for encdec) at ``shape`` = (B, S), timed after a warm-up, with
    its peak memory; moe models report the tokens each expert dropped."""
    import math

    from repro_torch.data import family_batch
    from repro_torch.launch.steps import make_prefill_step

    cfg = model.cfg
    B, S = shape
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    batch = family_batch(cfg, B, S, gen)
    prefill = make_prefill_step(model)
    with torch.inference_mode():
        prefill(batch)                                   # warm-up
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        with moe_drops(torch) as drops:
            t0 = time.time()
            logits = prefill(batch)
            torch.cuda.synchronize()
            wall = time.time() - t0
    finite = bool(torch.isfinite(logits).all())
    line = {"phase": path, "step": "prefill", "arch": cfg.name,
            "family": cfg.family, "layers": cfg.n_layers, "batch": B, "seq": S,
            "inputs": {k: list(v.shape) for k, v in batch.items()},
            "window": cfg.window, "hd": cfg.hd, "wall_s": wall,
            "tokens_per_s": B * S / wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
            "logits_shape": list(logits.shape), "finite": finite}
    if cfg.family == "moe":
        chosen, dropped = drops["chosen"], drops["dropped"]
        line["moe"] = {"experts": cfg.n_experts, "top_k": cfg.top_k,
                       "capacity_factor": cfg.capacity_factor,
                       "group": cfg.moe_group, "routing_calls": drops["calls"],
                       "choices": sum(chosen), "dropped": sum(dropped),
                       "dropped_share": sum(dropped) / max(sum(chosen), 1),
                       "dropped_per_expert": dropped}
    emit(line)
    if not finite or tuple(logits.shape) != (B, cfg.padded_vocab) or \
            not math.isfinite(wall):
        raise AssertionError(f"{path} {cfg.name} prefill: logits "
                             f"{tuple(logits.shape)}, finite {finite}")


def phase_families(torch):
    """Phase 12: the dense, moe, vlm and encdec families.  h2o-danube-3-4b
    (dense, hd 120, window 4096) at full width and depth through every
    serving step; smollm-360m (hd 64, GQA groups of 3) through prefill,
    ``generate`` and prefill vs decode; then one prefill each of
    internlm2-20b (full size), mixtral-8x22b and qwen3-moe-235b-a22b (full
    width, 2 layers; also prefill vs decode, with a capacity no expert can
    overflow), internvl2-76b (full width, 2 layers, 256 patches) and
    seamless-m4t-large-v2 (full size, 1024 frames).  Each model is freed
    before the next."""
    import dataclasses

    from repro_torch.data import TokenStream

    path = "families"
    model = serve_model(torch, DANUBE_ARCH, path, DANUBE_PARAMS)
    phase_serve(torch, model, path, DANUBE_PREFILL)
    del model
    torch.cuda.empty_cache()
    model = serve_model(torch, SMOLLM_ARCH, path, SMOLLM_PARAMS)
    phase_serve(torch, model, path, SMOLLM_PREFILL, evaluate=False)
    del model
    torch.cuda.empty_cache()
    Bg, P, _ = SERVE_GEN
    for arch, layers, params, shape in FAMILY_PREFILLS:
        model = serve_model(torch, arch, path, params, layers=layers)
        family_prefill(torch, model, path, shape)
        if model.cfg.family == "moe":
            # a capacity no expert can overflow: decode routes B tokens a
            # group and prefill B·S, so a drop in prefill alone would make
            # the two paths different functions
            cfg = model.cfg
            model.cfg = dataclasses.replace(
                cfg, capacity_factor=cfg.n_experts / cfg.top_k)
            prompts = TokenStream(vocab=cfg.vocab, seq_len=P, batch=Bg,
                                  seed=0).batch_at(0, device="cuda")["tokens"]
            with torch.inference_mode():
                prefill_vs_decode(torch, model, path, prompts)
            model.cfg = cfg
        del model
        torch.cuda.empty_cache()


# phase 14: the model zoo on a mesh of 4 gloo ranks sharing the card
ZOO_MESH, ZOO_AXES = (2, 2), ("data", "model")
ZOO_PREFILL = (2, 4096)     # the prompts drawn: (B, S) of the largest case
ZOO_DECODE = 2              # decode steps from an empty cache of 4096 slots,
ZOO_DECODE_START = 2047     # at positions 2047 and 2048: across two model
                            # ranks' shares of the slots on either mesh
# danube's cases on the ranks: (name, mesh, prefill (B, S), warm-up
# prefill, blocks, GPipe (stages, (M, mb, S) micro-batches) of one block a
# stage), each at full width under the default flags, cut in depth for
# the time limit (every block is the same layer; phases 12 and 13 run all
# 24 in one process).  On (1, 4) a rank holds 8 q heads and 2 kv heads
ZOO_DANUBE = (
    ("default", (2, 2), (2, 4096), True, 4, (4, (4, 1, 2048))),
    ("model 4", (1, 4), (1, 2048), False, 2, (2, (2, 1, 1024))),
)
DANUBE_CUT_PARAMS = {4: 865_109_760, 2: 555_436_800}
ZOO_TIMEOUT_S = 900.0


# phase 14's other families on one RankPool of 4 gloo ranks sharing the
# card, after danube: (arch, config overrides (a depth cut, every width
# kept), prefill (B, S)), each under the full config's default flags
# (passed explicitly: a depth cut lowers param_count, which would flip
# them), the shards drawn from seed 0 in bf16, one prefill and
# ZOO_FAMILY_DECODE decode steps from ZOO_FAMILY_START of an empty cache of
# S slots (2048 slots, or recurrentgemma's 2048 ring slots: positions 1023
# and 1024 lie in both model ranks' halves); falcon-mamba and internvl2 at
# 4 and 2 layers before phase 15 trained every family (qwen3-moe stays at 2:
# cut to 1, its last-position logits moved 0.160 of their scale on the
# H100, past the bf16 gate: a near-tied routing choice flipped right
# before the unembedding)
ZOO_FAMILIES = (
    ("qwen3-moe-235b-a22b", {"n_layers": 2}, (2, 2048)),     # 4 groups of 512 a rank
    ("recurrentgemma-2b", {"n_layers": 5}, (2, 4096)),       # 1 unit + 2 tails
    ("falcon-mamba-7b", {"n_layers": 1}, (2, 4096)),
    ("internvl2-76b", {"n_layers": 1}, (2, 2048)),           # 256 patches + 1792 tokens
    ("seamless-m4t-large-v2", {"n_layers": 4, "enc_layers": 4}, (2, 2048)),  # 512 frames
)
ZOO_FAMILY_DECODE = 2
ZOO_FAMILY_START = 1023
# the families whose scan kernels phase 14's ranks hold against their
# plain versions once per (kernel, shape, type), not at every call: the
# scans' plain versions are launch-bound loops that led the phase's time
# (28.9 s of recurrentgemma's and 42.9 s of falcon-mamba's families on the
# card).  Phase 15 compares every call
ZOO_SCAN_ONCE = ("hybrid", "ssm")


def zoo_inputs():
    """The serving cases' prompts (2, 4096) and decode tokens (2,
    ZOO_DECODE); a case takes its leading (B, S) of them."""
    import numpy as np
    rng = np.random.default_rng(14)
    B, S = ZOO_PREFILL
    return (rng.integers(0, 32000, (B, S)), rng.integers(0, 32000, (B, ZOO_DECODE)))


def pipe_input(torch, micro, d, device):
    """A pipeline's M micro-batches of activations, ``micro`` (M, mb, S) +
    (d,) in bf16, the same from seed 14 on every process of the card."""
    gen = torch.Generator(device=device)
    gen.manual_seed(14)
    return (torch.randn(tuple(micro) + (d,), generator=gen, device=device)
            * 0.02).to(torch.bfloat16)


def danube_cut(blocks):
    import dataclasses

    from repro_torch.models import resolve_config
    return dataclasses.replace(resolve_config(DANUBE_ARCH), n_layers=blocks)


def zoo_mesh_rank(group, prompts, dec, out_dir):
    """One of phase 14's ranks: h2o-danube-3-4b in each case of
    ``ZOO_DANUBE``: on the case's mesh (``serve_rank``: shards drawn from
    seed 0, with a warm prefill if asked, the timed prefill, ``ZOO_DECODE``
    decode steps and the serving step), then the case's GPipe pipeline on
    the first ``stages`` ranks, one block of the same weights a stage;
    rank 0 writes each pipeline's output to ``out_dir``.  Every kernel call
    is held against its plain version (``probed``)."""
    import numpy as np
    import torch

    from repro_torch.core import distributed
    from repro_torch.launch.pipeline import DecoderLayer, pipeline_forward
    from repro_torch.launch.sharded import draw_params, serve_rank
    from repro_torch.models import Model

    out = {}
    with probed(group, every=True) as (report, check):
        for name, mesh, (B, S), warm, blocks, (stages, micro) in ZOO_DANUBE:
            out[name] = serve_rank(group, DANUBE_ARCH, mesh, ZOO_AXES, None,
                                   0, None, None, prompts[:B, :S],
                                   dec[:B, :ZOO_DECODE], ZOO_PREFILL[1], warm,
                                   ZOO_DECODE_START, {"n_layers": blocks})
            torch.cuda.empty_cache()
            # every rank makes the stages' group; the others sit it out
            pg = distributed.process_group(range(stages))
            if pg is None:
                continue
            cfg, sid = danube_cut(blocks), group.rank
            lo, hi = sid * blocks // stages, (sid + 1) * blocks // stages
            torch.cuda.reset_peak_memory_stats()
            model = draw_params(
                Model(cfg, device="meta"), 0, group.device,
                lambda n, full: full if n.startswith("layers.")
                and lo <= int(n.split(".")[1]) < hi else None)
            x = pipe_input(torch, micro, cfg.d_model, group.device)
            staged = distributed.host_staged
            torch.cuda.synchronize()
            t0 = time.time()
            y = pipeline_forward(DecoderLayer(cfg), model.layers, x, pg)
            torch.cuda.synchronize()
            out[name]["pipeline"] = {
                "wall_s": time.time() - t0, "layers": [lo, hi],
                "host_staged_messages": distributed.host_staged - staged,
                "weight_bytes": sum(p.numel() * p.element_size()
                                    for n, p in model.named_parameters()
                                    if p.device.type == "cuda"),
                "peak_mem_bytes": torch.cuda.max_memory_allocated()}
            if group.rank == 0:
                np.save(Path(out_dir) / f"pipeline-{name}.npy",
                        y.view(torch.int16).cpu().numpy())
            del model, x, y
            torch.cuda.empty_cache()
    return out, report


def phase_zoo_mesh(torch, pool, rank_reports):
    """Phase 14: the model zoo on a mesh (``launch/sharded.py``,
    ``launch/pipeline.py``).  h2o-danube-3-4b at full width in each case
    of ``ZOO_DANUBE``, cut in depth, in one process (seed 0): the case's
    prefill, ``ZOO_DECODE`` decode steps from ``ZOO_DECODE_START``, and its
    blocks over the pipeline's micro-batches in a loop; then on the ranks
    of ``pool`` (``zoo_mesh_rank``) the same prefill and decode steps
    sharded on the case's mesh, each logit within the bf16 gate of phases
    10–12 (``SERVE_GATES``) of the one-process run's, and the GPipe
    pipeline, bit-equal to the loop (``torch.equal``); then on the same
    ranks the other five families (``zoo_families``).  ``pool`` is the
    ``RankPool`` of 4 gloo ranks on the card that phases 14 and 15 share.
    The ranks' reports (launches, comparisons, calls by shape) go to
    ``rank_reports``."""
    from repro_torch.launch.pipeline import DecoderLayer

    path = "zoo-mesh"
    prompts, dec = zoo_inputs()
    single, single_wall, loops = {}, {}, {}
    for name, _, (B, S), warm, blocks, (_, micro) in ZOO_DANUBE:
        model = serve_model(torch, DANUBE_ARCH, path, DANUBE_CUT_PARAMS[blocks],
                            layers=blocks)
        with torch.inference_mode():
            toks = torch.as_tensor(prompts[:B, :S], device="cuda")
            if warm:
                model.prefill({"tokens": toks})
            torch.cuda.synchronize()
            t0 = time.time()
            logits = {"prefill": model.prefill({"tokens": toks}).float()}
            torch.cuda.synchronize()
            wall = {"prefill": time.time() - t0, "decode": []}
            cache = model.init_cache(B, ZOO_PREFILL[1])
            lgs = []
            for t in range(ZOO_DECODE):
                t0 = time.time()
                cache, lg = model.decode_step(cache, {
                    "tokens": torch.as_tensor(dec[:B, t], device="cuda"),
                    "pos": torch.full((B,), ZOO_DECODE_START + t,
                                      dtype=torch.int32, device="cuda")})
                lgs.append(lg.float())
                torch.cuda.synchronize()
                wall["decode"].append(time.time() - t0)
            logits["decode"] = torch.stack(lgs)
            single[name] = {k: v.cpu().numpy() for k, v in logits.items()}
            layer = DecoderLayer(model.cfg)
            x = pipe_input(torch, micro, model.cfg.d_model, "cuda")
            t0 = time.time()
            loop = []
            for m in range(x.shape[0]):
                y = x[m]
                for lp in model.layers:
                    y = layer(lp, y)
                loop.append(y)
            loop = torch.stack(loop)
            torch.cuda.synchronize()
            wall["pipeline_loop"] = time.time() - t0
            loops[name] = loop.cpu()
            single_wall[name] = wall
        del model, cache, lgs, lg, logits, x, y, loop
        torch.cuda.empty_cache()
    emit({"phase": path, "step": "one process", "arch": DANUBE_ARCH,
          "cases": {c[0]: {"prefill": list(c[2]), "blocks": c[4]}
                    for c in ZOO_DANUBE},
          "decode_steps": ZOO_DECODE, "decode_start": ZOO_DECODE_START,
          "wall_s": single_wall})

    failed = zoo_danube_ranks(torch, pool, prompts, dec, single, single_wall,
                              loops, rank_reports)
    failed += zoo_families(torch, pool, rank_reports)
    if failed:
        raise AssertionError("zoo-mesh: " + "; ".join(failed))


def zoo_danube_ranks(torch, pool, prompts, dec, single, single_wall, loops,
                     rank_reports) -> list:
    """Phase 14's danube cases on the pool's ranks (``zoo_mesh_rank``)
    against the one-process ``single`` logits and each pipeline against
    the ``loops`` (by case); emits their lines → the failed gates."""
    import math
    import tempfile

    import numpy as np

    path = "zoo-mesh"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_zoo_") as tmp:
        t0 = time.time()
        out = pool.call(zoo_mesh_rank, prompts, dec, tmp)
        ranks_s = time.time() - t0
        piped = {c[0]: torch.from_numpy(np.load(Path(tmp) / f"pipeline-{c[0]}.npy")
                                        ).view(torch.bfloat16)
                 for c in ZOO_DANUBE}
    rank_reports += [report for _, report in out]
    ranks = [r for r, _ in out]
    flash_by_rank = [rep["by_shape"].get("flash_attention", {})
                     for _, rep in out]
    failed = []
    for name, mesh, (B, S), warm, blocks, (stages, micro) in ZOO_DANUBE:
        r0 = ranks[0][name]
        exp = single[name]
        errs = {key: float(np.abs(r0[f"{key}_logits"] - exp[key]).max())
                / float(np.abs(exp[key]).max()) for key in exp}
        agree = float((r0["prefill_logits"].argmax(-1)
                       == exp["prefill"].argmax(-1)).mean())
        emit({"phase": path, "step": "sharded serving", "arch": DANUBE_ARCH,
              "case": name, "mesh": dict(zip(ZOO_AXES, mesh)),
              "flags": "default", "blocks": blocks,
              "depth_cut": f"{blocks} of 24 blocks (the time limit)",
              "processes": "4 gloo ranks on one card, not a multi-GPU number",
              "prefill": [B, S], "decode_steps": ZOO_DECODE,
              "decode_start": ZOO_DECODE_START, "cache_slots": ZOO_PREFILL[1],
              "warm_prefill": warm,
              "rel_err": errs, "gate_rel": SERVE_GATES["bf16"],
              "prefill_argmax_agree": agree,
              "prefill_wall_s": [r[name]["prefill"]["wall_s"] for r in ranks],
              "decode_wall_s": [r[name]["decode"]["wall_s"] for r in ranks],
              "one_process_wall_s": single_wall[name],
              "weight_bytes": [r[name]["weight_bytes"] for r in ranks],
              "peak_mem_bytes": [r[name].get("peak_mem_bytes") for r in ranks],
              "host_staged_messages": [r[name]["host_staged_messages"]
                                       for r in ranks],
              "collectives_prefill": [r[name]["prefill"]["collectives"]
                                      for r in ranks],
              "collectives_decode_step_0": [r[name]["decode"]["collectives"][0]
                                            for r in ranks],
              "local_logits": r0["prefill"]["local_logits"]})
        if not all(math.isfinite(e) and e <= SERVE_GATES["bf16"]
                   for e in errs.values()):
            failed.append(f"{name}: {errs}")
        loop = loops[name]
        equal = torch.equal(piped[name], loop)
        diff = float((piped[name].float() - loop.float()).abs().max())
        rel = diff / float(loop.float().abs().max())
        emit({"phase": path, "step": "pipeline", "arch": DANUBE_ARCH,
              "case": name, "stages": stages, "blocks": blocks,
              "micro_batches": list(micro), "equal": equal,
              "max_abs_diff": diff, "rel_diff": rel,
              "ranks": [r[name].get("pipeline") for r in ranks],
              "loop_wall_s": single_wall[name]["pipeline_loop"]})
        # bit-equal: every micro-batch meets the same kernels on the same
        # shapes in the same order as in the loop
        if not equal:
            failed.append(f"{name}: the pipeline differs from the loop by "
                          f"{diff} ({rel} of its scale)")
    emit({"phase": path, "step": "danube ranks", "danube_ranks_s": ranks_s,
          "flash_attention_calls_by_rank": flash_by_rank,
          "flash_attention_compared_by_rank": [rep["compared"]["flash_attention"]
                                               for _, rep in out],
          "flash_attention_max_abs_err_by_rank": [
              rep["max_err"]["flash_attention"] for _, rep in out],
          # the ranks' walls above include these comparisons
          "plain_compare_s_by_rank": [rep["compare_s"] for _, rep in out]})
    if any(not f for f in flash_by_rank):
        failed.append(f"a rank launched no flash_attention: {flash_by_rank}")
    return failed


def zoo_family_rank(group, arch, overrides, flags, batch, dec, capacity, start,
                    every):
    """One of phase 14's pool ranks: ``serve_rank`` of one family on the
    (2, 2) mesh, its kernel calls held against their plain versions
    (``probed``: every call, or with ``every`` False each new kernel,
    shape and type) and the one-hot dispatch's dropped tokens counted
    (``moe_drops``) → (serve_rank's result, the probe's report)."""
    import torch

    from repro_torch.launch.sharded import serve_rank

    with probed(group, every=every) as (report, _), moe_drops(torch) as drops:
        out = serve_rank(group, arch, ZOO_MESH, ZOO_AXES, flags, 0, None, None,
                         batch, dec, capacity, False, start, overrides)
    out["moe_routing"] = drops["by_group"]
    torch.cuda.empty_cache()
    return out, report


def zoo_families(torch, pool, rank_reports) -> list:
    """Phase 14's moe, hybrid, ssm, vlm and encdec families
    (``ZOO_FAMILIES``): each at full width, cut in depth, first in this
    process (seed 0, bf16: one prefill of ``data.family_batch``'s layout
    and the decode steps), then sharded on (data 2, model 2) on one
    ``RankPool`` of 4 gloo ranks sharing the card, the one danube's runs
    used (``zoo_family_rank``).  Each family's line: the relative error
    of the ranks' logits against this process's (gated at
    ``SERVE_GATES``' bf16 0.15), the argmax agreement, the walls, the
    weight bytes and peak memory a rank, the collectives by kind, and for
    moe the dropped share on the mesh and in one process.  → the failed
    gates."""
    import dataclasses
    import math

    import numpy as np

    from repro_torch.data import family_batch
    from repro_torch.launch.sharding import default_flags
    from repro_torch.models import Model, resolve_config

    path, failed = "zoo-mesh", []
    for arch, over, (B, S) in ZOO_FAMILIES:
        t_family = time.time()
        full = resolve_config(arch)
        flags = dataclasses.asdict(default_flags(full))
        cfg = dataclasses.replace(full, **over)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(0)
        model = Model(cfg, device="cuda").init(gen)
        gen.manual_seed(14)
        batch = family_batch(cfg, B, S, gen)
        dec = torch.randint(0, cfg.vocab, (B, ZOO_FAMILY_DECODE),
                            generator=gen, device="cuda")
        single, walls = {}, {"decode": []}
        with torch.inference_mode(), moe_drops(torch) as drops:
            torch.cuda.synchronize()
            t1 = time.time()
            single["prefill"] = model.prefill(batch).float()
            torch.cuda.synchronize()
            walls["prefill"] = time.time() - t1
            cache = model.init_cache(B, S)
            steps = []
            for t in range(ZOO_FAMILY_DECODE):
                t1 = time.time()
                cache, lg = model.decode_step(cache, {
                    "tokens": dec[:, t],
                    "pos": torch.full((B,), ZOO_FAMILY_START + t,
                                      dtype=torch.int32, device="cuda")})
                steps.append(lg.float())
                torch.cuda.synchronize()
                walls["decode"].append(time.time() - t1)
            single["decode"] = torch.stack(steps)
        single = {k: v.cpu().numpy() for k, v in single.items()}
        params = sum(p.numel() for p in model.parameters())
        del model, cache, steps, lg
        torch.cuda.empty_cache()
        host = {k: v.float().cpu().numpy() if v.is_floating_point()
                else v.cpu().numpy() for k, v in batch.items()}
        every = cfg.family not in ZOO_SCAN_ONCE
        out = pool.call(zoo_family_rank, arch, over, flags, host,
                        dec.cpu().numpy(), S, ZOO_FAMILY_START, every)
        rank_reports += [report for _, report in out]
        ranks = [r for r, _ in out]
        r0 = ranks[0]
        errs = {k: float(np.abs(r0[f"{k}_logits"] - single[k]).max())
                / float(np.abs(single[k]).max()) for k in single}
        line = {
            "phase": path, "step": "family on a mesh", "arch": cfg.name,
            "family": cfg.family, "overrides": over, "params": params,
            "flags": flags, "mesh": dict(zip(ZOO_AXES, ZOO_MESH)),
            "processes": "4 gloo ranks on one card, not a multi-GPU number",
            "inputs": {k: list(v.shape) for k, v in batch.items()},
            "decode_steps": ZOO_FAMILY_DECODE,
            "decode_start": ZOO_FAMILY_START, "warm_prefill": False,
            "every_call_compared": every,
            "rel_err": errs, "gate_rel": SERVE_GATES["bf16"],
            "argmax_agree": {k: float((r0[f"{k}_logits"].argmax(-1)
                                       == single[k].argmax(-1)).mean())
                             for k in single},
            "prefill_wall_s": [r["prefill"]["wall_s"] for r in ranks],
            "decode_wall_s": [r["decode"]["wall_s"] for r in ranks],
            "one_process_wall_s": walls,
            "weight_bytes": [r["weight_bytes"] for r in ranks],
            "peak_mem_bytes": [r.get("peak_mem_bytes") for r in ranks],
            "host_staged_messages": [r["host_staged_messages"] for r in ranks],
            "collectives_prefill": [r["prefill"]["collectives"] for r in ranks],
            "collectives_decode_step_0": [r["decode"]["collectives"][0]
                                          for r in ranks],
            "kernel_calls_by_rank": [
                {k: sum(v.values()) for k, v in rep["by_shape"].items()}
                for _, rep in out],
            "family_s": time.time() - t_family}
        if cfg.family == "moe":
            g = min(cfg.moe_group, B * S)
            mesh = [sum(r["moe_routing"].get(g, [0, 0])[i] for r in ranks)
                    for i in (0, 1)]
            one = drops["by_group"].get(g, [0, 0])
            line["moe"] = {
                "experts": cfg.n_experts, "experts_a_rank":
                cfg.n_experts // ZOO_MESH[1], "group": g,
                "prefill_dropped_share": {
                    "mesh": mesh[1] / max(mesh[0], 1),
                    "one_process": one[1] / max(one[0], 1)},
                "routing_by_group_rank0": r0["moe_routing"]}
        emit(line)
        if not all(math.isfinite(e) and e <= SERVE_GATES["bf16"]
                   for e in errs.values()):
            failed.append(f"{cfg.name}: {errs}")
    return failed


# phase 15: sharded training of every family on phase 14's RankPool.
# (arch, config overrides: a depth cut (every width kept) and remat "full",
# (n_micro, mb, S) with one row a data rank, steps), each under the full
# config's default flags (passed explicitly: a depth cut lowers
# param_count, which would flip them), the weights drawn from seed 0 in
# bf16.  Four ranks of a family at full depth would hold its weights,
# gradients, f32 accumulators and ZeRO-1 moments beside the one-process
# reference (~14 B a parameter: 41 GB for one mixtral layer)
TRAIN_MESH_CASES = (
    # two steps: the second's loss and grad norm see AdamW's sharded update
    (DANUBE_ARCH, {"n_layers": 2, "remat": "full"}, (2, 2, 2048), 2),
    ("mixtral-8x22b", {"n_layers": 1, "remat": "full"}, (1, 2, 2048), 1),
    ("falcon-mamba-7b", {"n_layers": 2, "remat": "full"}, (1, 2, 2048), 1),
    # one unit: 2 recurrent blocks and 1 local attention
    ("recurrentgemma-2b", {"n_layers": 3, "remat": "full"}, (1, 2, 2048), 1),
    # 256 patches + 1792 tokens
    ("internvl2-76b", {"n_layers": 1, "remat": "full"}, (1, 2, 2048), 1),
    # 2 + 2 layers, 512 frames
    ("seamless-m4t-large-v2", {"n_layers": 2, "enc_layers": 2,
                               "remat": "full"}, (1, 2, 2048), 1),
)
TRAIN_MESH_GATES = {"loss": 1e-2, "grad_norm": 5e-2, "mu": 0.15}  # relative
# the share of a rank's (group, token) rows whose own top-k choices differ
# from the one-process run's, which the ranks replay (``moe_topk_replay``):
# bf16 rounding flipped 80 of 8,192 (0.98 %) on every rank on the H100
TRAIN_MESH_TOPK_DIFFER = 0.03


def train_mesh_batches(cfg, layout, steps, gen):
    """The steps' batches in ``data.family_batch``'s layout (vlm's patches,
    encdec's frames) with labels, (n_micro, mb, …) each, drawn on the
    card from ``gen``."""
    from repro_torch.data import family_batch
    n, mb, S = layout
    out = []
    for _ in range(steps):
        b = family_batch(cfg, n * mb, S, gen, train=True)
        out.append({k: v.reshape((n, mb) + tuple(v.shape[1:]))
                    for k, v in b.items()})
    return out


def save_moments(torch, d: Path, mu) -> None:
    """The one-process ``mu`` as files, a leaf a file, rounded to bf16
    (its bit patterns as int16 ``.npy``): 2⁻⁹ of a leaf's scale at most,
    beside the 0.15 gate."""
    import numpy as np
    for k, v in mu.items():
        np.save(d / f"{k}.npy",
                v.to(torch.bfloat16).view(torch.int16).cpu().numpy())


def moment_errors(d, state) -> dict:
    """On a rank after its last step: for each leaf of ``state.mu``, (max
    |mesh − one process| on its shard, max |one process| on its shard),
    the one-process moments read from ``save_moments``' files in ``d``,
    each leaf memory-mapped and only the rank's shard copied to the
    card."""
    import numpy as np
    import torch

    from repro_torch.models.layers import local_chunk
    out = {}
    for k, m in state.mu.items():
        full = torch.from_numpy(np.load(Path(d) / f"{k}.npy", mmap_mode="c")
                                ).view(torch.bfloat16)
        ref = local_chunk(full, m.device_mesh, m.placements).to(m.device).float()
        out[k] = (float((m.to_local() - ref).abs().max()),
                  float(ref.abs().max()))
        del ref
    return out


@contextlib.contextmanager
def moe_topk_replay(torch, table: dict):
    """The moe routing's top-k choices (``moe._top_k``) recorded and
    replayed.  With ``table["topi"]`` None (this process), the first
    call's choices, (G, g, k) of every group, are recorded there; else
    (a rank) every call takes the recorded choices of its own groups
    (all of them, or the data rank's block of a split group dim) and their
    probabilities, and counts the (group, token) rows whose own choices
    differ.  For a model of one moe layer: every call of a step routes
    the same tokens (the forward, remat's recompute).  In bf16 the mesh's
    router logits differ from one process's by rounding, which flips
    near-tied choices; a flipped token's expert output, and with it its
    label's ``unembed`` column, differs wholly, beyond any per-leaf gate.
    Yields the counts {calls, rows, rows_differ}."""
    from repro_torch.models import moe
    top_k = moe._top_k
    out = {"calls": 0, "rows": 0, "rows_differ": 0}

    record = table.get("topi") is None

    def replayed(probs, k):
        vals, idx = top_k(probs, k)
        if record:
            if table.get("topi") is None:
                table["topi"] = idx.cpu().numpy()
            return vals, idx
        mine = torch.as_tensor(table["topi"], device=idx.device)
        G = idx.shape[0]
        if G != mine.shape[0]:       # this data rank's block of the groups
            d = torch.distributed.get_rank() // ZOO_MESH[1]
            mine = mine[d * G:(d + 1) * G]
        out["calls"] += 1
        out["rows"] += idx[..., 0].numel()
        out["rows_differ"] += int((mine != idx).any(-1).sum())
        return torch.gather(probs, -1, mine), mine

    moe._top_k = replayed
    try:
        yield out
    finally:
        moe._top_k = top_k


def train_mesh_rank(group, arch, overrides, flags, batches, mu_dir, topi=None):
    """One of phase 15's pool ranks: ``train_rank`` of ``arch`` cut to
    ``overrides`` on the (2, 2) mesh (shards drawn from seed 0, bf16), one
    step a batch; the moments after the last step held against the one-
    process ones (``moment_errors``); every kernel call held against its
    plain version (``probed``; remat's recompute of a forward call to
    the compared call's result), the one-hot dispatch's dropped tokens
    counted (``moe_drops``) and, with ``topi``, the one-process run's
    top-k choices replayed (``moe_topk_replay``) → (train_rank's result,
    the report)."""
    import torch

    from repro_torch.launch.sharded import train_rank

    replay = moe_topk_replay(torch, {"topi": topi}) if topi is not None \
        else contextlib.nullcontext()
    with probed(group, every=True, recompute=True) as (report, _), \
            moe_drops(torch) as drops, replay as replayed:
        out = train_rank(group, arch, ZOO_MESH, ZOO_AXES, batches, flags, 0,
                         None, None, overrides,
                         inspect=lambda params, state: moment_errors(mu_dir,
                                                                     state))
    out["moe_routing"] = drops["by_group"]
    out["topk_replayed"] = replayed
    gc.collect()
    torch.cuda.empty_cache()
    return out, report


def phase_train_mesh(torch, pool, rank_reports, check):
    """Phase 15: sharded training of every family (``launch/sharded.py``
    ``train_rank``, ``optim/adamw.py`` on DTensors), one ``TRAIN_MESH_CASES`` entry after the
    other (``train_mesh_case``); fails if any case failed its gates."""
    failed = []
    for case in TRAIN_MESH_CASES:
        failed += train_mesh_case(torch, pool, rank_reports, check, *case)
    if failed:
        raise AssertionError("train-mesh: " + "; ".join(failed))


def train_mesh_case(torch, pool, rank_reports, check, arch, overrides, layout,
                    steps) -> list:
    """One case of phase 15: ``arch`` at full width cut to ``overrides``
    (bf16, seed 0): ``steps`` steps of ``make_train_step`` on ``layout``
    in this process (its kernel calls not compared: ``check.paused``),
    its moments after the last step written to files (``save_moments``),
    the model freed, then the same steps on the (data 2, model 2) mesh of
    phase 14's 4 gloo ranks under the full config's default policy, every
    kernel call on the ranks, forward and backward, held against its plain
    version (``train_mesh_rank``). Gates (``TRAIN_MESH_GATES``): each
    step's loss and grad norm relative to this process's, and each leaf's
    ``mu`` after the last step within 0.15 of its largest magnitude; for
    moe, each rank's share of
    rows whose own top-k choices differ within
    ``TRAIN_MESH_TOPK_DIFFER``.  One line a case → the failed gates."""
    import dataclasses
    import math
    import tempfile

    from repro_torch.launch.sharding import default_flags
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model, resolve_config
    from repro_torch.optim import adamw_init

    path, t_case = "train-mesh", time.time()
    full = resolve_config(arch)
    cfg = dataclasses.replace(full, **overrides)
    flags = dataclasses.asdict(default_flags(full))
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(0)
    model = Model(cfg, device="cuda").init(gen).requires_grad_(True)
    n_params = sum(p.numel() for p in model.parameters())
    gen.manual_seed(15)
    batches = train_mesh_batches(cfg, layout, steps, gen)
    step = make_train_step(model)
    opt = adamw_init(dict(model.named_parameters()))
    single, single_wall, table = [], [], {"topi": None}
    record = moe_topk_replay(torch, table) if cfg.family == "moe" \
        else contextlib.nullcontext()
    if cfg.family == "moe" and cfg.n_layers != 1:
        raise ValueError(f"{cfg.name}: the top-k replay takes one moe layer")
    with moe_drops(torch) as drops, record, check.paused():
        for b in batches:
            torch.cuda.synchronize()
            t0 = time.time()
            opt, m = step(opt, b)
            torch.cuda.synchronize()
            single_wall.append(time.time() - t0)
            single.append((float(m["loss"]), float(m["grad_norm"])))
    single_peak = torch.cuda.max_memory_allocated()
    host = [{k: (v.float() if v.is_floating_point() else v).cpu().numpy()
             for k, v in b.items()} for b in batches]
    inputs = {k: list(v.shape) for k, v in batches[0].items()}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_train_mesh_") as tmp:
        mu_dir = Path(tmp) / "mu"
        mu_dir.mkdir()
        t0 = time.time()
        save_moments(torch, mu_dir, opt.mu)
        mu_save_s = time.time() - t0
        del model, step, opt, m, batches, b
        gc.collect()
        torch.cuda.empty_cache()
        parent_reserved = torch.cuda.memory_reserved()
        t0 = time.time()
        out = pool.call(train_mesh_rank, arch, overrides, flags, host,
                        str(mu_dir), table["topi"])
        ranks_s = time.time() - t0
    rank_reports += [report for _, report in out]
    ranks = [r for r, _ in out]
    r0 = ranks[0]
    rel = {"loss": [abs(s["loss"] - e[0]) / abs(e[0])
                    for s, e in zip(r0["steps"], single)],
           "grad_norm": [abs(s["grad_norm"] - e[1]) / abs(e[1])
                         for s, e in zip(r0["steps"], single)]}
    mu_err = {k: max(r["inspected"][k][0] for r in ranks)
              / max(max(r["inspected"][k][1] for r in ranks), 1e-30)
              for k in r0["inspected"]}
    worst = max(mu_err, key=mu_err.get)
    line = {
        "phase": path, "step": "sharded train", "arch": cfg.name,
        "family": cfg.family, "overrides": overrides, "params": n_params,
        "flags": flags, "mesh": dict(zip(ZOO_AXES, ZOO_MESH)),
        "layout": list(layout), "inputs": inputs, "steps": steps,
        "tokens_a_step": math.prod(layout),
        "processes": "4 gloo ranks on one card, not a multi-GPU number",
        "every_call_compared": True,
        "held_to_earlier_call_by_rank": [rep["held_to_earlier_call"]
                                         for _, rep in out],
        "loss": [s["loss"] for s in r0["steps"]],
        "grad_norm": [s["grad_norm"] for s in r0["steps"]],
        "one_process": {"loss": [e[0] for e in single],
                        "grad_norm": [e[1] for e in single],
                        "wall_s": single_wall, "peak_mem_bytes": single_peak},
        "rel_err": rel, "mu_rel_err_worst": mu_err[worst],
        "mu_worst_leaf": worst, "gates": TRAIN_MESH_GATES,
        "step_wall_s": [[s["wall_s"] for s in r["steps"]] for r in ranks],
        "weight_bytes": [r["weight_bytes"] for r in ranks],
        "grad_bytes": [r["grad_bytes"] for r in ranks],
        "opt_state_bytes": [r["opt_state_bytes"] for r in ranks],
        "peak_mem_bytes": [r.get("peak_mem_bytes") for r in ranks],
        "host_staged_messages": [r["host_staged_messages"] for r in ranks],
        "collectives_last_step": [r["steps"][-1]["collectives"] for r in ranks],
        "kernel_calls_by_rank": [
            {k: sum(v.values()) for k, v in rep["by_shape"].items()}
            for _, rep in out],
        "plain_compare_s_by_rank": [rep["compare_s"] for _, rep in out],
        "rank_build_s": [r["build_s"] for r in ranks],
        "mu_save_s": mu_save_s, "ranks_s": ranks_s,
        "this_process_reserved_bytes_beside_ranks": parent_reserved,
        "case_s": time.time() - t_case}
    if cfg.family == "moe":
        g = min(cfg.moe_group, layout[1] * layout[2])
        mesh = [sum(r["moe_routing"].get(g, [0, 0])[i] for r in ranks)
                for i in (0, 1)]
        one = drops["by_group"].get(g, [0, 0])
        line["moe"] = {"experts": cfg.n_experts, "group": g,
                       "dropped_share": {"mesh": mesh[1] / max(mesh[0], 1),
                                         "one_process": one[1] / max(one[0], 1)},
                       "routing_by_group_rank0": r0["moe_routing"],
                       "topk_replayed": "the one-process run's choices",
                       "own_choices_differ": [r["topk_replayed"]
                                              for r in ranks],
                       "own_choices_differ_gate": TRAIN_MESH_TOPK_DIFFER}
    emit(line)
    failed = [f"{cfg.name} {k} {v}" for k, v in rel.items()
              if not all(math.isfinite(e) and e <= TRAIN_MESH_GATES[k]
                         for e in v)]
    if not (mu_err[worst] <= TRAIN_MESH_GATES["mu"]):
        failed.append(f"{cfg.name} mu {worst} {mu_err[worst]}")
    if cfg.family == "moe":
        shares = [r["topk_replayed"]["rows_differ"]
                  / max(r["topk_replayed"]["rows"], 1) for r in ranks]
        if not all(r["topk_replayed"]["calls"] > 0 for r in ranks) or \
                max(shares) > TRAIN_MESH_TOPK_DIFFER:
            failed.append(f"{cfg.name}: the ranks' own top-k choices differ "
                          f"from one process's in {shares} of their rows "
                          f"(gate {TRAIN_MESH_TOPK_DIFFER})")
    return failed


GEMM_PARTS = ("gemm", "nvjet", "xmma", "cutlass")


def step_breakdown(torch, fn) -> dict:
    """One call of ``fn`` (a train step) under ``torch.profiler``: device ms
    of the attention forward and backward kernels, the GEMMs (cuBLAS's
    kernels by name), the other kernels, and the wall; plus the step's
    AdamW update, timed by CUDA events around ``launch.steps``'
    ``adamw_update``."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.launch import steps

    upd, opt_ms = steps.adamw_update, []

    def timed(*args, **kwargs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        out = upd(*args, **kwargs)
        b.record()
        opt_ms.append((a, b))
        return out

    steps.adamw_update = timed
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.time()
            fn()
            torch.cuda.synchronize()
            wall = time.time() - t0
    finally:
        steps.adamw_update = upd
    groups = {"flash_attention_fwd": KERNEL_NAMES["flash_attention"],
              "flash_attention_bwd": KERNEL_NAMES["flash_attention_bwd"],
              "rglru_scan_fwd": KERNEL_NAMES["rglru_scan"],
              "ssm_scan_fwd": KERNEL_NAMES["ssm_scan"],
              "scan_bwd": KERNEL_NAMES["scan_bwd"],
              "gemm": GEMM_PARTS}
    ms = dict.fromkeys(groups, 0.0)
    ms["other"] = 0.0
    by_name = {}
    for name, t in device_events(torch, prof):
        by_name[name] = by_name.get(name, 0.0) + t
        key = next((g for g, parts in groups.items()
                    if any(p in name for p in parts)), "other")
        ms[key] += t
    device = sum(ms.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"profiled_wall_s": wall, "device_ms": device,
            "device_busy_share": device / 1e3 / wall,
            "device_ms_by_group": {k: v for k, v in ms.items() if v},
            "adamw_update_ms": sum(a.elapsed_time(b) for a, b in opt_ms),
            "top_device": [{"name": n[:80], "ms": t} for n, t in top]}


def train_grads_vs_cpu(torch, arch):
    """``train_loss``'s gradients on the card (the kernels both ways) against
    the CPU's (the plain versions) in f32, from the same weights (seed 0)
    and batch: each leaf within ``TRAIN_GRAD_TOL`` of its largest
    magnitude (1e-6 at the least)."""
    from repro_torch.data import family_batch
    from repro_torch.launch.steps import loss_and_grads
    from repro_torch.models import Model, resolve_config

    cfg = resolve_config(arch)
    gen = torch.Generator().manual_seed(0)
    cpu = Model(cfg, device="cpu").init(gen).float().requires_grad_(True)
    card = Model(cfg, device="cuda").float()
    card.load_state_dict({k: v.cuda() for k, v in cpu.state_dict().items()},
                         assign=True)
    card.requires_grad_(True)
    batch = family_batch(cfg, *TRAIN_GRAD_BATCH, gen, train=True)
    t0 = time.time()
    loss_c, g_card = loss_and_grads(card, dict(card.named_parameters()),
                                    {k: v.cuda() for k, v in batch.items()})
    torch.cuda.synchronize()
    wall = time.time() - t0
    loss, g_cpu = loss_and_grads(cpu, dict(cpu.named_parameters()), batch)
    errs = {k: float((g_card[k].cpu() - g).abs().max())
            / max(float(g.abs().max()), 1e-6) for k, g in g_cpu.items()}
    worst = max(errs, key=errs.get)
    loss_rel = abs(float(loss_c) - float(loss)) / abs(float(loss))
    emit({"phase": "train", "step": "gradients vs cpu", "arch": arch,
          "family": cfg.family, "dtype": "float32",
          "batch": list(TRAIN_GRAD_BATCH), "leaves": len(errs),
          "loss": float(loss_c), "loss_rel_err": loss_rel,
          "worst_leaf": worst, "worst_rel_err": errs[worst],
          "tolerance": TRAIN_GRAD_TOL, "card_wall_s": wall})
    if errs[worst] > TRAIN_GRAD_TOL or loss_rel > 1e-5:
        raise AssertionError(f"train {arch}: gradients on the card differ from "
                             f"the CPU's: {worst} {errs[worst]}, loss {loss_rel}")


def train_steps(torch, model, name, layout, steps):
    """``steps`` steps of ``make_train_step`` with AdamW on
    ``TokenStream`` batches: ``layout`` (n_micro, mb, S) through
    ``micro_batches``, or (B, S) through ``batch_at``.  Each step timed to
    a synchronise, its loss and grad norm finite, its peak memory."""
    import math

    from repro_torch.data import TokenStream
    from repro_torch.launch.steps import make_train_step
    from repro_torch.optim import AdamWConfig, adamw_init

    cfg = model.cfg
    step = make_train_step(model, AdamWConfig())
    opt = adamw_init(dict(model.named_parameters()))
    rows = layout[0] * layout[1] if len(layout) == 3 else layout[0]
    stream = TokenStream(vocab=cfg.vocab, seq_len=layout[-1], batch=rows, seed=0)

    def batch_at(i):
        return stream.micro_batches(i, layout[0], device="cuda") \
            if len(layout) == 3 else stream.batch_at(i, device="cuda")

    out = []
    for i in range(steps):
        batch = batch_at(i)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.time()
        opt, m = step(opt, batch)
        loss, gnorm = float(m["loss"]), float(m["grad_norm"])
        torch.cuda.synchronize()
        wall = time.time() - t0
        line = {"phase": "train", "step": name, "arch": cfg.name,
                "layers": cfg.n_layers, "remat": cfg.remat,
                "layout": list(layout), "tokens": rows * layout[-1],
                "train_step": int(m["step"]), "loss": loss, "grad_norm": gnorm,
                "wall_s": wall, "tokens_per_s": rows * layout[-1] / wall,
                "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        emit(line)
        out.append(line)
        if not (math.isfinite(loss) and math.isfinite(gnorm)):
            raise AssertionError(f"train {cfg.name}: loss {loss}, grad norm {gnorm}")
    return step, opt, batch_at


def train_cli(torch):
    """``launch/train.py``'s ``main`` on the card: ``CLI_STEPS`` steps of
    smollm-360m (B 8, S 512, 2 micro-batches) with a checkpoint every
    ``CLI_CKPT_EVERY`` (past the run's end: only the final one); the same
    preempted (and checkpointed) at ``CLI_PREEMPT`` and resumed,
    whose losses from there on and final checkpoint (parameters, moments,
    step: the chunks' CRCs) must equal the uninterrupted run's.  Its
    ``--adaptive`` run left for phase 16, where ``train_adaptive_torch``
    drives ``--adaptive`` on lm-100m."""
    import io
    import re
    import shutil
    import tempfile

    from repro_torch.launch.train import main as train_main

    def run(*extra):
        buf = io.StringIO()
        t0 = time.time()
        with contextlib.redirect_stdout(buf):
            rc = train_main([*CLI_ARGS, "--steps", str(CLI_STEPS), *extra])
        torch.cuda.synchronize()
        out = buf.getvalue()
        if rc != 0:
            raise AssertionError(f"train CLI {extra}: exit {rc}\n{out}")
        losses = {int(m.group(1)): m.group(2) for m in re.finditer(
            r"\[train\] step +(\d+) loss=(\S+)", out)}
        return out, losses, time.time() - t0

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    try:
        full, l_full, w_full = run("--ckpt-dir", str(tmp / "a"),
                                   "--ckpt-every", str(CLI_CKPT_EVERY))
        pre, _, w_pre = run("--ckpt-dir", str(tmp / "b"),
                            "--ckpt-every", str(CLI_CKPT_EVERY),
                            "--preempt-at", str(CLI_PREEMPT))
        res, l_res, w_res = run("--ckpt-dir", str(tmp / "b"), "--resume",
                                "--ckpt-every", str(CLI_CKPT_EVERY))

        def crcs(run_dir):  # the final checkpoint's chunk checksums
            man = json.loads((tmp / run_dir / f"step_{CLI_STEPS:010d}" /
                              "manifest.json").read_text())
            return {k: [c["crc32"] for c in v["chunks"]]
                    for k, v in man["leaves"].items()}
        same_ckpt = crcs("a") == crcs("b")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    same = {s: l_full.get(s) == l for s, l in l_res.items()}
    emit({"phase": "train", "step": "cli", "args": list(CLI_ARGS),
          "steps": CLI_STEPS, "ckpt_every": CLI_CKPT_EVERY,
          "cut": "20 steps, a checkpoint every 10, preempted at 5 → "
                 "4, none but the final one, 2 (the time limit); the "
                 "--adaptive run → phase 16's train_adaptive_torch",
          "preempt_at": CLI_PREEMPT, "wall_s": {"full": w_full, "preempted": w_pre,
                                                 "resumed": w_res},
          "losses_full": l_full, "losses_resumed": l_res,
          "resumed_equal": all(same.values()) and len(same) == CLI_STEPS - CLI_PREEMPT,
          "final_checkpoints_equal": same_ckpt,
          "last_lines": [full.splitlines()[-1], res.splitlines()[-1]]})
    if "PREEMPTION" not in pre or f"resumed at step {CLI_PREEMPT}" not in res \
            or sorted(l_res) != list(range(CLI_PREEMPT, CLI_STEPS)) \
            or not all(same.values()) or not same_ckpt:
        raise AssertionError(f"train CLI: resume after preemption is not the "
                             f"uninterrupted run: {l_full} vs {l_res}")


def phase_train(torch):
    """Phase 13: training on the card.  The gradients of ``train_loss`` on
    the card against the CPU's (``TRAIN_GRAD_ARCHS``, f32); then, in bf16
    from seed 0, each model freed before the next: h2o-danube-3-4b at full
    size, ``DANUBE_TRAIN_STEPS`` steps of ``make_train_step`` (AdamW,
    remat "full") on ``micro_batches`` (2 × (1, 4096)) and a profile of one
    more; recurrentgemma-2b at full size, ``OTHER_TRAIN_STEPS`` steps at
    (1, 4096); falcon-mamba-7b at full width, 4 of its 64 layers,
    ``OTHER_TRAIN_STEPS`` steps at (1, 2048) (the first step of each cold,
    the rest warm); then the training CLI (``train_cli``)."""
    path = "train"
    for arch in TRAIN_GRAD_ARCHS:
        train_grads_vs_cpu(torch, arch)
        torch.cuda.empty_cache()

    model = serve_model(torch, DANUBE_ARCH, path, DANUBE_PARAMS)
    model.requires_grad_(True)
    layout = DANUBE_TRAIN
    step, opt, batch_at = train_steps(torch, model, "h2o-danube-3-4b step",
                                      layout, DANUBE_TRAIN_STEPS)
    import math
    batch = batch_at(DANUBE_TRAIN_STEPS)
    emit({"phase": "train", "step": "h2o-danube-3-4b profile",
          "layout": list(layout), "tokens": math.prod(layout),
          "profile": step_breakdown(torch, lambda: step(opt, batch))})
    del model, step, opt, batch, batch_at
    torch.cuda.empty_cache()

    model = serve_model(torch, RG_ARCH, path, RG_PARAMS)
    model.requires_grad_(True)
    train_steps(torch, model, "recurrentgemma-2b step", RG_TRAIN, OTHER_TRAIN_STEPS)
    del model
    torch.cuda.empty_cache()

    model = serve_model(torch, MAMBA_ARCH, path, MAMBA_TRAIN_PARAMS,
                        layers=MAMBA_TRAIN_LAYERS)
    model.requires_grad_(True)
    train_steps(torch, model, "falcon-mamba-7b step", MAMBA_TRAIN, OTHER_TRAIN_STEPS)
    del model
    torch.cuda.empty_cache()

    train_cli(torch)


# phase 16: the examples' analogues (examples/*_torch.py), each one's
# main() called in this process on the card: (example, arguments), the
# reference docstrings' commands but instances_demo's --conformance,
# which phase 7's run_all already runs
EXAMPLES = ROOT / "examples"
EXAMPLE_RUNS = (
    ("quickstart_torch", ()),
    ("kadabra_bc_torch", ("--kind", "er", "--n", "300", "--eps", "0.05")),
    ("kadabra_bc_torch", ("--kind", "grid", "--world", "8")),
    ("instances_demo_torch", ()),
    ("instances_demo_torch", ("--strategy", "indexed", "--world", "4")),
    ("serve_adaptive_torch", ()),
    # lm-100m at full width and the reference's full run's sequence
    # length; 60 steps: the periodic checkpoint at step 50 and the final
    # one (into a directory the phase removes)
    ("train_adaptive_torch", ("--seq", "128", "--steps", "60")),
)
EXAMPLE_EPS = 0.05          # kadabra_bc's default ε
SCRIPT_INSTANCES = ("kadabra-full", "wrs-full")   # phase 9 registers them
EXAMPLE_TRAIN = (8, 4)      # train_adaptive's --batch and --micro defaults


def example_quickstart(out, argv):
    """quickstart_torch's τ, ω, max error and its OK line → (figures,
    failures)."""
    tau = re.search(r"stopped after τ = (\d+) samples \(ω cap was (\d+)\)", out)
    err = re.search(r"max \|b̃ − b\| = (\S+)  \(ε = (\S+)\) (OK|MISS)$", out, re.M)
    if not (tau and err):
        return {}, ["no τ or max error line"]
    return ({"tau": int(tau[1]), "omega": int(tau[2]), "max_err": float(err[1]),
             "eps": float(err[2])}, [] if err[3] == "OK" else [err[0]])


def example_kadabra_bc(out, argv):
    """kadabra_bc_torch's preprocessing and its five strategies' rows,
    each max error within ε."""
    eps = float(argv[argv.index("--eps") + 1]) if "--eps" in argv else EXAMPLE_EPS
    pre = re.search(r"VD ≤ (\d+), ω = (\d+) \((\S+)s\)", out)
    rows = [{"strategy": s, "world": int(w), "tau": int(t), "epochs": int(e),
             "max_err": float(x), "s": float(d)}
            for s, w, t, e, x, d in re.findall(
                r"^ *(lock|barrier|local|shared|indexed) +(\d+) +(\d+) +(\d+) "
                r"+(\S+) +(\S+)s$", out, re.M)]
    bad = [] if pre and len(rows) == 5 else [f"{len(rows)} of 5 strategy rows"]
    bad += [f"{r['strategy']}: max error {r['max_err']} > ε {eps}"
            for r in rows if not r["max_err"] <= eps]
    return ({"vd_upper": int(pre[1]), "omega": int(pre[2]),
             "preprocess_s": float(pre[3])} if pre else {}) | \
        {"eps": eps, "rows": rows}, bad


def example_instances_demo(out, argv):
    """instances_demo_torch's six instances, each error within its ε."""
    rows = [{"instance": n, "tau": int(t), "epochs": int(e), "err": float(x),
             "eps": float(p), "s": float(w)}
            for n, t, e, x, p, w in re.findall(
                r"^([\w-]+) +\[\w+/W=\d+\] τ= *(\d+) epochs= *(\d+) err=(\S+) "
                r"\(ε=(\S+)\) wall=(\S+)s$", out, re.M)]
    bad = [] if len(rows) == 6 else [f"{len(rows)} of 6 instance rows"]
    bad += [f"{r['instance']}: err {r['err']} > ε {r['eps']}"
            for r in rows if not r["err"] <= r["eps"]]
    return {"rows": rows}, bad


def example_serve_adaptive(out, argv):
    """serve_adaptive_torch's four flows: both pools drain 2 queries and
    the second shrinks a session under pressure, generation makes 64
    tokens, the adaptive eval's mean is finite."""
    import math
    drained = re.findall(r"\[serve\] pool drained: (\d+) queries, (\d+) ticks, "
                         r"(\d+) samples in (\S+)s \((\d+) samples/s", out)
    second = out.split("[example] placement-aware pool")[-1]
    gen = re.search(r"\[serve\] generated (\d+) tokens in (\S+)s \((\S+) tok/s\)", out)
    ev = re.search(r"\[serve\] adaptive eval: mean loss = (\S+) ± \S+ \(p ≥ \S+\) "
                   r"after (\d+) samples \(stopped=(\w+), (\S+)s\)", out)
    bad = [] if [d[0] for d in drained] == ["2", "2"] else [f"pools drained {drained}"]
    if not re.search(r"\[serve\] tick \d+: shrunk \S+ W=\d+ → \d+ \(pressure\)", second):
        bad.append("no shrunk line in the placement-aware pool")
    if not (gen and gen[1] == "64"):
        bad.append("no generated 64 tokens line")
    if not (ev and math.isfinite(float(ev[1]))):
        bad.append("no finite adaptive eval line")
    return {"pools": [{"queries": int(q), "ticks": int(t), "samples": int(n),
                       "s": float(s), "samples_per_s": int(r)}
                      for q, t, n, s, r in drained],
            "generate": gen and {"tokens": int(gen[1]), "s": float(gen[2]),
                                 "tokens_per_s": float(gen[3])},
            "adaptive_eval": ev and {"mean_loss": float(ev[1]),
                                     "samples": int(ev[2]),
                                     "stopped": ev[3] == "True",
                                     "s": float(ev[4])}}, bad


def example_train_adaptive(out, argv):
    """train_adaptive_torch's logged steps (every 10th and the last): finite
    losses, at most ``EXAMPLE_TRAIN[1]`` micro-batches; tokens/s of each
    logged step from its micro-batches and wall."""
    import math
    steps = int(argv[argv.index("--steps") + 1])
    seq = int(argv[argv.index("--seq") + 1])
    batch, micro = EXAMPLE_TRAIN
    rows = [{"step": int(s), "loss": float(l), "grad_norm": float(g),
             "ms": int(ms), "micro": int(m), "rel_sem": float(r),
             "tokens_per_s": int(m) * batch // micro * seq / (int(ms) / 1e3)}
            for s, l, g, ms, m, r in re.findall(
                r"\[train\] step +(\d+) loss=(\S+) gnorm=(\S+) +(\d+)ms "
                r"micro=(\d+) rel_sem=(\S+)$", out, re.M)]
    done = re.search(r"\[train\] done in (\S+)s; loss (\S+) → (\S+)", out)
    logged = sorted(set(range(0, steps, 10)) | {steps - 1})
    bad = [] if [r["step"] for r in rows] == logged and done else \
        [f"logged steps {[r['step'] for r in rows]}, not {logged}"]
    bad += [f"step {r['step']}: loss {r['loss']}, micro={r['micro']}"
            for r in rows if not (math.isfinite(r["loss"])
                                  and 1 <= r["micro"] <= micro)]
    params = re.search(r"lm-100m: (\S+)M params", out)
    return {"params_m": params and float(params[1]), "rows": rows,
            "done_s": done and float(done[1])}, bad


EXAMPLE_CHECKS = {"quickstart_torch": example_quickstart,
                  "kadabra_bc_torch": example_kadabra_bc,
                  "instances_demo_torch": example_instances_demo,
                  "serve_adaptive_torch": example_serve_adaptive,
                  "train_adaptive_torch": example_train_adaptive}


@contextlib.contextmanager
def checkpoint_seconds():
    """Seconds that ``CheckpointManager.save`` (its copy to the host; the
    write goes on in a thread) and ``wait`` (until the writes end) block
    their caller, summed while the block runs: {"save_s", "wait_s",
    "saves"}."""
    from repro_torch.checkpoint import CheckpointManager
    out = {"save_s": 0.0, "wait_s": 0.0, "saves": 0}
    save, wait = CheckpointManager.save, CheckpointManager.wait

    def timed(fn, key):
        def call(*args, **kwargs):
            t0 = time.time()
            try:
                return fn(*args, **kwargs)
            finally:
                out[key] += time.time() - t0
                out["saves"] += key == "save_s"
        return call

    CheckpointManager.save = timed(save, "save_s")
    CheckpointManager.wait = timed(wait, "wait_s")
    try:
        yield out
    finally:
        CheckpointManager.save, CheckpointManager.wait = save, wait


def phase_examples(torch):
    """Phase 16: the examples' analogues on the card.  Each of
    ``EXAMPLE_RUNS`` is loaded from ``examples/`` and its ``main(argv)``
    called in this process with its output captured, phase 9's instances
    (``SCRIPT_INSTANCES``) out of the registry meanwhile; a non-zero exit
    code or a missing or failed line (``EXAMPLE_CHECKS``) fails the phase.
    train_adaptive_torch checkpoints into a temporary directory, which
    must then hold steps 50 and 60, and which the phase removes.  One line
    a run: its wall and the figures it printed; for train_adaptive_torch
    also each checkpoint's bytes and the seconds its saves blocked the
    run (``checkpoint_seconds``)."""
    import importlib.util
    import io
    import shutil
    import tempfile

    from repro_torch.core import instances

    failed = []
    # the registry as a user's process has it: without phase 9's instances
    own = {n: instances._REGISTRY.pop(n) for n in SCRIPT_INSTANCES
           if n in instances._REGISTRY}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_examples_"))
    try:
        for name, argv in EXAMPLE_RUNS:
            argv = list(argv)
            ckpt = tmp / name
            if name == "train_adaptive_torch":
                argv += ["--ckpt-dir", str(ckpt)]
            spec = importlib.util.spec_from_file_location(
                name, EXAMPLES / f"{name}.py")
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            buf = io.StringIO()
            t0 = time.time()
            with contextlib.redirect_stdout(buf), checkpoint_seconds() as saves:
                rc = mod.main(argv)
            torch.cuda.synchronize()
            wall = time.time() - t0
            out = buf.getvalue()
            figures, bad = EXAMPLE_CHECKS[name](out, argv)
            if name == "train_adaptive_torch":
                kept = {p.name: sum(f.stat().st_size for f in p.rglob("*")
                                    if f.is_file())
                        for p in sorted(ckpt.glob("step_*"))}
                figures["checkpoints"] = {"bytes": kept, **saves}
                if sorted(kept) != ["step_0000000050", "step_0000000060"]:
                    bad.append(f"checkpoints {sorted(kept)}")
            if rc != 0:
                bad.insert(0, f"exit code {rc}")
            emit({"phase": "examples", "example": name, "argv": argv,
                  "rc": rc, "wall_s": wall, **figures, "failed": bad,
                  **({"last_lines": out.splitlines()[-5:]} if bad else {})})
            failed += [f"{name} {' '.join(argv)}: {b}" for b in bad]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        instances._REGISTRY.update(own)
    if failed:
        raise AssertionError("examples: " + "; ".join(failed))


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
            t0 = time.time()
            run()
            wall = time.time() - t0
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
        emit({"phase": "launches", "path": path, "wall_s": wall, **counts,
              **({"in_worker_processes": in_ranks,
                  "worker_processes": len(ranks)} if ranks is not None else {}),
              "compared_with_plain": compared,
              "every_call_compared": every,
              "calls_by_shape": {k: v for k, v in by_shape.items() if v}})
        for name in needs:
            if counts[name] <= 0 or (ranks is not None and in_ranks[name] <= 0):
                raise AssertionError(f"{name} was not launched on the {path} path")
        shapes_by_path[path] = by_shape
        return counts

    shapes_by_path = {}

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
    solo = {}
    by_path["pool"] = drive(
        "pool", lambda: phase_pool(torch, kadabra_full_instance(), wrs,
                                   graph=(g, full["pre"]), solo_out=solo),
        ("frame_accum", "bfs_frontier", "alias_draw"))
    substrate_ranks = []
    by_path["substrate"] = drive(
        "substrate",
        lambda: phase_substrate(torch, g, full, check, substrate_ranks),
        ("bfs_frontier", "alias_draw"), every=False, ranks=substrate_ranks)
    pool_ranks = []
    by_path["pool-ranks"] = drive(
        "pool-ranks",
        lambda: phase_pool_ranks(torch, g, full["pre"], wrs, table, solo,
                                 pool_ranks),
        ("frame_accum", "bfs_frontier", "alias_draw"), ranks=pool_ranks)
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
    by_path["families"] = drive("families", lambda: phase_families(torch),
                                ("flash_attention",))
    import ast
    flash_shapes = shapes_by_path["families"]["flash_attention"]
    hds = {ast.literal_eval(key)[1][3] for key in flash_shapes}
    if not {120, 64, 128} <= hds:
        raise AssertionError(f"flash_attention on the families path ran at "
                             f"hd {sorted(hds)}, not at 120, 64 and 128")
    rows["flash_attention"]["families_calls_by_shape"] = flash_shapes
    torch.cuda.empty_cache()
    checked_before = len(check.flash_bwd_rows)
    by_path["train"] = drive("train", lambda: phase_train(torch),
                             ("flash_attention", "flash_attention_bwd",
                              "rglru_scan", "rglru_scan_bwd", "ssm_scan",
                              "ssm_scan_bwd"))
    emit({"phase": "train", "flash_attention_bwd_checks":
          check.flash_bwd_rows[checked_before:]})
    torch.cuda.empty_cache()
    by_path["examples"] = drive("examples", lambda: phase_examples(torch),
                                ("frame_accum", "bfs_frontier", "alias_draw",
                                 "flash_attention", "flash_attention_bwd"))
    torch.cuda.empty_cache()
    from repro_torch.launch.spawn import RankPool
    t0 = time.time()
    # the ranks' allocators map memory in segments that grow: phase 15's
    # largest cases fill the card with 4 ranks, whose fixed-size segments
    # kept ~2 GB each reserved but unused
    alloc = os.environ.get("PYTORCH_CUDA_ALLOC_CONF")
    os.environ["PYTORCH_CUDA_ALLOC_CONF"] = "expandable_segments:True"
    try:
        pool = RankPool(4, backend="gloo", device="cuda", timeout=ZOO_TIMEOUT_S)
    finally:
        if alloc is None:
            del os.environ["PYTORCH_CUDA_ALLOC_CONF"]
        else:
            os.environ["PYTORCH_CUDA_ALLOC_CONF"] = alloc
    emit({"phase": "rank pool", "ranks": 4, "backend": "gloo",
          "spawn_s": time.time() - t0, "paths": ["zoo-mesh", "train-mesh"]})
    try:
        zoo_ranks = []
        by_path["zoo-mesh"] = drive(
            "zoo-mesh", lambda: phase_zoo_mesh(torch, pool, zoo_ranks),
            ("flash_attention", "rglru_scan", "ssm_scan"), every=True,
            ranks=zoo_ranks)
        torch.cuda.empty_cache()
        train_ranks = []
        by_path["train-mesh"] = drive(
            "train-mesh", lambda: phase_train_mesh(torch, pool, train_ranks,
                                                   check),
            ("flash_attention", "flash_attention_bwd", "rglru_scan",
             "rglru_scan_bwd", "ssm_scan", "ssm_scan_bwd"), every=True,
            ranks=train_ranks)
    finally:
        pool.close()

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
        # the backwards: the forward's Pallas kernel, which has no backward
        "flash_attention_bwd": ("src/repro_torch/kernels/csrc/flash_attention.cu",
                                "src/repro/kernels/flash_attention.py:81"),
        "rglru_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                           "src/repro/kernels/rglru_scan.py:24"),
        "ssm_scan_bwd": ("src/repro_torch/kernels/csrc/ssm_scan.cu",
                         "src/repro/kernels/ssm_scan.py:32"),
    }
    xla_site = {"flash_attention_bwd": "src/repro/models/attention.py:44",
                "rglru_scan_bwd": "src/repro/models/ssm.py:40",
                "ssm_scan_bwd": "src/repro/models/ssm.py:40"}
    kernels = [{"name": name, "route": "cuda", "source": meta[name][0],
                "replaces": meta[name][1],
                "launches": sum(c[name] for c in by_path.values()),
                "launches_by_path": {p: c[name] for p, c in by_path.items()},
                **rows[name], "max_abs_err": check.max_err[name],
                "compared_with_plain": check.calls[name],
                **({"note": f"backward of the kernel in 'replaces'; no Pallas "
                            f"counterpart: the reference differentiates in "
                            f"XLA ({xla_site[name]})"}
                   if name in xla_site else {})} for name in mods]
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
