"""Dry run of the model zoo on a mesh: does every (architecture × input
shape × mesh) cell fit, and what are its roofline terms on the H100.
Port of :mod:`repro.launch.dryrun`.

    python -m repro_torch.launch.dryrun --arch smollm-360m --shape decode_32k
    python -m repro_torch.launch.dryrun --all             # every applicable cell
    python -m repro_torch.launch.dryrun --all --multipod  # (2, 16, 16)
    python -m repro_torch.launch.dryrun --all --opt       # the --opt policies
    python -m repro_torch.launch.dryrun --execute --arch h2o-danube-3-4b-reduced \\
        --shape decode_32k --mesh 2x2                 # on the card

A cell is abstract: ``launch.specs.input_specs`` builds the step's inputs
on the ``meta`` device (no memory, no ranks) over the production mesh,
the counterpart of the reference's compile-only pass.  Each cell prints one
JSON line: the per-device argument bytes (params, opt state, cache,
batch), ``model_flops``, ``analytic_bytes``, the closed-form collective
bytes, the H100 roofline terms (``analysis.roofline``; FLOPs per device =
MODEL_FLOPS / devices) and the dominant term; the lines also go to
``--out`` (default ``dryrun_out/``, git-ignored), one file a cell.  The
counts are closed forms, not a compiler's count of each scan body once, so
no layer differencing is needed.

``--execute`` runs one cell's sharded step for real instead, on W =
mesh-size gloo ranks started by ``launch.spawn.spawn_workers``: on the
card by default, or with ``--device cpu``.  A serving cell runs
``launch.sharded.serve_rank`` (weights and inputs from seed 0, a prefill
cell's batch, in ``data.family_batch``'s layout with vlm's patches or
encdec's frames, prefilled after one untimed warm-up, a decode cell's one
step at its last slot).  A train cell runs ``launch.sharded.train_rank``:
weights and a batch with labels from seed 0, the config's
``grad_accum`` micro-batches, one untimed warm step and then the timed
step.  Every family of the zoo runs, serving and training.  It adds the
wall time of the step, each rank's weight bytes (and for a train cell
its gradient and optimizer-state bytes, the loss and the grad norm) and
peak memory, and the collectives by kind (``analysis.comms``; a train
cell's split into forward, backward and optimizer).
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import time
from pathlib import Path
from typing import Optional

OUT = Path("dryrun_out")
SEED = 0               # --execute: weights and tokens
TIMEOUT_S = 1800.0     # --execute: the ranks' run

# the --opt policies: per-arch changes beyond the baseline, as the
# reference's OPTS and OPT_FLAGS
OPTS = {
    "qwen3-moe-235b-a22b": dict(moe_group=128),
    "smollm-360m": dict(grad_accum=1),
    "mistral-large-123b": dict(grad_accum=32),
    "internlm2-20b": dict(grad_accum=4),
}
OPT_FLAGS = {
    "smollm-360m": dict(dp_over_model=True, zero1=True),
}


def run_cell(arch: str, shape_name: str, multi_pod: bool, opt: bool = False,
             out_dir: Path = OUT) -> dict:
    from ..analysis.analytic import analytic_bytes, analytic_collective_bytes
    from ..analysis.roofline import H100, model_flops, roofline_terms
    from ..models import SHAPES, cell_is_applicable, get_config
    from .mesh import make_production_mesh
    from .sharding import default_flags
    from .specs import argument_bytes, input_specs

    cfg = get_config(arch)
    flags = None
    if opt:
        cfg = dataclasses.replace(cfg, **OPTS.get(arch, {}))
        if arch in OPT_FLAGS:
            flags = dataclasses.replace(default_flags(cfg), **OPT_FLAGS[arch])
    shape = SHAPES[shape_name]
    mesh = make_production_mesh(multi_pod=multi_pod)
    cell = f"{arch}__{shape_name}__{mesh.name}" + ("__opt" if opt else "")
    ok, why = cell_is_applicable(cfg, shape)
    rec = {"cell": cell, "arch": arch, "shape": shape_name, "mesh": mesh.name,
           "applicable": ok, "skip_reason": why}
    if ok:
        kwargs, shardings, rules, _ = input_specs(cfg, shape, mesh, flags)
        chips = mesh.size
        m_axis = dict(zip(mesh.axis_names, mesh.shape)).get("model", 1)
        if rules.rules["heads"] == ():           # dp_over_model
            m_axis = 1
        arg = argument_bytes(kwargs, shardings, mesh)
        mf = model_flops(cfg, shape)
        nbytes = analytic_bytes(cfg, shape, chips, model_axis=m_axis)
        coll = analytic_collective_bytes(cfg, shape, chips, model_axis=m_axis)
        terms = roofline_terms(flops_per_dev=mf / chips, bytes_per_dev=nbytes,
                               coll_bytes_per_dev=coll, chips=chips, cfg=cfg,
                               shape=shape)
        rec.update({
            "chips": chips, "hardware": H100.name,
            "argument_bytes": arg, "argument_bytes_total": sum(arg.values()),
            "fits_80gb": sum(arg.values()) <= 80e9,
            "model_flops": mf, "analytic_bytes": nbytes,
            "analytic_collective_bytes": coll,
            "roofline": terms.as_dict(), "dominant": terms.dominant})
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{cell}.json").write_text(json.dumps(rec, indent=1))
    print(json.dumps(rec), flush=True)
    return rec


def execute(arch: str, shape_name: str, mesh: str, device=None,
            overrides: Optional[dict] = None) -> dict:
    """One cell's sharded step run on W ranks (see the docstring): a
    prefill cell prefills its (batch, seq) prompts, a decode cell decodes
    one step at the last of its seq slots, a train cell takes a warm step
    and a timed one.  ``overrides`` replaces fields of the config (a depth
    cut), under the policy of the config as registered (a cut would lower
    ``param_count`` and flip ``default_flags``)."""
    import numpy as np
    import torch

    from ..data import family_batch
    from ..device import resolve_device
    from ..models import SHAPES, cell_is_applicable, resolve_config
    from .sharded import serve_rank, train_rank
    from .sharding import default_flags
    from .spawn import spawn_workers
    from .specs import microbatched

    dev = resolve_device(device)               # raises without a card
    cfg = resolve_config(arch)
    flags = dataclasses.asdict(default_flags(cfg))
    cfg, shape = dataclasses.replace(cfg, **(overrides or {})), SHAPES[shape_name]
    ok, why = cell_is_applicable(cfg, shape)
    if not ok:
        raise ValueError(f"{arch} × {shape_name}: {why}")
    dims = tuple(int(n) for n in mesh.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    world = int(np.prod(dims))
    B, S = shape.global_batch, shape.seq_len
    device_name = torch.cuda.get_device_name(0) if dev.type == "cuda" else "cpu"
    if shape.kind == "train":
        n_micro, mb = microbatched(shape, cfg.grad_accum)
        batch = family_batch(cfg, B, S, torch.Generator().manual_seed(SEED),
                             train=True)
        batch = {k: (v.float() if v.is_floating_point() else v).numpy()
                 .reshape((n_micro, mb) + tuple(v.shape[1:]))
                 for k, v in batch.items()}
        t0 = time.time()
        ranks = spawn_workers(train_rank, world, backend="gloo",
                              device=dev.type,
                              args=(arch, dims, axes, [batch, batch], flags,
                                    SEED, None, None, overrides),
                              timeout=TIMEOUT_S)
        rec = {"arch": arch, "shape": shape_name, "mesh": mesh,
               "world": world, "backend": "gloo", "device": dev.type,
               "device_name": device_name, "micro_batches": [n_micro, mb],
               "spawn_and_run_s": time.time() - t0,
               "loss": ranks[0]["steps"][-1]["loss"],
               "grad_norm": ranks[0]["steps"][-1]["grad_norm"],
               "ranks": [{**{k: v for k, v in r.items() if k != "steps"},
                          "warm_wall_s": r["steps"][0]["wall_s"],
                          "wall_s": r["steps"][-1]["wall_s"],
                          "collectives": r["steps"][-1]["collectives"]}
                         for r in ranks]}
        print(json.dumps(rec, default=str), flush=True)
        return rec
    if shape.kind == "decode":
        rng = np.random.default_rng(SEED)
        prompts, dec, start = None, rng.integers(0, cfg.vocab, (B, 1)), S - 1
    else:
        batch = family_batch(cfg, B, S, torch.Generator().manual_seed(SEED))
        prompts, dec, start = {k: (v.float() if v.is_floating_point() else v)
                               .numpy() for k, v in batch.items()}, None, 0
    t0 = time.time()
    ranks = spawn_workers(serve_rank, world, backend="gloo", device=dev.type,
                          args=(arch, dims, axes, flags, SEED, None, None,
                                prompts, dec, S, True, start, overrides),
                          timeout=TIMEOUT_S)
    rec = {"arch": arch, "shape": shape_name, "mesh": mesh, "world": world,
           "backend": "gloo", "device": dev.type, "device_name": device_name,
           "spawn_and_run_s": time.time() - t0,
           "ranks": [{k: v for k, v in r.items() if not k.endswith("_logits")}
                     for r in ranks]}
    for r in rec["ranks"]:
        if "decode" in r:
            r["decode"]["next_tokens"] = r["decode"]["next_tokens"].tolist()
    print(json.dumps(rec, default=str), flush=True)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--multipod", action="store_true")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--opt", action="store_true",
                    help="apply the --opt policy of the arch")
    ap.add_argument("--out", type=Path, default=OUT)
    ap.add_argument("--execute", action="store_true",
                    help="run one cell's sharded step on ranks")
    ap.add_argument("--mesh", default="2x2",
                    help="--execute: the mesh, e.g. 2x2, 1x4, 2x2x2")
    ap.add_argument("--device", default=None,
                    help="--execute: cpu, or the card (default)")
    args = ap.parse_args(argv)

    if args.execute:
        if not (args.arch and args.shape):
            ap.error("--execute needs --arch and --shape")
        execute(args.arch, args.shape, args.mesh, args.device)
        return 0

    from ..models import SHAPES, all_configs
    if args.all:
        cells = [(a, s) for a in sorted(all_configs()) for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch and --shape, or --all")
        cells = [(args.arch, args.shape)]
    n = 0
    for arch, shape in cells:
        n += run_cell(arch, shape, args.multipod, opt=args.opt,
                      out_dir=args.out)["applicable"]
    print(f"[dryrun] {n} applicable cell(s) of {len(cells)}", file=sys.stderr)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
