"""Run one cell of ``BENCHMARK.json`` on the CUDA card and print its result.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Set-up loads (on a checkout's first run,
builds, into the port's own ``build/repro_torch_kernels/`` inside the
checkout) the port's kernels, makes the cell's graph on the card from the
seed and runs one warm-up query.  The window then runs queries back to back
for ``--seconds`` seconds, one in flight (a closed loop), each seeded from
``--seed`` and its index; the query under way when the window closes runs
to its end.  Afterwards the plain reference (``portbench/reference/``)
reads the query driver's ``check_every`` numbers on every query of the
window, and works out again and compares the query with the most samples
and others drawn from the seed (the traffic's ``checked_queries`` in all).
Standard error ends
with each compared number beside its limit; standard output ends with one
JSON line: ``correct``, ``attempted``, ``failed``, the metrics (the cell's
end-to-end ones, or with ``--trace 1`` its per-layer ones, read under
``torch.profiler``), ``device`` and, traced, ``breakdown``, then ``checks``.

A run exits with another code than 0 and prints no result where there is no
card (or fewer than the cell asks for), where it finds ``jax``, ``jaxlib``,
``flax`` or the reference package ``repro`` loaded once the window has
closed, where it read a file of ``benchmarks/`` or ``src/repro/``, or where
it wrote outside the checkout, ``HOME``, ``XDG_CACHE_HOME`` and ``TMPDIR``.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FOREIGN = ("jax", "jaxlib", "flax", "repro")


class Watch:
    """An audit hook that notes reads of the reference package and of its
    benchmarks, and writes outside the places a run may write to."""

    def __init__(self, root: Path):
        self.unread = [str(root / "benchmarks"), str(root / "src" / "repro")]
        self.writable = [str(root), os.devnull]
        for var in ("HOME", "XDG_CACHE_HOME", "TMPDIR"):
            if os.environ.get(var):
                self.writable.append(os.path.realpath(os.environ[var]))
        if not os.environ.get("TMPDIR"):
            import tempfile
            self.writable.append(os.path.realpath(tempfile.gettempdir()))
        self.violations = []

    @staticmethod
    def _under(path: str, roots) -> bool:
        return any(path == r or path.startswith(r.rstrip(os.sep) + os.sep)
                   for r in roots)

    def __call__(self, event, args):
        if event != "open" or isinstance(args[0], int):
            return
        path = os.path.realpath(os.fsdecode(args[0]))
        mode, flags = args[1], args[2] or 0
        writes = (isinstance(mode, str) and any(c in mode for c in "wax+")) or \
            bool(flags & (os.O_WRONLY | os.O_RDWR | os.O_CREAT | os.O_APPEND))
        if self._under(path, self.unread):
            self.violations.append(f"read {path}")
        elif writes and not self._under(path, self.writable):
            self.violations.append(f"wrote {path}")


def foreign_modules() -> list:
    """Loaded modules whose top-level name is one the port must not load."""
    return sorted({name for name in sys.modules
                   if name.split(".")[0] in FOREIGN})


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _pick(outputs: list, count: int, seed: int) -> list:
    """The queries to check: the one that drew the most samples, and the
    rest drawn from the seed."""
    from portbench.seeds import check_seed

    count = min(count, len(outputs))
    if count == 0:
        return []
    most = max(range(len(outputs)), key=lambda i: outputs[i]["tau"])
    rest = [i for i in range(len(outputs)) if i != most]
    return [most] + random.Random(check_seed(seed)).sample(rest, count - 1)


def check(bench, config, traffic, seed, records, outputs, driver_mod, device):
    """Hold the window's queries against the reference: the driver's
    ``check_every`` numbers for each query, and for a sample of them its
    ``compare`` of the query worked out again.  Returns each number's
    largest reading with its limit, the queries that failed one, and how
    many were worked out again."""
    from portbench import graph as graph_mod
    from portbench.reference.graph import RefGraph

    limits = bench.limits(traffic["query"])
    picked = _pick(outputs, int(traffic.get("checked_queries", 1)), seed)
    n, tuples = graph_mod.edge_tuples(bench, config, seed, device)
    ref_graph = RefGraph(n, tuples, device)
    del tuples
    numbers = driver_mod.check_every(outputs, ref_graph)
    for i in picked:
        ref = driver_mod.reference_output(ref_graph, traffic, records[i]["seed"])
        numbers[i].update(driver_mod.compare(outputs[i], ref))
    worst = {k: max([q[k] for q in numbers if k in q], default=0.0)
             for k in limits}
    failed = sum(any(v > limits[k] for k, v in q.items()) for q in numbers)
    return ({k: {"value": worst[k], "limit": limits[k]} for k in limits},
            failed, len(picked))


def run_cell(bench, name: str, seed: int, seconds: float, trace: bool,
             device="cuda", t0: float = None) -> dict:
    """One run of cell ``name``; returns the result's fields (the caller
    prints them).  ``device="cpu"`` runs the port's plain versions, for the
    tests."""
    import torch

    from portbench import graph as graph_mod
    from portbench.seeds import query_seed, warmup_seed
    from portbench.trace import WINDOW, Trace

    t0 = time.perf_counter() if t0 is None else t0
    device = torch.device(device)
    cell = bench.cell(name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    driver_mod = bench.module("queries", traffic["query"])
    marks = [("imports", time.perf_counter())]
    if device.type == "cuda":
        torch.cuda.init()
        marks.append(("cuda init", time.perf_counter()))
        from repro_torch.kernels import build
        for kernel in driver_mod.KERNELS:
            build.load(kernel)
        marks.append(("kernels", time.perf_counter()))
        torch.cuda.reset_peak_memory_stats(device)
    n, tuples = graph_mod.edge_tuples(bench, config, seed, device)
    csr = graph_mod.csr_from_tuples(n, tuples)
    del tuples
    graph = graph_mod.port_graph(csr)
    shape = {k: csr[k] for k in ("n", "m_arcs", "max_degree")}
    _sync(device)
    marks.append(("graph", time.perf_counter()))
    driver = driver_mod.Driver(graph, traffic, device)
    driver.query(warmup_seed(seed))
    _sync(device)
    marks.append(("warm-up query", time.perf_counter()))
    setup_s = marks[-1][1] - t0
    parts, last = [], t0
    for what, t in marks:
        parts.append(f"{what} {t - last:.3f}")
        last = t
    print(f"portbench: setup {setup_s:.3f} s: {', '.join(parts)}",
          file=sys.stderr)

    records, outputs = [], []
    tracer = Trace(device).__enter__() if trace else None
    with torch.profiler.record_function(WINDOW):
        start = time.perf_counter()
        while time.perf_counter() - start < seconds:
            rec, out = driver.query(query_seed(seed, len(records)))
            records.append(rec)
            outputs.append(out)
    trace_data = None
    if tracer is not None:
        tracer.__exit__(None, None, None)
        trace_data = tracer.reduce()
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    run = SimpleNamespace(queries=records, graph=shape, traffic=traffic,
                          config=config, setup_s=setup_s, window_start=start,
                          trace=trace_data)
    metrics = {}
    for m in (bench.per_layer(name) if trace else bench.end_to_end(name)):
        value = bench.reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    outputs = [driver_mod.settle(o) for o in outputs]
    del driver, graph, csr
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    t_check = time.perf_counter()
    checks, failed, checked = check(bench, config, traffic, seed, records,
                                    outputs, driver_mod, device)
    walls = sorted(r["wall_s"] for r in records)
    print(f"portbench: query walls min {walls[0]:.4f} median "
          f"{walls[len(walls) // 2]:.4f} max {walls[-1]:.4f} s; tau "
          f"{sorted({r['tau'] for r in records})}; vd_upper "
          f"{sorted({o['vd_upper'] for o in outputs})}", file=sys.stderr)
    print(f"portbench: {len(records)} queries in the window, "
          f"{checked} checked against the reference "
          f"in {time.perf_counter() - t_check:.3f} s, graph {shape}",
          file=sys.stderr)
    dev_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                "kind": torch.cuda.get_device_name(device)
                if device.type == "cuda" else device.type,
                "count": int(cell["chips"]), "memory_peak_bytes": int(peak)}
    result = {"correct": all(c["value"] <= c["limit"] for c in checks.values()),
              "attempted": len(records), "failed": failed,
              "metrics": metrics, "device": dev_info}
    if trace_data is not None:
        dev_info["busy_s"] = trace_data.busy_s
        dev_info["window_s"] = trace_data.window_s
        result["breakdown"] = {"device_ops": trace_data.top_device_ops(),
                               "idle_gaps": trace_data.idle_gaps()}
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    watch = Watch(ROOT)
    sys.addaudithook(watch)
    # run as a script, the harness's own folder heads sys.path, where its
    # modules (trace, tests, ...) would shadow top-level ones
    here = str(Path(__file__).resolve().parent)
    sys.path[:] = [p for p in sys.path if os.path.realpath(p or ".") != here]
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.spec import Bench

    bench = Bench.load(ROOT)
    chips = int(bench.cell(args.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"torch sees {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    result = run_cell(bench, args.workload, args.seed, args.seconds,
                      bool(args.trace), device="cuda", t0=T0)
    foreign = foreign_modules()
    if foreign or watch.violations:
        print(f"portbench: foreign modules loaded: {foreign}; files: "
              f"{watch.violations[:20]}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
