"""Readings for the limits of ``correct``, at a cell's own size.

    python3 portbench/control.py --workload <cell> --seeds 1,2,3 [--queries 2]

For each seed, in one process: the cell's graph, the port's first
``--queries`` queries of a run with that seed (the queries a run's window
starts with), then the reference's answers to them and the control's, each
compared with the reference by the cell's own comparison.  The control is
the reference put in the port's place with one guarantee broken: it draws
each predecessor uniformly instead of in proportion to its path count σ.
One JSON line a seed: the port's numbers (the lower readings), the
control's (the upper ones), and the reference's time a query.  The
benchmark's runs do not run this.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def readings(bench, name: str, seed: int, queries: int, device) -> dict:
    import torch

    from portbench import graph as graph_mod
    from portbench.reference.graph import RefGraph
    from portbench.seeds import query_seed

    cell = bench.cell(name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    driver_mod = bench.module("queries", traffic["query"])
    n, tuples = graph_mod.edge_tuples(bench, config, seed, device)
    csr = graph_mod.csr_from_tuples(n, tuples)
    driver = driver_mod.Driver(graph_mod.port_graph(csr), traffic, device)
    del tuples
    runs = [driver.query(query_seed(seed, k)) for k in range(queries)]
    got = [driver_mod.settle(out) for _, out in runs]
    del driver, csr
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    n, tuples = graph_mod.edge_tuples(bench, config, seed, device)
    ref_graph = RefGraph(n, tuples, device)
    line = {"workload": name, "seed": seed, "port": [], "reference_s": [],
            "tau": [], "uniform": []}
    every = driver_mod.check_every(got, ref_graph)
    for (rec, _), out, numbers in zip(runs, got, every):
        t = time.perf_counter()
        ref = driver_mod.reference_output(ref_graph, traffic, rec["seed"])
        line["reference_s"].append(time.perf_counter() - t)
        line["tau"].append(ref["tau"])
        line["port"].append({**numbers, **driver_mod.compare(out, ref)})
        ctl = driver_mod.reference_output(ref_graph, traffic, rec["seed"],
                                          uniform=True)
        line["uniform"].append(driver_mod.compare(ctl, ref))
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--queries", type=int, default=2)
    args = ap.parse_args(argv)
    for p in (str(ROOT / "src"), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    from portbench.spec import Bench

    bench = Bench.load(ROOT)
    for seed in (int(s) for s in args.seeds.split(",")):
        print(json.dumps(readings(bench, args.workload, seed, args.queries,
                                  "cuda")), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
