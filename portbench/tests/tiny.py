"""A throwaway benchmark root for the CPU tests: ``BENCHMARK.json`` with the
paths ``portbench`` (the real harness, linked) and ``tiny`` (small
configurations and traffic written by the test)."""

from __future__ import annotations

import json
from pathlib import Path

HARNESS = Path(__file__).resolve().parents[1]
ROOT = HARNESS.parent

CONFIGS = {
    "urand-s9": {"generator": "urand", "scale": 9, "edge_factor": 4},
    "kron-s9": {"generator": "kron", "scale": 9, "edge_factor": 8,
                "A": 0.57, "B": 0.19, "C": 0.19},
}
TRAFFIC = {
    "local-w2": {"query": "kadabra", "eps": 0.1, "delta": 0.1,
                 "strategy": "local", "world": 2, "batch": 8,
                 "rounds_per_epoch": 2, "max_epochs": 16, "checked_queries": 2},
    "indexed-w3": {"query": "kadabra", "eps": 0.1, "delta": 0.1,
                   "strategy": "indexed", "world": 3, "batch": 8,
                   "rounds_per_epoch": 2, "max_epochs": 16,
                   "checked_queries": 2},
    # the cells' lanes: 16 workers of 64 samples a round
    "local-w16": {"query": "kadabra", "eps": 0.1, "delta": 0.1,
                  "strategy": "local", "world": 16, "batch": 64,
                  "rounds_per_epoch": 2, "max_epochs": 16, "checked_queries": 1},
}
CELLS = {"u.local": ("urand-s9", "local-w2"), "k.local": ("kron-s9", "local-w2"),
         "u.indexed": ("urand-s9", "indexed-w3"),
         "u.local-w16": ("urand-s9", "local-w16")}


def make_root(tmp: Path, configs=CONFIGS, traffic=TRAFFIC, cells=CELLS,
              metrics=None) -> Path:
    """Write the root under ``tmp``; ``metrics`` adds per-layer entries."""
    tmp.mkdir(parents=True, exist_ok=True)
    (tmp / "portbench").symlink_to(HARNESS, target_is_directory=True)
    for kind in ("configs", "traffic", "metrics"):
        (tmp / "tiny" / kind).mkdir(parents=True, exist_ok=True)
    for name, cfg in configs.items():
        (tmp / "tiny" / "configs" / f"{name}.json").write_text(json.dumps(cfg))
    for name, t in traffic.items():
        (tmp / "tiny" / "traffic" / f"{name}.json").write_text(json.dumps(t))
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    spec["paths"] = ["portbench", "tiny"]
    spec["configs"] = [{"name": n, "source": "test", "reduced": [], "why": "test",
                        "file": f"tiny/configs/{n}.json"} for n in configs]
    spec["workloads"] = [{"name": c, "config": cfg, "traffic": t, "chips": 1,
                          "why": "test"} for c, (cfg, t) in cells.items()]
    # every metric in every test cell: the parts of a split quantity go
    for kind in ("end_to_end", "per_layer"):
        spec[kind] = [m for m in spec[kind] if "." not in m["name"]]
        for m in spec[kind]:
            m.pop("workloads", None)
    spec["per_layer"] += list(metrics or [])
    (tmp / "BENCHMARK.json").write_text(json.dumps(spec, indent=1))
    return tmp
