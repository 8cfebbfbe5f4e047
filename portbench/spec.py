"""``BENCHMARK.json`` and the files it names, found by name.

A cell's configuration is the file its ``configs`` entry names.  Its
traffic is ``<path>/traffic/<traffic>.json``, a generator
``<path>/gens/<generator>.py``, a query driver ``<path>/queries/<query>.py``
with its limits ``<path>/limits/<query>.json``, and a metric's reader
``<path>/metrics/<name>.py``, for the first of the benchmark's ``paths``
that holds one.  A quantity split over kinds of cell, as ``x.<kind>``
beside ``x``, is read by ``x``'s reader where it has none of its own.  A later cell, traffic mix or metric is a new file and a new
entry: nothing here changes.
"""

from __future__ import annotations

import importlib.util
import json
import re
from pathlib import Path
from types import ModuleType


class Bench:
    def __init__(self, root: Path, spec: dict):
        self.root = Path(root)
        self.spec = spec

    @classmethod
    def load(cls, root) -> "Bench":
        root = Path(root)
        return cls(root, json.loads((root / "BENCHMARK.json").read_text()))

    def _find(self, kind: str, name: str, suffix: str) -> Path:
        for p in self.spec["paths"]:
            path = self.root / p / kind / f"{name}{suffix}"
            if path.is_file():
                return path
        raise FileNotFoundError(f"no {kind}/{name}{suffix} under any of "
                                f"{self.spec['paths']} in {self.root}")

    def _entry(self, key: str, name: str) -> dict:
        for e in self.spec[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"{key} has no entry named {name!r}")

    def cell(self, name: str) -> dict:
        return self._entry("workloads", name)

    def config(self, name: str) -> dict:
        entry = self._entry("configs", name)
        return {**json.loads((self.root / entry["file"]).read_text()),
                "name": name}

    def traffic(self, name: str) -> dict:
        return {**json.loads(self._find("traffic", name, ".json").read_text()),
                "name": name}

    def limits(self, query: str) -> dict:
        return json.loads(self._find("limits", query, ".json").read_text())

    def module(self, kind: str, name: str) -> ModuleType:
        path = self._find(kind, name, ".py")
        mod_name = "portbench_" + kind + "_" + re.sub(r"\W", "_", name)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod

    def reader(self, metric: str) -> ModuleType:
        """The module whose ``read(run)`` gives ``metric``."""
        try:
            return self.module("metrics", metric)
        except FileNotFoundError:
            if "." not in metric:
                raise
            return self.module("metrics", metric.split(".")[0])

    def _reports(self, metric: dict, cell: str, e2e: list) -> bool:
        if "workloads" in metric:
            return cell in metric["workloads"]
        return metric["moves"] in e2e

    def end_to_end(self, cell: str) -> list:
        return [m for m in self.spec["end_to_end"]
                if "workloads" not in m or cell in m["workloads"]]

    def per_layer(self, cell: str) -> list:
        e2e = [m["name"] for m in self.end_to_end(cell)]
        return [m for m in self.spec["per_layer"] if self._reports(m, cell, e2e)]
