"""The harness on the CPU at a tiny size: cells found by name, the result's
line, the per-layer readers' arithmetic, and the isolation of the run from
the reference package and of the plain reference from the port."""

import ast
import json
import subprocess
import sys
from pathlib import Path
from types import SimpleNamespace

import pytest

from portbench.run import FOREIGN, Watch, foreign_modules, run_cell
from portbench.spec import Bench
from portbench.trace import WINDOW, TraceData

from .tiny import HARNESS, ROOT, make_root

RING = '''"""A ring of 2^scale vertices with chords: a generator added as a file."""
import torch


def edge_tuples(config, gen, device):
    n = 1 << int(config["scale"])
    v = torch.arange(n, device=device)
    chords = torch.randint(0, n, (n,), generator=gen, device=device)
    return n, torch.cat([torch.stack([v, (v + 1) % n], 1),
                         torch.stack([v, chords], 1)])
'''
QUERIES = '''"""Queries completed in the window: a per-layer reader added as a file."""


def read(run):
    return float(len(run.queries)) if run.queries else None
'''


def test_a_new_config_traffic_generator_and_metric_run_without_an_edit(tmp_path):
    before = {p: p.read_bytes() for p in HARNESS.rglob("*.py")}
    root = make_root(
        tmp_path,
        configs={"ring-s8": {"generator": "ring", "scale": 8}},
        traffic={"local-w3": {"query": "kadabra", "eps": 0.2, "delta": 0.1,
                              "strategy": "local", "world": 3, "batch": 4,
                              "rounds_per_epoch": 2, "max_epochs": 8,
                              "checked_queries": 1}},
        cells={"ring.local": ("ring-s8", "local-w3")},
        metrics=[{"name": "queries_in_window", "unit": "queries",
                  "better": "higher", "source": "program_counter",
                  "layer": "driver", "moves": "time_to_stop_s"}])
    (root / "tiny" / "gens").mkdir()
    (root / "tiny" / "gens" / "ring.py").write_text(RING)
    (root / "tiny" / "metrics" / "queries_in_window.py").write_text(QUERIES)
    bench = Bench.load(root)
    out = run_cell(bench, "ring.local", 11, 0.3, trace=True, device="cpu")
    assert out["correct"] and out["attempted"] >= 1
    assert out["metrics"]["queries_in_window"] == {
        "value": float(out["attempted"]), "unit": "queries"}
    assert {p: p.read_bytes() for p in HARNESS.rglob("*.py")} == before


@pytest.mark.parametrize("trace", [False, True])
def test_the_result_line(tmp_path, trace):
    bench = Bench.load(make_root(tmp_path))
    out = run_cell(bench, "u.local", 2**31 + 77, 0.3, trace=trace, device="cpu")
    line = json.loads(json.dumps(out))
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(line)[:5] == keys and list(line)[-1] == "checks"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 1
    wanted = bench.per_layer("u.local") if trace else bench.end_to_end("u.local")
    units = {m["name"]: m["unit"] for m in wanted}
    assert set(line["metrics"]) <= set(units)
    for name, m in line["metrics"].items():
        assert m["unit"] == units[name] and isinstance(m["value"], float)
    if not trace:
        assert set(line["metrics"]) == set(units)
    else:
        # the CPU runs the plain BFS: no kernel launch, no device roofline
        assert "bfs_frontier_roofline" not in line["metrics"]
        assert {"busy_s", "window_s"} <= set(line["device"])
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    for c in line["checks"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]


def test_the_seed_makes_the_inputs(tmp_path):
    from portbench import graph as graph_mod
    from portbench.seeds import query_seed

    bench = Bench.load(make_root(tmp_path))
    cell = bench.cell("k.local")
    config, traffic = bench.config(cell["config"]), bench.traffic(cell["traffic"])
    driver_mod = bench.module("queries", traffic["query"])
    seed = 2**31 + 5
    outs = []
    for _ in range(2):
        n, tuples = graph_mod.edge_tuples(bench, config, seed, "cpu")
        graph = graph_mod.port_graph(graph_mod.csr_from_tuples(n, tuples))
        driver = driver_mod.Driver(graph, traffic, "cpu")
        outs.append([driver_mod.settle(driver.query(query_seed(seed, k))[1])
                     for k in range(2)])
    for a, b in zip(*outs):
        assert (a["btilde"] == b["btilde"]).all() and a["tau"] == b["tau"]
    assert not (outs[0][0]["btilde"] == outs[0][1]["btilde"]).all()
    assert len({query_seed(seed, k) for k in range(100)}) == 100


def test_foreign_modules_compares_whole_top_level_names(monkeypatch):
    for name in ("repro_torch", "repro_torch.core", "reproducible", "jax_like",
                 "flaxen"):
        monkeypatch.setitem(sys.modules, name, sys)
    assert not [m for m in foreign_modules()
                if m.split(".")[0] not in FOREIGN]
    monkeypatch.setitem(sys.modules, "repro.core.epoch", sys)
    monkeypatch.setitem(sys.modules, "jaxlib", sys)
    assert {"repro.core.epoch", "jaxlib"} <= set(foreign_modules())


def test_watch_notes_reads_of_the_reference_and_writes_elsewhere(tmp_path,
                                                                 monkeypatch):
    monkeypatch.setenv("TMPDIR", str(tmp_path / "tmp"))
    monkeypatch.setenv("HOME", str(tmp_path / "home"))
    watch = Watch(ROOT)
    watch("open", (str(ROOT / "src" / "repro" / "__init__.py"), "r", 0))
    watch("open", (str(ROOT / "benchmarks" / "common.py"), "rb", 0))
    watch("open", (str(ROOT / "src" / "repro_torch" / "__init__.py"), "r", 0))
    watch("open", (str(tmp_path / "tmp" / "x"), "w", 0))
    watch("open", (str(ROOT / "build" / "x"), "w", 0))
    watch("open", ("/dev/shm/portbench-x", "w", 0))
    watch("open", (str(tmp_path / "elsewhere"), None, 0o101))
    assert len(watch.violations) == 4
    assert watch.violations[0].startswith("read") and \
        watch.violations[1].startswith("read")
    assert all(v.startswith("wrote") for v in watch.violations[2:])


def test_a_run_loads_nothing_of_jax_or_the_reference_package(tmp_path):
    """In a process of its own, as the benchmark runs: no module of jax or
    repro is loaded, and no file of benchmarks/ or src/repro/ is opened."""
    root = make_root(tmp_path / "root")
    (tmp_path / "tmp").mkdir()
    code = f"""
import sys
sys.path[:0] = [{str(ROOT / 'src')!r}, {str(ROOT)!r}]
from pathlib import Path
from portbench.run import Watch, foreign_modules, run_cell
from portbench.spec import Bench
watch = Watch(Path({str(ROOT)!r}))
sys.addaudithook(watch)
out = run_cell(Bench.load({str(root)!r}), "u.local", 3, 0.2, trace=True,
               device="cpu")
print(out["correct"], foreign_modules(), watch.violations)
"""
    env = {"PATH": "/usr/bin:/bin", "TMPDIR": str(tmp_path / "tmp"),
           "HOME": str(tmp_path), "USE_FLAX": "0", "OMP_NUM_THREADS": "2"}
    done = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, timeout=300, cwd=tmp_path)
    assert done.returncode == 0, done.stderr[-3000:]
    assert done.stdout.strip().splitlines()[-1] == "True [] []"


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_the_reference_imports_nothing_of_the_port_or_jax():
    for path in (HARNESS / "reference").glob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro",
                                     "repro_torch", "portbench"}, path


def test_the_harness_imports_neither_jax_nor_the_reference_package():
    for path in HARNESS.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


def test_every_metric_of_every_cell_has_a_reader_and_moves_what_it_reports():
    bench = Bench.load(ROOT)
    for cell in bench.spec["workloads"]:
        e2e = [m["name"] for m in bench.end_to_end(cell["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, cell["name"]
        layer = bench.per_layer(cell["name"])
        assert layer and all(m["moves"] in e2e for m in layer), cell["name"]
        for m in bench.end_to_end(cell["name"]) + layer:
            assert callable(bench.reader(m["name"]).read), m["name"]


def test_a_part_of_a_split_quantity_is_read_by_the_quantity_s_reader(tmp_path):
    bench = Bench.load(make_root(tmp_path))
    assert bench.reader("time_to_stop_s.any_kind").__file__ == \
        bench.reader("time_to_stop_s").__file__
    with pytest.raises(FileNotFoundError):
        bench.reader("no_such_metric")


def _run(queries, trace=None, start=0.0, setup=1.5, graph=None, lanes=64):
    return SimpleNamespace(queries=queries, trace=trace, window_start=start,
                           setup_s=setup, traffic={}, config={},
                           graph=graph or {"n": 1 << 20, "m_arcs": 33_000_000,
                                           "max_degree": 60})


def _metric(name):
    return Bench.load(ROOT).module("metrics", name).read


def test_end_to_end_readers():
    qs = [{"t_end": 2.0, "wall_s": 1.5, "tau": 4096},
          {"t_end": 3.0, "wall_s": 1.0, "tau": 8192}]
    run = _run(qs, start=0.5)
    assert _metric("time_to_stop_s")(run) == pytest.approx(1.25)
    assert _metric("samples_per_s")(run) == pytest.approx(12288 / 2.5)
    assert _metric("setup_s")(run) == 1.5
    assert _metric("time_to_stop_s")(_run([])) is None
    assert _metric("samples_per_s")(_run([])) is None


def test_counter_readers():
    qs = [{"preprocess_s": 0.05, "tau": 4096, "epochs": 2, "host_syncs": 60,
           "rounds": 4, "lanes": 1024, "bfs_launches_sampling": 28},
          {"preprocess_s": 0.07, "tau": 8192, "epochs": 3, "host_syncs": 90,
           "rounds": 8, "lanes": 1024, "bfs_launches_sampling": 50}]
    run = _run(qs)
    assert _metric("preprocess_ms")(run) == pytest.approx(60.0)
    assert _metric("samples_per_query")(run) == 6144
    assert _metric("host_syncs_per_epoch")(run) == 30
    assert _metric("bfs_levels_per_round")(run) == pytest.approx(78 / 12)
    # nothing to read: the reader says nothing, never 0
    for q in qs:
        q["bfs_launches_sampling"] = 0
    assert _metric("bfs_levels_per_round")(run) is None


def _trace(device, host, start=0, end=100):
    return TraceData(device, [(WINDOW, start, end, 1)] + host)


def test_busy_time_is_the_union_of_device_intervals():
    t = _trace([("a", 10, 30), ("b", 20, 40), ("c", 50, 60), ("d", 95, 120)],
               [("portbench.run_kadabra", 0, 100, 1), ("aten::mul", 40, 50, 1)])
    assert t.busy_s == pytest.approx(45e-9)
    assert t.window_s == pytest.approx(100e-9)
    run = _run([], trace=t)
    assert _metric("device_idle_pct")(run) == pytest.approx(55.0)
    gaps = dict(t.idle_gaps())
    assert gaps["portbench.run_kadabra: aten::mul"] == pytest.approx(10e-9)
    assert sum(gaps.values()) == pytest.approx(55e-9)
    assert dict(t.top_device_ops())["b"] == pytest.approx(20e-9)


def test_roofline_of_bfs_frontier():
    mod = Bench.load(ROOT).module("metrics", "bfs_frontier_roofline")
    n, m, lanes = 1 << 20, 33_000_000, 1024
    nbytes = 4 * (n + 1) + 4 * m + 8 * lanes * n
    assert mod.least_call_seconds(n, m, lanes) == pytest.approx(nbytes / 3.35e12)
    # device time of the sampling calls only: the kernel inside the
    # preprocess range is left out
    least = mod.least_call_seconds(n, m, lanes)
    t = _trace([("bfs_pull_kernel", 10, 10 + 4_000_000),
                ("bfs_pack_kernel", 4_000_010, 5_000_010),
                ("bfs_pull_kernel", 500, 600)],
               [("portbench.preprocess", 400, 700, 1)], end=10_000_000)
    run = _run([{"bfs_launches_sampling": 2, "lanes": lanes}], trace=t,
               graph={"n": n, "m_arcs": m, "max_degree": 60})
    assert mod.read(run) == pytest.approx(100 * 2 * least / 5e-3)
    assert mod.read(_run([{"bfs_launches_sampling": 2, "lanes": lanes}],
                         trace=_trace([], []))) is None
