"""The port's examples (``examples/*_torch.py``) on the CPU against the
reference's examples and functions.

- quickstart: the graph bit-equal to the reference's, ω and the exact
  column equal to the reference's ``preprocess`` and ``brandes_exact``.
- kadabra_bc: the VD bound and ω equal to the reference's ``preprocess`` on
  the graph of the reference example's own ``build``; every strategy within
  ε of exact Brandes.
- instances_demo: each instance within its ε; the conformance sweep of one
  instance passes.
- serve_adaptive: the four flows, and a failed flow stops the example.
- train_adaptive: lm-100m field for field the reference example's, and a
  small adaptive run that checkpoints.

Each example is loaded from its file and run with ``--device cpu``; the
reference side is computed once per module, and lm-100m's registration in
both registries is undone when the module ends."""

import importlib.util
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np

EXAMPLES = Path(__file__).resolve().parents[1] / "examples"


def load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while the module runs: the examples make many
    small ops, which under the suite's parallel workers spent most of
    their time contending for cores (serve_adaptive 4.5 s alone, 220 s
    beside five busy workers)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def ex():
    """The port's five examples and the reference's kadabra_bc and
    train_adaptive, loaded with lm-100m's registrations undone at the end."""
    import repro.models.config as ref_config
    import repro_torch.models.config as port_config
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(ref_config._REGISTRY, "lm-100m", None)
        mp.setitem(port_config._REGISTRY, "lm-100m", None)
        yield {name: load(name) for name in (
            "quickstart_torch", "kadabra_bc_torch", "instances_demo_torch",
            "serve_adaptive_torch", "train_adaptive_torch", "kadabra_bc",
            "train_adaptive")}


@pytest.fixture(scope="module")
def ref_quickstart():
    """The reference's graph, ω and exact BC of the quickstart."""
    from repro.graphs import brandes_exact, erdos_renyi, preprocess
    g = erdos_renyi(n=200, m_edges=800, seed=7)
    return {"arrays": [np.asarray(a) for a in (g.indptr, g.indices_padded,
                                                g.src, g.dst)],
            "omega": preprocess(g, 0.05, 0.1).omega,
            "exact": brandes_exact(g)}


def test_quickstart_matches_the_reference(ex, ref_quickstart, capsys,
                                          monkeypatch):
    mod = ex["quickstart_torch"]
    graphs = []
    gen = mod.erdos_renyi
    monkeypatch.setattr(mod, "erdos_renyi",
                        lambda *a, **k: graphs.append(gen(*a, **k)) or graphs[-1])
    assert mod.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    g = graphs[0]
    for got, exp in zip((g.indptr, g.indices_padded, g.src, g.dst),
                        ref_quickstart["arrays"]):
        np.testing.assert_array_equal(got.numpy(), exp)
    omega = re.search(r"τ = \d+ samples \(ω cap was (\d+)\)", out)
    assert omega and omega.group(1) == f"{ref_quickstart['omega']:.0f}"
    assert re.search(r"max \|b̃ − b\| = \S+  \(ε = 0\.05\) OK$", out, re.M)
    exact = ref_quickstart["exact"]
    np.testing.assert_allclose(mod.brandes_exact(g), exact, rtol=0, atol=1e-6)
    rows = re.findall(r"^ +(\d+) +(\S+) +(\S+)$", out.split("top-10")[1], re.M)
    assert len(rows) == 10
    for v, _, col in rows:
        assert col == f"{exact[int(v)]:.5f}", (v, col)


@pytest.mark.parametrize("kind", ["er", "ba", "grid"])
def test_kadabra_bc_every_strategy_within_eps(ex, capsys, kind):
    from repro.graphs import preprocess
    eps = 0.1
    pre = preprocess(ex["kadabra_bc"].build(kind, 100, 0), eps, 0.1)
    assert ex["kadabra_bc_torch"].main(["--kind", kind, "--n", "100", "--eps",
                                        str(eps), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert f"preprocessing: VD ≤ {pre.vd_upper}, ω = {pre.omega:.0f} (" in out
    rows = re.findall(r"^ *(lock|barrier|local|shared|indexed) +(\d+) +(\d+) "
                      r"+(\d+) +(\S+) +\S+s$", out, re.M)
    assert [(r[0], r[1]) for r in rows] == [
        ("lock", "1"), ("barrier", "4"), ("local", "4"), ("shared", "4"),
        ("indexed", "4")]
    for r in rows:
        assert float(r[4]) <= eps, r


def test_kadabra_bc_build_refuses_an_unknown_kind(ex):
    with pytest.raises(ValueError, match="unknown kind"):
        ex["kadabra_bc_torch"].build("tree", 10, 0, "cpu")


@pytest.mark.parametrize("argv", [["--world", "2"],
                                  ["--strategy", "indexed", "--world", "4"]])
def test_instances_demo_each_instance_within_eps(ex, capsys, argv):
    from repro_torch.core.instances import available_instances
    assert ex["instances_demo_torch"].main([*argv, "--device", "cpu"]) == 0
    rows = re.findall(r"^([\w-]+) +\[\w+/W=\d\] .* err=(\S+) \(ε=(\S+)\)",
                      capsys.readouterr().out, re.M)
    assert sorted(r[0] for r in rows) == sorted(available_instances())
    assert len(rows) == 6
    for name, err, eps in rows:
        assert float(err) <= float(eps), name


def test_instances_demo_conformance_of_one_instance(ex, capsys):
    assert ex["instances_demo_torch"].main(
        ["--conformance", "--instance", "wrs", "--device", "cpu"]) == 0
    assert "conformance[wrs]: 15/15 cells ok" in capsys.readouterr().out


def test_serve_adaptive_runs_its_four_flows(ex, capsys):
    assert ex["serve_adaptive_torch"].main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    pools = out.split("[example] placement-aware pool")
    assert len(pools) == 2
    assert "[serve] pool drained: 2 queries" in pools[0]
    assert "[serve] pool drained: 2 queries" in pools[1].split("[example]")[0]
    assert re.search(r"\[serve\] tick \d+: shrunk \S+ W=2 → 1 \(pressure\)",
                     pools[1])
    assert "[serve] generated 64 tokens" in out
    assert "[serve] adaptive eval: mean loss = " in out


def test_serve_adaptive_stops_at_a_failed_flow(ex, capsys, monkeypatch):
    mod = ex["serve_adaptive_torch"]
    calls = []
    monkeypatch.setattr(mod.serve_mod, "main",
                        lambda argv: calls.append(argv) or (2 if len(calls) == 2 else 0))
    assert mod.main(["--device", "cpu"]) == 2
    out = capsys.readouterr().out
    assert len(calls) == 2 and "exit code 2" in out
    assert "batched greedy generation" not in out


def test_train_adaptive_lm_100m_is_the_reference_example_s(ex):
    import dataclasses
    port, ref = ex["train_adaptive_torch"].LM100M, ex["train_adaptive"].LM100M
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert port.param_count() == ref.param_count() == 124_667_904
    from repro_torch.models import resolve_config
    assert resolve_config("lm-100m") is port


def test_train_adaptive_small_run_checkpoints(ex, capsys, tmp_path):
    assert ex["train_adaptive_torch"].main(
        ["--steps", "2", "--batch", "4", "--seq", "16", "--micro", "2",
         "--ckpt-dir", str(tmp_path), "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "[example] lm-100m: 124.7M params" in out
    assert (tmp_path / "step_0000000002").is_dir()
    losses = [float(x) for x in re.findall(r"\[train\] step +\d+ loss=(\S+)", out)]
    micro = [int(x) for x in re.findall(r"micro=(\d+)", out)]
    assert len(losses) == 2 and all(math.isfinite(x) for x in losses)
    assert len(micro) == 2 and all(1 <= m <= 2 for m in micro)
