"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points never carry on on the CPU unless asked to."""

import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"
EXAMPLES = SRC.parent / "examples"
ANALOGUES = ("quickstart_torch", "kadabra_bc_torch", "instances_demo_torch",
             "serve_adaptive_torch", "train_adaptive_torch",
             "elastic_restart_torch")

_PROGRAM = """
import sys
import repro_torch
from repro_torch.core.frames import FrameStrategy
from repro_torch.graphs import KadabraParams, erdos_renyi, run_kadabra
g = erdos_renyi(40, 100, seed=0, device="cpu")
b, res, pre = run_kadabra(g, KadabraParams(eps=0.1, batch=8), world=2,
                          strategy=FrameStrategy.SHARED_FRAME, device="cpu")
assert res.stopped and b.shape == (40,)
from repro_torch.core.instances import run_instance
est, res, built = run_instance("wrs", device="cpu")
assert res.stopped and abs(est[0] - built.oracle[0]) <= built.eps
from repro_torch.launch.serve import main
assert main(["--arch", "recurrentgemma-2b-reduced", "--device", "cpu",
             "--batch", "2", "--prompt-len", "8", "--gen", "4"]) == 0
assert main(["--arch", "recurrentgemma-2b-reduced", "--device", "cpu",
             "--adaptive-eval", "--eps", "2.0", "--batch", "2", "--seq", "8"]) == 0
assert main(["--arch", "falcon-mamba-7b-reduced", "--device", "cpu",
             "--batch", "2", "--prompt-len", "8", "--gen", "4"]) == 0
assert main(["--device", "cpu", "--batch", "2", "--prompt-len", "8",
             "--gen", "4"]) == 0
assert main(["--arch", "mixtral-8x22b-reduced", "--device", "cpu",
             "--batch", "2", "--prompt-len", "8", "--gen", "4"]) == 0
assert main(["--arch", "falcon-mamba-7b-reduced", "--device", "cpu",
             "--adaptive-eval", "--eps", "2.0", "--batch", "2", "--seq", "8"]) == 0
assert main(["--pool", "--device", "cpu", "--topology", "4",
             "--pressure-policy", "shrink-regrow",
             "--queries", "reachability:shared:4,wrs:local:2"]) == 0
import tempfile
from repro_torch.launch.train import main as train_main
with tempfile.TemporaryDirectory() as d:
    assert train_main(["--device", "cpu", "--steps", "2", "--batch", "4",
                       "--seq", "16", "--micro", "2", "--ckpt-dir", d]) == 0
    assert train_main(["--arch", "falcon-mamba-7b-reduced", "--device", "cpu",
                       "--steps", "1", "--batch", "2", "--seq", "8",
                       "--micro", "1", "--adaptive"]) == 0
import torch
from repro_torch.launch.spawn import RankPool, foreign_modules
from repro_torch.optim.compress import compress_on_rank, quantize_int8
from repro_torch.serve import AdaptiveSession, SessionSpec
from repro_torch.serve.ranks import make_groups
q, scale = quantize_int8(torch.randn(64), torch.Generator().manual_seed(0))
assert q.dtype == torch.int8 and float(scale) > 0
with RankPool(2, device="cpu") as ranks:
    s = AdaptiveSession.create(SessionSpec("wrs", "local", world=2,
                                           substrate="shard_map")).start()
    assert s.run().result()[1].stopped
    ranks.call(make_groups, (0, 1), 0)
    ranks.call(compress_on_rank, (0, 1), None, (64,))
    in_ranks = sorted(set(sum(ranks.call(foreign_modules), [])))
import numpy as np
from repro_torch.launch.dryrun import main as dryrun_main
from repro_torch.launch.pipeline import DecoderLayer, pipeline_rank
from repro_torch.launch.sharded import serve_rank
from repro_torch.models import resolve_config
with tempfile.TemporaryDirectory() as d:
    assert dryrun_main(["--arch", "h2o-danube-3-4b", "--shape", "decode_32k",
                        "--out", d]) == 0
    assert dryrun_main(["--arch", "qwen3-moe-235b-a22b", "--shape", "train_4k",
                        "--multipod", "--out", d]) == 0
cfg = resolve_config("smollm-360m-reduced")
with RankPool(2, device="cpu") as ranks:
    out = ranks.call(serve_rank, cfg.name, (1, 2), ("data", "model"), None, 0,
                     None, "float32", np.zeros((2, 8), np.int64),
                     np.zeros((2, 1), np.int64), 8)
    assert out[0]["prefill_logits"].shape == (2, cfg.padded_vocab)
    from repro_torch.models import Model
    m = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    stack = [{b: dict(lp[b].named_parameters()) for b in ("attn", "mlp")}
             for lp in m.layers]
    got = ranks.call(pipeline_rank, DecoderLayer(cfg), stack,
                     torch.ones((2, 1, 8, cfg.d_model), dtype=m.dtype))
    assert got[0][0].shape == (2, 1, 8, cfg.d_model)
    in_ranks += sorted(set(sum(ranks.call(foreign_modules), [])))
print("RANKS_LEAKED", in_ranks)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROGRAM], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert "\nLEAKED []" in out.stdout, out.stdout
    assert "RANKS_LEAKED []" in out.stdout, out.stdout


_EXAMPLES_PROGRAM = """
import importlib.util
import sys
import tempfile

import torch
torch.set_num_threads(1)  # beside the suite's parallel workers, as its ranks


def example(name):  # examples/<name>.py, from the directory in argv[1]
    spec = importlib.util.spec_from_file_location(name, f"{sys.argv[1]}/{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


assert example("quickstart_torch").main(["--device", "cpu"]) == 0
with tempfile.TemporaryDirectory() as d:
    assert example("train_adaptive_torch").main(
        ["--steps", "2", "--batch", "4", "--seq", "16", "--micro", "2",
         "--ckpt-dir", d, "--device", "cpu"]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""


def test_examples_import_no_jax_and_no_reference():
    """quickstart_torch and train_adaptive_torch, run at their CPU test
    sizes in a process of their own, import neither JAX nor the
    reference."""
    out = subprocess.run([sys.executable, "-c", _EXAMPLES_PROGRAM,
                          str(EXAMPLES)], capture_output=True, text=True,
                         timeout=300, env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert "\nLEAKED []" in out.stdout, out.stdout


def test_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    from repro_torch.core.frames import FrameStrategy
    from repro_torch.graphs import (KadabraParams, bfs_sssp, erdos_renyi,
                                    preprocess, run_kadabra)
    g = erdos_renyi(20, 40, seed=0, device="cpu")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        run_kadabra(g, KadabraParams(), strategy=FrameStrategy.LOCAL_FRAME)
    with pytest.raises(RuntimeError, match="CUDA"):
        preprocess(g, 0.1, 0.1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bfs_sssp(g, torch.tensor([0]), max_levels=4)
    with pytest.raises(RuntimeError, match="CUDA"):
        erdos_renyi(20, 40, seed=0)


def test_model_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """The model, the token stream, the weight converter and the serving
    CLI choose the card unless told otherwise; ``generate`` and
    ``adaptive_eval`` run where the model they are given lies."""
    import numpy as np

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.data import TokenStream
    from repro_torch.launch.serve import adaptive_eval, generate, main
    from repro_torch.models import Model, resolve_config
    cfg = resolve_config("recurrentgemma-2b-reduced")
    model = Model(cfg, device="cpu").init(torch.Generator().manual_seed(0))
    stream = TokenStream(vocab=cfg.vocab, seq_len=8, batch=2)
    prompts = stream.batch_at(0, device="cpu")["tokens"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        stream.batch_at(0)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_params_from_numpy(cfg, {"embed": np.zeros((2, 2), np.float32)})
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "recurrentgemma-2b-reduced"])
    with torch.inference_mode():
        assert generate(model, prompts, 2).device.type == "cpu"
        mean, res = adaptive_eval(model, stream, eps=5.0, delta=0.5)
    assert res.stopped and res.state.total.num.device.type == "cpu"


def test_mesh_entry_points_default_to_cuda_and_raise_without_it(monkeypatch):
    """The dry run's ``--execute`` and ``device_mesh`` choose the card
    unless told otherwise; the abstract dry run needs no device."""
    from repro_torch.launch.dryrun import main
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.specs import input_specs
    from repro_torch.models import SHAPES
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--execute", "--arch", "smollm-360m-reduced", "--shape",
              "prefill_32k"])
    kwargs, _, _, _ = input_specs("smollm-360m", SHAPES["decode_32k"],
                                  make_mesh((2, 2), ("data", "model")))
    assert {t.device.type for t in kwargs["cache"].values()} == {"meta"}


def test_ssm_model_defaults_to_cuda_and_raises_without_it(monkeypatch):
    """falcon-mamba: the model, the weight converter and the serving CLI
    choose the card unless told otherwise."""
    import numpy as np

    from repro_torch.convert import model_params_from_numpy
    from repro_torch.launch.serve import main
    from repro_torch.models import Model, resolve_config
    cfg = resolve_config("falcon-mamba-7b-reduced")
    assert Model(cfg, device="cpu").embed.device.type == "cpu"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Model(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        model_params_from_numpy(cfg, {"layers": {"D": np.ones((2, 4), np.float32)}})
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--arch", "falcon-mamba-7b-reduced"])


@pytest.mark.parametrize("name", ANALOGUES)
def test_examples_default_to_cuda_and_raise_without_it(monkeypatch, name):
    """Each example of the port, run without ``--device``, picks the card
    and raises without one: none of them quietly runs on the CPU."""
    import importlib.util

    import repro_torch.models.config as config
    monkeypatch.setitem(config._REGISTRY, "lm-100m", None)  # undone after
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        mod.main([])
