"""The port stands alone: it imports neither JAX nor the reference package,
and its entry points never carry on on the CPU unless asked to."""

import pytest

torch = pytest.importorskip("torch")

import os
import subprocess
import sys
from pathlib import Path

SRC = Path(__file__).resolve().parents[1] / "src"

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
assert main(["--arch", "falcon-mamba-7b-reduced", "--device", "cpu",
             "--adaptive-eval", "--eps", "2.0", "--batch", "2", "--seq", "8"]) == 0
assert main(["--pool", "--device", "cpu", "--topology", "4",
             "--pressure-policy", "shrink-regrow",
             "--queries", "reachability:shared:4,wrs:local:2"]) == 0
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LEAKED", bad)
"""


def test_port_imports_no_jax_and_no_reference():
    out = subprocess.run([sys.executable, "-c", _PROGRAM], capture_output=True,
                         text=True, timeout=300,
                         env={**os.environ, "PYTHONPATH": str(SRC)})
    assert out.returncode == 0, out.stderr
    assert "LEAKED []" in out.stdout, out.stdout


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
