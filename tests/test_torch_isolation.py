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
