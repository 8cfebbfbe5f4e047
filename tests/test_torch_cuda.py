"""On a CUDA card only: each CUDA kernel of the port against its plain
version.  This file imports neither JAX nor the reference, so that it runs
on a machine that has only PyTorch: ``python -m pytest -q -m cuda tests/``.
Without a card every test here skips."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.graphs import erdos_renyi
from repro_torch.kernels import alias_draw as alias_mod
from repro_torch.kernels import bfs_frontier as bfs_mod
from repro_torch.kernels import frame_accum as accum_mod
from repro_torch.kernels import ref
from repro_torch.sampling import build_alias_table

pytestmark = pytest.mark.cuda

INF = 0x3FFFFFFF


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
def test_frame_accum_kernel_on_card(cuda_device, dtype):
    x = (torch.arange(4 * 5000, device=cuda_device) % 97).reshape(4, 5000).to(dtype)
    got = accum_mod.frame_accum(x)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.frame_accum_ref(x), rtol=1e-6, atol=0.0)


def test_bfs_frontier_kernel_on_card(cuda_device):
    g = erdos_renyi(200, 600, seed=2, device=cuda_device)
    rng = np.random.default_rng(2)
    dist = rng.integers(0, 8, (4, 200)).astype(np.int32)
    dist[dist == 7] = INF
    sigma = rng.integers(1, 50, (4, 200)).astype(np.float32)
    s = torch.from_numpy(sigma).to(cuda_device)
    d = torch.from_numpy(dist).to(cuda_device)
    got = bfs_mod.bfs_frontier(g.indptr, g.indices_padded, s, d, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.bfs_frontier_ref(g.src, g.dst, s, d, 2),
                               rtol=1e-5, atol=0.0)


@pytest.mark.parametrize("n,b", [(1, 1), (1000, 4097), (1 << 16, 1 << 18)])
def test_alias_draw_kernel_on_card(cuda_device, n, b):
    """Exact, with the edge uniforms 0 and 1−2⁻²⁴ among the draws."""
    rng = np.random.default_rng(n)
    table = build_alias_table(rng.pareto(1.5, size=n) + 1e-3, device=cuda_device)
    u1 = rng.random(b, dtype=np.float32)
    u2 = rng.random(b, dtype=np.float32)
    edge = np.array([0.0, np.nextafter(np.float32(1), np.float32(0))], np.float32)
    k = min(b, 4)
    u1[:k], u2[:k] = edge[[0, 1, 0, 1]][:k], edge[[0, 0, 1, 1]][:k]
    u1, u2 = (torch.from_numpy(u).to(cuda_device) for u in (u1, u2))
    got = alias_mod.alias_draw(table.prob, table.alias, u1, u2)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.alias_draw_ref(table.prob, table.alias, u1, u2))

