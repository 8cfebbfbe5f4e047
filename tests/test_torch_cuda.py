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
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import frame_accum as accum_mod
from repro_torch.kernels import rglru_scan as rglru_mod
from repro_torch.kernels import ssm_scan as ssm_mod
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



@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("b,h,kv,s,hd,window", [
    (1, 4, 2, 128, 64, 0),
    (2, 4, 4, 100, 32, 0),     # ragged S
    (1, 10, 1, 300, 256, 64),  # recurrentgemma's MQA heads, window
    (1, 2, 1, 200, 128, 33),
])
def test_flash_attention_kernel_on_card(cuda_device, dtype, tol, b, h, kv, s,
                                        hd, window):
    """Against the materialised plain version; the model's (B, S, H, hd)
    layout goes in as (B, H, S, hd) views."""
    gen = torch.Generator(device=cuda_device).manual_seed(s)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device).to(dtype)
               .transpose(1, 2) for shape in ((b, s, h, hd), (b, s, kv, hd),
                                              (b, s, kv, hd)))
    got = flash_mod.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, window=window),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("b,s,w", [(1, 64, 512), (2, 33, 1000), (2, 4096, 2560)])
def test_rglru_scan_kernel_on_card(cuda_device, b, s, w):
    """Exact: one FMA a step in both."""
    gen = torch.Generator(device=cuda_device).manual_seed(w)
    a = torch.rand((b, s, w), generator=gen, device=cuda_device) * 0.75 + 0.2
    bb = torch.randn((b, s, w), generator=gen, device=cuda_device)
    got = rglru_mod.rglru_scan(a, bb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rglru_scan_ref(a, bb))


@pytest.mark.parametrize("b,s,d,n", [(1, 64, 64, 8), (2, 33, 125, 3),
                                     (1, 4096, 8192, 16)])
def test_ssm_scan_kernel_on_card(cuda_device, b, s, d, n):
    """Exact: one FMA a step in both.  (2, 33, 125, 3) is ragged (D·N = 375);
    (1, 4096, 8192, 16) is one sequence of falcon-mamba-7b's prefill."""
    gen = torch.Generator(device=cuda_device).manual_seed(d * n)
    a = torch.rand((b, s, d, n), generator=gen, device=cuda_device) * 0.89 + 0.1
    bb = torch.randn((b, s, d, n), generator=gen, device=cuda_device)
    got = ssm_mod.ssm_scan(a, bb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.ssm_scan_ref(a, bb))
