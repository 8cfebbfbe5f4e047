"""The port's kernels (plain versions on the CPU) against the JAX Pallas
kernels run in interpret mode, on the same numpy inputs, and the dispatch
by device.  The CUDA kernels against their plain versions on a card are in
``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.graphs import erdos_renyi as jax_erdos_renyi
from repro.kernels.bfs_frontier import bfs_frontier as jax_bfs_frontier
from repro.kernels.frame_accum import frame_accum as jax_frame_accum
from repro_torch.kernels import bfs_frontier as bfs_mod
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import frame_accum as accum_mod

INF = 0x3FFFFFFF


def _frames(dtype, w, n):
    rng = np.random.default_rng(w * n)
    if dtype == "int32":
        x = rng.integers(0, 100, (w, n)).astype(np.int32)
        return jnp.asarray(x), torch.from_numpy(x)
    x = rng.standard_normal((w, n)).astype(np.float32)
    if dtype == "bfloat16":
        return jnp.asarray(x).astype(jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    return jnp.asarray(x), torch.from_numpy(x)


@pytest.mark.parametrize("dtype", ["int32", "float32", "bfloat16"])
@pytest.mark.parametrize("w,n", [(1, 64), (4, 1000), (16, 257), (3, 8192)])
def test_frame_accum_matches_pallas(dtype, w, n):
    xj, xt = _frames(dtype, w, n)
    exp = np.asarray(jax_frame_accum(xj, block_n=256, interpret=True), np.float32)
    got = ref.frame_accum_ref(xt)
    assert got.dtype == xt.dtype and got.shape == (n,)
    got = got.float().numpy()
    if dtype == "int32":
        np.testing.assert_array_equal(got, exp)
    else:  # f32: sums in another order; bf16: one rounding of the f32 sum
        np.testing.assert_allclose(got, exp,
                                   rtol=2e-2 if dtype == "bfloat16" else 1e-6)


def _bfs_state(n, m, lanes, seed):
    """A graph (as the reference builds it) and BFS-like lane states: dist
    levels 0..6 or INF, σ ≥ 1 — made with numpy."""
    g = jax_erdos_renyi(n, m, seed=seed)
    rng = np.random.default_rng(seed)
    dist = rng.integers(0, 8, (lanes, n)).astype(np.int32)
    dist[dist == 7] = INF
    sigma = rng.integers(1, 50, (lanes, n)).astype(np.float32)
    return g, dist, sigma


@pytest.mark.parametrize("n,m", [(50, 120), (200, 600)])
def test_bfs_frontier_matches_pallas_lane_by_lane(n, m):
    g, dist, sigma = _bfs_state(n, m, lanes=3, seed=n)
    src, dst = np.array(g.src), np.array(g.dst)
    for level in (0, 2, 5):
        got = ref.bfs_frontier_ref(torch.from_numpy(src), torch.from_numpy(dst),
                                   torch.from_numpy(sigma), torch.from_numpy(dist),
                                   level).numpy()
        assert got.shape == (3, n) and got.dtype == np.float32
        for b in range(3):
            exp = jax_bfs_frontier(jnp.asarray(src), jnp.asarray(dst),
                                   jnp.asarray(sigma[b]), jnp.asarray(dist[b]),
                                   jnp.int32(level), block_e=128, interpret=True)
            np.testing.assert_allclose(got[b], np.asarray(exp), rtol=1e-5, atol=1e-5)


def test_ops_on_cpu_use_ref_and_never_build(monkeypatch):
    def no_build(name):
        raise AssertionError(f"build.load({name!r}) called for a CPU tensor")
    monkeypatch.setattr(build, "load", no_build)
    before = (accum_mod.launches, bfs_mod.launches)
    x = torch.arange(12, dtype=torch.int32).reshape(3, 4)
    assert torch.equal(ops.frame_accum(x), ref.frame_accum_ref(x))
    g, dist, sigma = _bfs_state(50, 120, lanes=2, seed=1)
    args = [torch.from_numpy(np.array(a)) for a in
            (g.indptr, g.indices_padded, g.src, g.dst)]
    got = ops.bfs_frontier(*args, torch.from_numpy(sigma), torch.from_numpy(dist), 2)
    exp = ref.bfs_frontier_ref(args[2], args[3], torch.from_numpy(sigma),
                               torch.from_numpy(dist), 2)
    assert torch.equal(got, exp)
    assert (accum_mod.launches, bfs_mod.launches) == before


def test_kernel_wrappers_refuse_cpu_tensors(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("built"))
    with pytest.raises(ValueError, match="CUDA"):
        accum_mod.frame_accum(torch.zeros((2, 8), dtype=torch.int32))
    z = torch.zeros(4, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bfs_mod.bfs_frontier(z, z, torch.zeros((1, 3)),
                             torch.zeros((1, 3), dtype=torch.int32), 0)
