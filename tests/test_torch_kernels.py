"""The port's kernels (plain versions on the CPU) against the JAX Pallas
kernels run in interpret mode, on the same numpy inputs, and the dispatch
by device.  The CUDA kernels against their plain versions on a card are in
``test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.graphs import erdos_renyi as jax_erdos_renyi
from repro.kernels import ref as jax_ref
from repro.kernels.bfs_frontier import bfs_frontier as jax_bfs_frontier
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.frame_accum import frame_accum as jax_frame_accum
from repro.kernels.rglru_scan import rglru_scan as jax_rglru_scan
from repro.kernels.ssm_scan import ssm_scan as jax_ssm_scan
from repro.models.ssm import linear_scan as jax_linear_scan
from repro_torch.kernels import bfs_frontier as bfs_mod
from repro_torch.kernels import build, ops, ref
from repro_torch.kernels import flash_attention as flash_mod
from repro_torch.kernels import frame_accum as accum_mod
from repro_torch.kernels import rglru_scan as rglru_mod
from repro_torch.kernels import ssm_scan as ssm_mod

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


def _pack_numpy(sigma, dist, level):
    """The frontier bits and rank-packed σ, one (vertex, lane) at a time."""
    lanes, n = sigma.shape
    groups = (lanes + 31) // 32
    front = np.zeros((n, groups), np.uint32)
    sigp = np.zeros((n, groups, 32), np.float32)
    for u in range(n):
        for g in range(groups):
            r = 0
            for i in range(32):
                b = 32 * g + i
                if b < lanes and dist[b, u] == level:
                    front[u, g] |= np.uint32(1 << i)
                    sigp[u, g, r] = sigma[b, u]
                    r += 1
    return front.view(np.int32), sigp


@pytest.mark.parametrize("lanes,n,level", [(1, 5, 0), (7, 40, 2), (33, 50, 1),
                                           (64, 30, 3), (70, 21, 9)])
def test_frontier_pack_ref_matches_numpy(lanes, n, level):
    rng = np.random.default_rng(lanes + n)
    dist = rng.integers(0, 4, (lanes, n)).astype(np.int32)
    dist[:, :3] = level                       # full words: bit 31 set
    sigma = rng.random((lanes, n), dtype=np.float32)
    front, sigp = ref.frontier_pack_ref(torch.from_numpy(sigma),
                                        torch.from_numpy(dist), level)
    exp_front, exp_sigp = _pack_numpy(sigma, dist, level)
    assert front.dtype == torch.int32 and sigp.dtype == torch.float32
    np.testing.assert_array_equal(front.numpy(), exp_front)
    np.testing.assert_array_equal(sigp.numpy(), exp_sigp)


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


def _qkv(b, h, kv, s, hd, dtype, seed):
    """q (b, h, s, hd), k and v (b, kv, s, hd) from numpy, for both sides."""
    rng = np.random.default_rng(seed)
    arrays = [rng.standard_normal(shape).astype(np.float32)
              for shape in ((b, h, s, hd), (b, kv, s, hd), (b, kv, s, hd))]
    jdt, tdt = {"float32": (jnp.float32, torch.float32),
                "bfloat16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    return ([jnp.asarray(a).astype(jdt) for a in arrays],
            [torch.from_numpy(a).to(tdt) for a in arrays])


FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("b,h,kv,s,hd,window", [
    (1, 4, 2, 128, 64, 0),
    (2, 4, 4, 256, 32, 0),     # MHA (kv = h)
    (1, 8, 1, 128, 64, 0),     # MQA
    (1, 4, 2, 256, 64, 64),    # sliding window
])
def test_flash_attention_ref_matches_pallas(dtype, b, h, kv, s, hd, window):
    """The sweep of tests/test_kernels.py; tolerance as there (f32: other
    summation order; bf16: one rounding of the f32 output)."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(b, h, kv, s, hd, dtype, seed=s + h)
    exp = jax_flash_attention(qj, kj, vj, window=window, block_q=64, block_k=64,
                              interpret=True)
    got = ref.flash_attention_ref(qt, kt, vt, window=window)
    assert got.dtype == qt.dtype and got.shape == qt.shape
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [0, 32])
def test_flash_attention_ref_ragged_s_matches_reference_oracle(dtype, window):
    """S = 100, not a multiple of any tile, against the reference's own
    plain version (its Pallas kernel asserts S % block == 0)."""
    (qj, kj, vj), (qt, kt, vt) = _qkv(2, 10, 1, 100, 32, dtype, seed=100)
    exp = jax_ref.flash_attention_ref(qj, kj, vj, window=window)
    got = ops.flash_attention(qt, kt, vt, window=window)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(exp, np.float32),
                               rtol=FLASH_TOL[dtype], atol=FLASH_TOL[dtype])


def test_flash_attention_takes_the_models_layout_as_views():
    """The model passes (B, S, H, hd) projections as (B, H, S, hd) views."""
    _, (q, k, v) = _qkv(2, 4, 2, 40, 32, "float32", seed=7)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    assert torch.equal(ops.flash_attention(*views, window=8),
                       ops.flash_attention(q, k, v, window=8))


def _scan_inputs(b, s, w, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.2, 0.95, (b, s, w)).astype(np.float32)
    bb = rng.standard_normal((b, s, w)).astype(np.float32)
    return a, bb


@pytest.mark.parametrize("b,s,w", [(1, 64, 512), (2, 33, 1024)])
def test_rglru_scan_ref_matches_pallas_exactly(b, s, w):
    """The Pallas body is the same sequential recurrence: bit-equal."""
    a, bb = _scan_inputs(b, s, w, seed=w)
    exp = np.asarray(jax_rglru_scan(jnp.asarray(a), jnp.asarray(bb), block_w=256,
                                    interpret=True))
    got = ref.rglru_scan_ref(torch.from_numpy(a), torch.from_numpy(bb))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("b,s,w", [(1, 64, 512), (2, 33, 1024), (2, 100, 64)])
def test_rglru_scan_ref_matches_linear_scan(b, s, w):
    """The reference's linear_scan is an associative scan, rounding in
    another order: allclose 1e-5."""
    a, bb = _scan_inputs(b, s, w, seed=s)
    exp = np.asarray(jax_linear_scan(jnp.asarray(a), jnp.asarray(bb), axis=1))
    got = ops.rglru_scan(torch.from_numpy(a), torch.from_numpy(bb))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


def test_model_kernel_ops_on_cpu_use_ref_and_never_build(monkeypatch):
    def no_build(name):
        raise AssertionError(f"build.load({name!r}) called for a CPU tensor")
    monkeypatch.setattr(build, "load", no_build)
    before = (flash_mod.launches, rglru_mod.launches)
    _, (q, k, v) = _qkv(1, 2, 1, 16, 32, "float32", seed=1)
    assert torch.equal(ops.flash_attention(q, k, v, window=4),
                       ref.flash_attention_ref(q, k, v, window=4))
    a, bb = (torch.from_numpy(x) for x in _scan_inputs(1, 8, 16, seed=1))
    assert torch.equal(ops.rglru_scan(a, bb), ref.rglru_scan_ref(a, bb))
    assert (flash_mod.launches, rglru_mod.launches) == before


def test_model_kernel_wrappers_refuse_cpu_tensors(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("built"))
    z = torch.zeros((1, 2, 8, 32))
    with pytest.raises(ValueError, match="CUDA"):
        flash_mod.flash_attention(z, z[:, :1], z[:, :1])
    with pytest.raises(ValueError, match="CUDA"):
        rglru_mod.rglru_scan(torch.zeros(1, 4, 8), torch.zeros(1, 4, 8))


def _ssm_inputs(b, s, d, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0.1, 0.99, (b, s, d, n)).astype(np.float32)
    bb = rng.standard_normal((b, s, d, n)).astype(np.float32)
    return a, bb


SSM_SWEEP = [(1, 32, 64, 4), (2, 128, 256, 16), (1, 17, 64, 8)]


@pytest.mark.parametrize("b,s,d,n", SSM_SWEEP)
def test_ssm_scan_ref_matches_pallas_exactly(b, s, d, n):
    """The sweep of tests/test_kernels.py.  The Pallas body is the same
    sequential recurrence, and XLA contracts its ``a * h + b`` into an FMA
    as the plain version computes it: bit-equal."""
    a, bb = _ssm_inputs(b, s, d, n, seed=s)
    exp = np.asarray(jax_ssm_scan(jnp.asarray(a), jnp.asarray(bb), block_d=64,
                                  interpret=True))
    got = ref.ssm_scan_ref(torch.from_numpy(a), torch.from_numpy(bb))
    assert got.dtype == torch.float32 and got.shape == a.shape
    np.testing.assert_array_equal(got.numpy(), exp)


@pytest.mark.parametrize("b,s,d,n", SSM_SWEEP + [(2, 33, 125, 3)])
def test_ssm_scan_ref_matches_linear_scan(b, s, d, n):
    """The reference's ``ssm_scan_ref`` is its associative ``linear_scan``,
    rounding in another order: allclose 1e-5.  (2, 33, 125, 3) is ragged:
    D·N = 375 is no multiple of a block."""
    a, bb = _ssm_inputs(b, s, d, n, seed=d)
    exp = np.asarray(jax_ref.ssm_scan_ref(jnp.asarray(a), jnp.asarray(bb)))
    got = ops.ssm_scan(torch.from_numpy(a), torch.from_numpy(bb))
    np.testing.assert_allclose(got.numpy(), exp, rtol=1e-5, atol=1e-5)


def test_ssm_scan_op_on_cpu_uses_ref_and_never_builds(monkeypatch):
    def no_build(name):
        raise AssertionError(f"build.load({name!r}) called for a CPU tensor")
    monkeypatch.setattr(build, "load", no_build)
    before = ssm_mod.launches
    a, bb = (torch.from_numpy(x) for x in _ssm_inputs(2, 9, 5, 3, seed=1))
    assert torch.equal(ops.ssm_scan(a, bb), ref.ssm_scan_ref(a, bb))
    assert ssm_mod.launches == before


def test_ssm_scan_wrapper_refuses_cpu_tensors(monkeypatch):
    monkeypatch.setattr(build, "load", lambda name: pytest.fail("built"))
    with pytest.raises(ValueError, match="CUDA"):
        ssm_mod.ssm_scan(torch.zeros(1, 4, 8, 2), torch.zeros(1, 4, 8, 2))
    assert "ssm_scan" in build.SIGNATURES
