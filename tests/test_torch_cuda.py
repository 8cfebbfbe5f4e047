"""On a CUDA card only: each CUDA kernel of the port against its plain
version.  This file imports neither JAX nor the reference, so that it runs
on a machine that has only PyTorch: ``python -m pytest -q -m cuda tests/``.
Without a card every test here skips."""

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.graphs import bfs_sssp, erdos_renyi, from_edges
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


def _left_to_right_sum(x):
    """The sum over W in the order w = 0, 1, …, W − 1 from 0: int32 in
    int32, f32 in f32, bf16 in f32 rounded once to bf16."""
    acc_dtype = torch.int32 if x.dtype == torch.int32 else torch.float32
    acc = torch.zeros(x.shape[1], dtype=acc_dtype, device=x.device)
    for w in range(x.shape[0]):
        acc = acc + x[w].to(acc_dtype)
    return acc.to(x.dtype)


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("w", [1, 2, 3, 4, 8, 16])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32, torch.bfloat16])
def test_frame_accum_is_the_left_to_right_sum_on_card(cuda_device, dtype, w,
                                                      offset):
    """Bit-equal to the left-to-right sum at W below, at and above the
    loop's unroll depth of 4, at n below a vector, ragged (element-wise
    body) and 2²² (16-byte vectors), on fresh tensors and on
    contiguous views one element into their storage (as
    ``core/frames.py``'s ``.contiguous()`` reshapes may be), which are not
    16-byte aligned and take the element-wise body."""
    gen = torch.Generator(device=cuda_device).manual_seed(w)
    for n in (1, 3, 31, 1000, 4097, 2 ** 20 + 3, 2 ** 22):
        if dtype == torch.int32:
            x = torch.randint(-1000, 1000, (w, n), generator=gen,
                              device=cuda_device, dtype=dtype)
        else:
            x = torch.randn((w, n), generator=gen, device=cuda_device).to(dtype)
        if offset:
            buf = torch.empty(w * n + offset, dtype=dtype, device=cuda_device)
            buf[offset:] = x.reshape(-1)
            x = buf[offset:].view(w, n)
            assert x.is_contiguous() and x.data_ptr() % 16 != 0
        got = accum_mod.frame_accum(x)
        torch.cuda.synchronize()
        assert got.dtype == dtype and got.shape == (n,)
        assert torch.equal(got, _left_to_right_sum(x)), (w, n)


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


def _hub_graph(n, device):
    """Vertex 0 joined to every third vertex (the max degree), a sparse ER
    tail among the others, and vertices n − 5 … n − 1 isolated."""
    rng = np.random.default_rng(n)
    others = np.arange(1, n - 5, 3)
    hub = np.stack([np.zeros_like(others), others], 1)
    tail = rng.integers(1, n - 5, (2 * n, 2))
    return from_edges(n, np.concatenate([hub, tail]), device=device)


def _assert_bfs_close(g, sigma, dist, level):
    got = bfs_mod.bfs_frontier(g.indptr, g.indices_padded, sigma, dist, level)
    exp = ref.bfs_frontier_ref(g.src, g.dst, sigma, dist, level)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, exp, rtol=1e-5, atol=0.0)
    assert torch.equal(got > 0, exp > 0)
    return got


@pytest.mark.parametrize("lanes,graph", [(1, "er"), (33, "er"), (45, "hub"),
                                         (100, "hub")])
def test_bfs_frontier_levels_of_a_real_bfs_on_card(cuda_device, lanes, graph):
    """Levels 0–5 of a BFS from random sources (B and n not multiples of
    32, isolated vertices, a hub at the max degree), then an empty
    frontier (level 40)."""
    n = 3001
    g = (erdos_renyi(n, 4 * n, seed=lanes, device=cuda_device) if graph == "er"
         else _hub_graph(n, cuda_device))
    src = torch.from_numpy(np.random.default_rng(lanes).integers(0, n, lanes)).to(cuda_device)
    for level in range(6):
        dist, sigma = bfs_sssp(g, src, None, max_levels=level, early_exit=False,
                               device=cuda_device)
        _assert_bfs_close(g, sigma, dist, level)
    agg = _assert_bfs_close(g, sigma, dist, 40)
    assert not agg.any()


def test_bfs_frontier_lanes_are_independent_on_card(cuda_device):
    """Each lane run alone is bit-equal to its row of the batch (INDEXED
    bit-identity for every W rests on it), and two runs are bit-equal."""
    g = _hub_graph(2500, cuda_device)
    src = torch.from_numpy(np.random.default_rng(7).integers(0, 2500, 41)).to(cuda_device)
    dist, sigma = bfs_sssp(g, src, None, max_levels=3, early_exit=False,
                           device=cuda_device)
    batch = bfs_mod.bfs_frontier(g.indptr, g.indices_padded, sigma, dist, 3)
    assert torch.equal(batch, bfs_mod.bfs_frontier(g.indptr, g.indices_padded,
                                                   sigma, dist, 3))
    for b in (0, 1, 31, 32, 40):
        alone = bfs_mod.bfs_frontier(g.indptr, g.indices_padded,
                                     sigma[b:b + 1].contiguous(),
                                     dist[b:b + 1].contiguous(), 3)
        assert torch.equal(alone[0], batch[b])


def _edge_uniforms(rng, b):
    """u1, u2 (b,) f32 with the edge uniforms 0 and 1−2⁻²⁴ in every
    combination at the front."""
    u1 = rng.random(b, dtype=np.float32)
    u2 = rng.random(b, dtype=np.float32)
    edge = np.array([0.0, np.nextafter(np.float32(1), np.float32(0))], np.float32)
    k = min(b, 4)
    u1[:k], u2[:k] = edge[[0, 1, 0, 1]][:k], edge[[0, 0, 1, 1]][:k]
    return u1, u2


def _assert_alias_exact(prob, alias, u1, u2):
    got = alias_mod.alias_draw(prob, alias, u1, u2)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.alias_draw_ref(prob, alias, u1, u2))


@pytest.mark.parametrize("n,b", [(1, 1), (1000, 4097), (1 << 16, 1 << 18),
                                 (1000, 262_147)])
def test_alias_draw_kernel_on_card(cuda_device, n, b):
    """Exact, with the edge uniforms 0 and 1−2⁻²⁴ among the draws; 262,147
    draws are not a whole number of float4s or of 128-draw warp tiles."""
    rng = np.random.default_rng(n)
    table = build_alias_table(rng.pareto(1.5, size=n) + 1e-3, device=cuda_device)
    u1, u2 = (torch.from_numpy(u).to(cuda_device) for u in _edge_uniforms(rng, b))
    _assert_alias_exact(table.prob, table.alias, u1, u2)


@pytest.mark.parametrize("b", [1, 5, 4099, 262_144])
def test_alias_draw_kernel_on_unaligned_views_on_card(cuda_device, b):
    """u1 and u2 as ``buf[1:]`` views, 4-byte but not 16-byte aligned: the
    kernel takes its scalar-load body, exact all the same."""
    rng = np.random.default_rng(b)
    table = build_alias_table(rng.pareto(1.5, size=1000) + 1e-3,
                              device=cuda_device)
    u1, u2 = _edge_uniforms(rng, b)
    bufs = [torch.zeros(b + 1, dtype=torch.float32, device=cuda_device)
            for _ in range(2)]
    for buf, u in zip(bufs, (u1, u2)):
        buf[1:] = torch.from_numpy(u).to(cuda_device)
    u1, u2 = bufs[0][1:], bufs[1][1:]
    assert u1.data_ptr() % 16 != 0 and u1.is_contiguous()
    _assert_alias_exact(table.prob, table.alias, u1, u2)


def test_alias_draw_kernel_on_the_wrs_table_size_on_card(cuda_device):
    """n = 2²⁴ buckets (the wrs path's 128 MB table, larger than L2) and
    262,144 draws (its W·batch).  A random valid table: the draw does not
    depend on how the table was built."""
    n, b = 1 << 24, 262_144
    gen = torch.Generator(device=cuda_device).manual_seed(24)
    prob = torch.rand(n, generator=gen, device=cuda_device)
    alias = torch.randint(0, n, (n,), generator=gen, device=cuda_device,
                          dtype=torch.int32)
    u1, u2 = (torch.from_numpy(u).to(cuda_device)
              for u in _edge_uniforms(np.random.default_rng(24), b))
    _assert_alias_exact(prob, alias, u1, u2)



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


def _rglru_inputs(shape, device, seed):
    gen = torch.Generator(device=device).manual_seed(seed)
    a = torch.rand(shape, generator=gen, device=device) * 0.75 + 0.2
    return a, torch.randn(shape, generator=gen, device=device)


@pytest.mark.parametrize("b,s,w", [(1, 64, 512), (2, 33, 1000), (2, 4096, 2560),
                                   (1, 7, 1001), (2, 1, 2560), (2, 4097, 48),
                                   (4, 64, 2560)])
def test_rglru_scan_kernel_on_card(cuda_device, b, s, w):
    """Exact: one FMA a step in both.  The prefill's (2, 4096, 2560) and
    adaptive_eval's (4, 64, 2560); W = 1000 ends in a part group of
    channels; W = 1001 rows are not 16-byte multiples (the 4-byte body);
    S = 1 and S = 4097 end in a part stage."""
    a, bb = _rglru_inputs((b, s, w), cuda_device, seed=w)
    got = rglru_mod.rglru_scan(a, bb)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rglru_scan_ref(a, bb))


def test_rglru_scan_kernel_on_unaligned_views_on_card(cuda_device):
    """a and b as ``buf[1:]`` views, contiguous but not 16-byte aligned,
    with W a multiple of 4: the 4-byte body, exact."""
    shape = (2, 70, 64)
    a, bb = _rglru_inputs(shape, cuda_device, seed=70)
    views = []
    for x in (a, bb):
        buf = torch.empty(x.numel() + 1, device=cuda_device)
        buf[1:] = x.reshape(-1)
        views.append(buf[1:].view(shape))
    assert views[0].data_ptr() % 16 != 0 and views[0].is_contiguous()
    got = rglru_mod.rglru_scan(*views)
    torch.cuda.synchronize()
    assert torch.equal(got, ref.rglru_scan_ref(a, bb))


def test_rglru_scan_batch_rows_are_independent_on_card(cuda_device):
    """Each batch row run alone is bit-equal to its row of the batch, and
    two runs are bit-equal."""
    a, bb = _rglru_inputs((3, 200, 2560), cuda_device, seed=3)
    batch = rglru_mod.rglru_scan(a, bb)
    assert torch.equal(batch, rglru_mod.rglru_scan(a, bb))
    for i in range(3):
        alone = rglru_mod.rglru_scan(a[i:i + 1].contiguous(),
                                     bb[i:i + 1].contiguous())
        assert torch.equal(alone[0], batch[i])


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


@pytest.mark.parametrize("window", [0, 33, 2048])
@pytest.mark.parametrize("group", [1, 2, 10])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 100, 4096])
@pytest.mark.parametrize("hd", flash_mod.HEAD_DIMS)
def test_flash_attention_bf16_tensor_cores_on_card(cuda_device, hd, s, group,
                                                   window):
    """The bf16 tensor-core body at every head dim, ragged and whole tiles,
    MHA / GQA / recurrentgemma's 10-on-1, with and without a window, on the
    model's (B, S, H, hd) layout as views; the bf16 tolerance unchanged."""
    b = 1 if s == 4096 else 2
    kv = 1 if group == 10 else 2
    gen = torch.Generator(device=cuda_device).manual_seed(hd * s + group)
    q, k, v = (torch.randn(shape, generator=gen, device=cuda_device)
               .to(torch.bfloat16).transpose(1, 2)
               for shape in ((b, s, kv * group, hd), (b, s, kv, hd), (b, s, kv, hd)))
    got = flash_mod.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, window=window),
                               rtol=2e-2, atol=2e-2)


def test_flash_attention_bf16_refuses_unaligned_views(cuda_device):
    x = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device=cuda_device)
    q = x[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="16-byte"):
        flash_mod.flash_attention(q, q[:, :1], q[:, :1])


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("window", [0, 33, 2048])
@pytest.mark.parametrize("group", [1, 2, 10])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 100, 4096])
@pytest.mark.parametrize("hd", flash_mod.HEAD_DIMS)
def test_flash_attention_f32_on_card(cuda_device, hd, s, group, window, offset):
    """The f32 body at every head dim, ragged and whole tiles, MHA / GQA /
    recurrentgemma's 10-on-1, with and without a window, on the model's
    (B, S, H, hd) layout as views; offset 1 puts each view one float into
    its storage, so no pointer is 16-byte aligned and the body takes its
    4-byte copies.  The f32 tolerance unchanged."""
    b = 1 if s == 4096 else 2
    kv = 1 if group == 10 else 2
    gen = torch.Generator(device=cuda_device).manual_seed(hd * s + group)
    views = []
    for heads in (kv * group, kv, kv):
        x = torch.randn((b, s, heads, hd), generator=gen, device=cuda_device)
        buf = torch.empty(x.numel() + offset, device=cuda_device)
        buf[offset:] = x.reshape(-1)
        views.append(buf[offset:].view(x.shape).transpose(1, 2))
    q, k, v = views
    assert (q.data_ptr() % 16 != 0) == bool(offset)
    got = flash_mod.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, window=window),
                               rtol=1e-5, atol=1e-5)


# -------------------------------------------- the shard_map substrate


def _equivalence(worlds, backend, instances):
    from repro_torch.core.conformance import run_substrate_equivalence_all
    from repro_torch.core.frames import FrameStrategy
    return run_substrate_equivalence_all(
        instances, worlds=worlds, backend=backend, device="cuda",
        strategies=list(FrameStrategy), require_all=True)


def test_shard_map_world_1_over_nccl_equals_vmap_on_card(cuda_device):
    """One NCCL rank on the card: every strategy's τ, trimmed data and
    estimate equal VMAP's and SEQUENTIAL's at W = 1."""
    for rep in _equivalence((1,), "nccl", ("kadabra", "wrs")).values():
        assert rep.ok, rep.summary()
        assert all(set(c.ran) == {"sequential", "vmap", "shard_map"}
                   for c in rep.cells)


def test_shard_map_two_gloo_ranks_on_one_card_equal_vmap(cuda_device):
    """Two gloo ranks sharing the card (NCCL puts one rank on each card):
    every strategy at W = 2, and SHARED F = 1, equal VMAP's."""
    reps = _equivalence((2,), "gloo", ("kadabra", "wrs"))
    for rep in reps.values():
        assert rep.ok, rep.summary()
        assert all("shard_map" in c.ran for c in rep.cells)
        assert len(rep.cells) == 6
