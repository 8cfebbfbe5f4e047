"""On a CUDA card only: each CUDA kernel of the port against its plain
version.  This file imports neither JAX nor the reference, so that it runs
on a machine that has only PyTorch: ``python -m pytest -q -m cuda tests/``.
Without a card every test here skips."""

import ctypes

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch.graphs import bfs_sssp, erdos_renyi, from_edges
from repro_torch.kernels import alias_draw as alias_mod
from repro_torch.kernels import build
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
@pytest.mark.parametrize("hd", flash_mod.PADDED_HEAD_DIMS)
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
    """One bf16 element into its storage: no 4-byte copy fits."""
    x = torch.zeros(2 * 64 * 64 + 1, dtype=torch.bfloat16, device=cuda_device)
    q = x[1:].view(1, 2, 64, 64)
    with pytest.raises(ValueError, match="4 bytes"):
        flash_mod.flash_attention(q, q[:, :1], q[:, :1])


def _flash_views(device, b, s, h, kv, hd, dtype, seed, offset=0):
    """q, k, v in the model's (B, S, heads, hd) memory as (B, heads, S, hd)
    views, so the position stride is heads·hd; ``offset`` elements into
    their storage."""
    gen = torch.Generator(device=device).manual_seed(seed)
    views = []
    for heads in (h, kv, kv):
        x = torch.randn((b, s, heads, hd), generator=gen, device=device).to(dtype)
        buf = torch.empty(x.numel() + offset, dtype=dtype, device=device)
        buf[offset:] = x.reshape(-1)
        views.append(buf[offset:].view(x.shape).transpose(1, 2))
    return views


FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 40])
@pytest.mark.parametrize("group", [1, 3, 4, 8])
@pytest.mark.parametrize("s", [1, 100, 130])
@pytest.mark.parametrize("hd", [16, 20, 48, 80, 96, 120, 128])
def test_flash_attention_any_head_dim_on_card(cuda_device, hd, s, group,
                                              window, dtype):
    """Head dims that run in a padded body (20 as 32, 48 and 80 as 64 and
    128, 96 and 120 as 128) and the padded ones themselves, ragged S, GQA
    groups 1, 3, 4 and 8, with and without a window; the scale is 1/√hd."""
    kv = 2
    q, k, v = _flash_views(cuda_device, 2, s, kv * group, kv, hd, dtype,
                           seed=hd * s + group)
    got = flash_mod.flash_attention(q, k, v, window=window)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, window=window),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,s,h,kv,hd,window", [
    (2, 64, 3, 1, 20, 0),        # smollm-360m-reduced: position stride 60
    (2, 200, 3, 1, 20, 32),
    (1, 300, 32, 8, 120, 128),   # h2o-danube-3-4b: position stride 3840
    (1, 4096, 32, 8, 120, 4096),
])
def test_flash_attention_model_strides_on_card(cuda_device, b, s, h, kv, hd,
                                               window, dtype):
    """The families' own layouts: position strides 60 (8-byte copies in
    bf16) and 3840 (16-byte), and offset views (4-byte copies in bf16,
    4-byte in f32); the output keeps q's layout."""
    for offset in (0, 2):
        q, k, v = _flash_views(cuda_device, b, s, h, kv, hd, dtype,
                               seed=s + offset, offset=offset)
        assert q.stride(2) == h * hd
        got = flash_mod.flash_attention(q, k, v, window=window)
        torch.cuda.synchronize()
        assert got.stride() == q.stride()
        tol = FLASH_TOL[dtype]
        torch.testing.assert_close(
            got, ref.flash_attention_ref(q, k, v, window=window),
            rtol=tol, atol=tol)


@pytest.mark.parametrize("hd", [1, 17, 33, 255])
def test_flash_attention_f32_odd_head_dims_on_card(cuda_device, hd):
    """f32 takes odd head dims too, by 4-byte copies and element stores."""
    q, k, v = _flash_views(cuda_device, 2, 70, 4, 2, hd, torch.float32, seed=hd)
    got = flash_mod.flash_attention(q, k, v, window=16)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref.flash_attention_ref(q, k, v, window=16),
                               rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_refuses_head_dim_257_on_card(cuda_device, dtype):
    """The wrapper refuses hd 257, and so does the entry point itself
    (its launch error)."""
    import ctypes

    from repro_torch.kernels import build
    q = torch.zeros((1, 2, 8, 257), dtype=dtype, device=cuda_device)
    with pytest.raises(ValueError, match="hd"):
        flash_mod.flash_attention(q, q, q)
    o = torch.empty_like(q)
    strides = (ctypes.c_longlong * 12)(*[x for t in (q, q, q, o)
                                         for x in t.stride()[:3]])
    fn = getattr(build.load("flash_attention"), flash_mod._ENTRY[dtype])
    err = fn(q.data_ptr(), q.data_ptr(), q.data_ptr(), o.data_ptr(), None, 1,
             2, 2, 8, 257, 0, strides, torch.cuda.current_stream().cuda_stream)
    assert err != 0


@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("window", [0, 33, 2048])
@pytest.mark.parametrize("group", [1, 2, 10])
@pytest.mark.parametrize("s", [1, 63, 64, 65, 100, 4096])
@pytest.mark.parametrize("hd", flash_mod.PADDED_HEAD_DIMS)
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


# -------------------------------------------- the dense and moe families


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-4), (torch.bfloat16, 0.05)])
@pytest.mark.parametrize("arch", ["smollm-360m-reduced", "mixtral-8x22b-reduced"])
def test_reduced_family_prefill_agrees_with_decode_on_card(cuda_device, arch,
                                                           dtype, tol):
    """A reduced dense model (smollm-360m: hd 20, position stride 60) and a
    reduced moe model (mixtral-8x22b: window 32, 4 experts) on the card:
    the prefill through the attention kernel against 40 decode steps (past
    the window), relative to the largest logit; the moe capacity is one no
    expert can overflow, so both paths compute the same function.  In f32
    the card's prefill also matches the CPU's (the kernel's plain
    version)."""
    import dataclasses

    from repro_torch.models import Model, resolve_config
    cfg = resolve_config(arch)
    if cfg.family == "moe":
        cfg = dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.top_k)
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Model(cfg, device=cuda_device).init(gen)   # bf16, an f32 router
    if dtype == torch.float32:
        model = model.float()
    toks = torch.randint(0, cfg.vocab, (2, 40), generator=gen,
                         device=cuda_device, dtype=torch.int32)
    before = flash_mod.launches
    with torch.inference_mode():
        full = model.prefill({"tokens": toks}).float()
        assert flash_mod.launches == before + cfg.n_layers
        cache = model.init_cache(2, 40)
        for t in range(40):
            cache, logits = model.decode_step(cache, {
                "tokens": toks[:, t],
                "pos": torch.full((2,), t, dtype=torch.int32, device=cuda_device)})
        rel = float((full - logits.float()).abs().max() / full.abs().max())
        assert rel <= tol
        if dtype == torch.float32:
            cpu = Model(cfg, device="cpu")
            cpu.load_state_dict({k: v.cpu() for k, v in model.state_dict().items()},
                                assign=True)
            on_cpu = cpu.prefill({"tokens": toks.cpu()})
            assert float((full.cpu() - on_cpu).abs().max()
                         / on_cpu.abs().max()) <= 1e-5


# ------------------------------------------------ the families on a mesh


@pytest.mark.parametrize("arch,start", [("mixtral-8x22b-reduced", 19),
                                        ("recurrentgemma-2b-reduced", 15)])
def test_reduced_family_on_two_gloo_ranks_on_card(cuda_device, arch, start):
    """A reduced moe model (mixtral-8x22b: EP, its 4 experts over the model
    axis, one dispatch group routed whole) and a reduced hybrid one
    (recurrentgemma-2b: ``rglru_scan`` and local attention on each rank's
    channels and heads) on the (1, 2) mesh of 2 gloo ranks sharing the
    card, in f32: the prefill and 2 decode steps (into both ranks' halves
    of the slots) within 1e-4 of one process's on the same weights (seed
    0 on the card), and the same greedy tokens."""
    from repro_torch.launch.sharded import serve_rank
    from repro_torch.launch.spawn import spawn_workers
    from repro_torch.models import Model, resolve_config
    cfg = resolve_config(arch)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab, (2, 40))
    dec = rng.integers(0, cfg.vocab, (2, 2))
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Model(cfg, device=cuda_device).init(gen).float()
    with torch.inference_mode():
        full = model.prefill({"tokens": torch.as_tensor(prompts, device=cuda_device)})
        cache = model.init_cache(2, 40)
        steps = []
        for t in range(3):
            cache, lg = model.decode_step(cache, {
                "tokens": torch.as_tensor(dec[:, min(t, 1)], device=cuda_device),
                "pos": torch.full((2,), start + t, dtype=torch.int32,
                                  device=cuda_device)})
            steps.append(lg.float().cpu().numpy())
    ranks = spawn_workers(serve_rank, 2, backend="gloo", device="cuda",
                          args=(arch, (1, 2), ("data", "model"), None, 0, None,
                                "float32", prompts, dec, 40, False, start),
                          timeout=600)
    got = ranks[0]
    exp = full.float().cpu().numpy()
    assert np.abs(got["prefill_logits"] - exp).max() <= 1e-4 * np.abs(exp).max()
    exp = np.stack(steps[:2])
    assert np.abs(got["decode_logits"] - exp).max() <= 1e-4 * np.abs(exp).max()
    for r in ranks:
        np.testing.assert_array_equal(r["decode"]["next_tokens"],
                                      steps[2].argmax(-1))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_dense_train_step_on_two_gloo_ranks_on_card(cuda_device, dtype):
    """h2o-danube-3-4b-reduced's train step (2 micro-batches of (1, 40))
    on the (1, 2) mesh of 2 gloo ranks sharing the card, against one
    process on the card from the same weights (seed 0): the loss, the
    grad norm and each leaf's ``mu`` after the step (the clipped
    gradient) within 1e-4 (relative; ``mu`` of each leaf's largest
    magnitude) in f32, within the bf16 gates of ``chip_smoke.py``'s
    train-mesh path (1e-2, 5e-2, 0.15) in bf16.  Every collective of the
    step, the backward's on the autograd engine's own thread too, is
    staged through the host (gloo takes no CUDA tensor there)."""
    from repro_torch.launch.sharded import train_rank
    from repro_torch.launch.spawn import spawn_workers
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model, resolve_config
    from repro_torch.optim import adamw_init
    arch = "h2o-danube-3-4b-reduced"
    cfg = resolve_config(arch)
    toks = np.random.default_rng(0).integers(0, cfg.vocab, (2, 1, 41)
                                             ).astype(np.int32)
    batch = {"tokens": toks[..., :-1].copy(), "labels": toks[..., 1:].copy()}
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Model(cfg, device=cuda_device).init(gen).to(getattr(torch, dtype))
    model.requires_grad_(True)
    state = adamw_init(dict(model.named_parameters()))
    state, m = make_train_step(model)(state, {
        k: torch.as_tensor(v, device=cuda_device) for k, v in batch.items()})
    ranks = spawn_workers(train_rank, 2, backend="gloo", device="cuda",
                          args=(arch, (1, 2), ("data", "model"), [batch], None,
                                0, None, dtype, None, ("mu",)),
                          timeout=600)
    tol = {"loss": 1e-4, "grad_norm": 1e-4, "mu": 1e-4} if dtype == "float32" \
        else {"loss": 1e-2, "grad_norm": 5e-2, "mu": 0.15}
    got = ranks[0]["steps"][0]
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - float(m[key])) <= tol[key] * abs(float(m[key]))
    for k, v in state.mu.items():
        exp = v.cpu().numpy()
        err = np.abs(ranks[0]["mu"][k] - exp).max()
        assert err <= tol["mu"] * np.abs(exp).max(), (k, err)
    for r in ranks:
        coll = r["steps"][0]["collectives"]
        assert coll["by_phase"]["backward"]["count"] > 0
        assert r["host_staged_messages"] >= coll["count"]


TRAIN_FAMILY_ARCHS = {"moe": "mixtral-8x22b-reduced",
                      "ssm": "falcon-mamba-7b-reduced",
                      "hybrid": "recurrentgemma-2b-reduced",
                      "vlm": "internvl2-76b-reduced",
                      "encdec": "seamless-m4t-large-v2-reduced"}


@pytest.mark.parametrize("family", list(TRAIN_FAMILY_ARCHS))
def test_family_train_step_on_two_gloo_ranks_on_card(cuda_device, family):
    """A reduced config of each family other than dense: its f32 train
    step (2 micro-batches of (1, 40) in ``data.family_batch``'s layout:
    vlm's 8 patches, encdec's 10 frames) on the (1, 2) mesh of 2 gloo
    ranks sharing the card, against one process on the card from the same
    weights (seed 0): the loss, the grad norm and each leaf's ``mu``
    within 1e-4 (relative; ``mu`` of each leaf's largest magnitude).  The
    kernels run inside the ranks on local tensors (``flash_attention``,
    ``rglru_scan``, ``ssm_scan`` and their backwards), and the moe
    router's, the convolutions' and the readout's gradients are the
    partial sums their ``local_map`` declares."""
    from repro_torch.data import family_batch
    from repro_torch.launch.sharded import train_rank
    from repro_torch.launch.spawn import spawn_workers
    from repro_torch.launch.steps import make_train_step
    from repro_torch.models import Model, resolve_config
    from repro_torch.optim import adamw_init
    arch = TRAIN_FAMILY_ARCHS[family]
    cfg = resolve_config(arch)
    drawn = family_batch(cfg, 2, 40, torch.Generator().manual_seed(0),
                         train=True)
    batch = {k: (v.float() if v.is_floating_point() else v).numpy()
             .reshape((2, 1) + tuple(v.shape[1:])) for k, v in drawn.items()}
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    model = Model(cfg, device=cuda_device).init(gen).float()
    model.requires_grad_(True)
    state = adamw_init(dict(model.named_parameters()))
    state, m = make_train_step(model)(state, {
        k: torch.as_tensor(v, device=cuda_device) for k, v in batch.items()})
    ranks = spawn_workers(train_rank, 2, backend="gloo", device="cuda",
                          args=(arch, (1, 2), ("data", "model"), [batch], None,
                                0, None, "float32", None, ("mu",)),
                          timeout=600)
    got = ranks[0]["steps"][0]
    for key in ("loss", "grad_norm"):
        assert abs(got[key] - float(m[key])) <= 1e-4 * abs(float(m[key])), key
    for k, v in state.mu.items():
        exp = v.cpu().numpy()
        err = np.abs(ranks[0]["mu"][k] - exp).max()
        assert err <= 1e-4 * np.abs(exp).max(), (k, err)
    for r in ranks:
        coll = r["steps"][0]["collectives"]
        assert coll["by_phase"]["backward"]["count"] > 0
        assert r["host_staged_messages"] >= coll["count"]


# ------------------------------------------------ the backward kernels


def _rel_err(got, exp, floor=1e-6):
    """max |got − exp| over the largest |exp| (or ``floor``, where that is
    smaller)."""
    if not got.numel():
        return 0.0
    scale = max(float(exp.float().abs().max()), floor)
    return float((got.float() - exp.float()).abs().max()) / scale


# each row of a gradient against its own scale (ref.flash_attention_bwd_check):
# f32 sums in other orders; bf16 rounds P and dS as the products' operands
# and dq, dk, dv once at the store
FLASH_BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("window", [0, 40, 150])
@pytest.mark.parametrize("group", [1, 4, 8])
@pytest.mark.parametrize("s", [1, 64, 100, 130, 300])
@pytest.mark.parametrize("hd", [16, 20, 32, 64, 120, 128, 256])
def test_flash_attention_bwd_kernel_on_card(cuda_device, hd, s, group, window,
                                            dtype):
    """The forward's logsumexp and the backward kernel against the plain
    versions at every padded head dim (and 20, 120), ragged S (up to five
    64-row tiles, nine 32-column ones at hd 256), GQA groups up to
    danube's 8, windows inside a tile and across several tile edges, on
    the model's strided views, with a strided dO; each gradient held row
    by row."""
    q, k, v = _flash_views(cuda_device, 2, s, 2 * group, 2, hd, dtype, seed=hd + s)
    gen = torch.Generator(device=cuda_device).manual_seed(7)
    o, lse = flash_mod.flash_attention(q, k, v, window=window, return_lse=True)
    o_ref, lse_ref = ref.flash_attention_ref(q, k, v, window=window,
                                             return_lse=True)
    do = torch.randn((2, s, 2 * group, hd), generator=gen, device=cuda_device
                     ).to(dtype).transpose(1, 2)
    got = flash_mod.flash_attention_bwd(q, k, v, o, lse, do, window=window)
    torch.cuda.synchronize()
    assert _rel_err(lse, lse_ref, floor=1.0) <= 1e-5
    assert _rel_err(o, o_ref) <= FLASH_TOL[dtype]
    for g, t in zip(got, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape and g.stride() == t.stride()
    res = ref.flash_attention_bwd_check(q, k, v, o, lse, do, got, window=window,
                                        tol=FLASH_BWD_TOL[dtype])
    assert all(r["worst"] <= 1.0 for r in res.values()), res


def _flash_bwd_inputs(device, b, s, h, kv, hd, window, seed):
    q, k, v = _flash_views(device, b, s, h, kv, hd, torch.bfloat16, seed=seed)
    o, lse = flash_mod.flash_attention(q, k, v, window=window, return_lse=True)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn((b, s, h, hd), generator=gen, device=device
                     ).to(torch.bfloat16).transpose(1, 2)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("layout", ["odd position stride", "offset of 1"])
@pytest.mark.parametrize("hd", [64, 120])
def test_flash_attention_bwd_bf16_copies_a_do_it_cannot_load(cuda_device, hd,
                                                             layout):
    """A bf16 dO whose layout forbids 4-byte copies (an odd position
    stride, or a storage offset of one element) is made contiguous by the
    wrapper: the gradients equal those from a contiguous dO bit for bit."""
    b, s, h = 2, 150, 8
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda_device, b, s, h, 2, hd, 0, hd)
    if layout == "odd position stride":
        buf = torch.zeros((b, h, s, hd + 1), dtype=torch.bfloat16, device=cuda_device)
        buf[..., :hd] = do
        odd = buf[..., :hd]
    else:
        flat = torch.empty(do.numel() + 1, dtype=torch.bfloat16, device=cuda_device)
        flat[1:] = do.transpose(1, 2).reshape(-1)
        odd = flat[1:].view(b, s, h, hd).transpose(1, 2)
    assert torch.equal(odd, do) and odd.stride(-1) == 1
    assert odd.data_ptr() % 4 or any(x % 2 for x in odd.stride()[:3])
    before = flash_mod.bwd_launches
    got = flash_mod.flash_attention_bwd(q, k, v, o, lse, odd, window=0)
    exp = flash_mod.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), window=0)
    torch.cuda.synchronize()
    assert flash_mod.bwd_launches == before + 2
    assert all(torch.equal(g, e) for g, e in zip(got, exp))
    res = ref.flash_attention_bwd_check(q, k, v, o, lse, odd, got, window=0,
                                        tol=FLASH_BWD_TOL[torch.bfloat16])
    assert all(r["worst"] <= 1.0 for r in res.values()), res


@pytest.mark.parametrize("hd,s,group,window", [(120, 300, 8, 150), (256, 200, 1, 70),
                                               (64, 130, 3, 0), (16, 100, 2, 40)])
def test_flash_attention_bwd_bf16_is_deterministic_on_card(cuda_device, hd, s,
                                                           group, window):
    """No atomics: two calls on the same inputs give the same bits (remat's
    recompute and resumed runs rely on it)."""
    args = _flash_bwd_inputs(cuda_device, 2, s, 2 * group, 2, hd, window, hd + s)
    first = flash_mod.flash_attention_bwd(*args, window=window)
    second = flash_mod.flash_attention_bwd(*args, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# the bf16 dK/dV grid whole (enough blocks of (b, kv head, key tile) for
# every SM: each sums its GQA group) and split over the group's heads (too
# few: f32 partial sums, added in order by a second kernel), recurrentgemma's
# group of 10 and danube's window among them
@pytest.mark.parametrize("b,s,h,kv,hd,window,split", [
    (8, 2048, 8, 2, 64, 0, False), (4, 1100, 32, 8, 120, 600, False),
    (1, 1024, 10, 1, 256, 512, True), (1, 700, 8, 1, 120, 0, True),
    (2, 300, 6, 2, 64, 100, True)])
def test_flash_attention_bwd_bf16_whole_and_split_grid_on_card(
        cuda_device, b, s, h, kv, hd, window, split):
    floats = ctypes.c_longlong(0)
    with torch.cuda.device(cuda_device):
        assert build.load("flash_attention").flash_attention_bwd_bf16_scratch(
            b, h, kv, s, hd, window, ctypes.byref(floats)) == 0
    assert (floats.value > b * h * s) == split
    args = _flash_bwd_inputs(cuda_device, b, s, h, kv, hd, window, s + hd)
    got = flash_mod.flash_attention_bwd(*args, window=window)
    again = flash_mod.flash_attention_bwd(*args, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(x, y) for x, y in zip(got, again))
    res = ref.flash_attention_bwd_check(*args, got, window=window,
                                        tol=FLASH_BWD_TOL[torch.bfloat16])
    assert all(r["worst"] <= 1.0 for r in res.values()), res


def test_flash_attention_bwd_bf16_refuses_unaligned_views(cuda_device):
    q, k, v, o, lse, do = _flash_bwd_inputs(cuda_device, 1, 40, 4, 2, 64, 0, 5)
    bad = _flash_views(cuda_device, 1, 40, 4, 2, 64, torch.bfloat16, seed=5,
                       offset=1)[0]
    with pytest.raises(ValueError, match="4 bytes"):
        flash_mod.flash_attention_bwd(bad, k, v, o, lse, do)



def _flash_bwd_f32_inputs(device, b, s, h, kv, hd, window, seed):
    q, k, v = _flash_views(device, b, s, h, kv, hd, torch.float32, seed=seed)
    o, lse = flash_mod.flash_attention(q, k, v, window=window, return_lse=True)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    do = torch.randn((b, s, h, hd), generator=gen, device=device).transpose(1, 2)
    return q, k, v, o, lse, do


@pytest.mark.parametrize("hd,s,group,window", [(120, 300, 8, 150), (256, 200, 1, 70),
                                               (64, 130, 3, 0), (16, 100, 2, 40),
                                               (17, 90, 2, 0)])
def test_flash_attention_bwd_f32_is_deterministic_on_card(cuda_device, hd, s,
                                                          group, window):
    """The f32 body (3xTF32 on the tensor cores) has no atomics either: two
    calls on the same inputs give the same bits."""
    args = _flash_bwd_f32_inputs(cuda_device, 2, s, 2 * group, 2, hd, window, hd + s)
    first = flash_mod.flash_attention_bwd(*args, window=window)
    second = flash_mod.flash_attention_bwd(*args, window=window)
    torch.cuda.synchronize()
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("layout", ["odd position stride", "offset of 1"])
@pytest.mark.parametrize("hd", [64, 120])
def test_flash_attention_bwd_f32_takes_a_do_it_copies_4_bytes_at_a_time(
        cuda_device, hd, layout):
    """An f32 dO whose layout allows only 4-byte copies (an odd position
    stride, or a storage offset of one element) is taken as it lies, with
    no copy: the gradients equal those from a contiguous dO (16-byte
    copies) bit for bit, and pass the row-by-row check."""
    b, s, h = 2, 150, 8
    q, k, v, o, lse, do = _flash_bwd_f32_inputs(cuda_device, b, s, h, 2, hd, 0, hd)
    if layout == "odd position stride":
        buf = torch.zeros((b, h, s, hd + 1), device=cuda_device)
        buf[..., :hd] = do
        odd = buf[..., :hd]
    else:
        flat = torch.empty(do.numel() + 1, device=cuda_device)
        flat[1:] = do.transpose(1, 2).reshape(-1)
        odd = flat[1:].view(b, s, h, hd).transpose(1, 2)
    assert torch.equal(odd, do) and odd.stride(-1) == 1
    assert odd.data_ptr() % 8 or any(x % 2 for x in odd.stride()[:3])
    before = flash_mod.bwd_launches
    got = flash_mod.flash_attention_bwd(q, k, v, o, lse, odd, window=0)
    exp = flash_mod.flash_attention_bwd(q, k, v, o, lse, do.contiguous(), window=0)
    torch.cuda.synchronize()
    assert flash_mod.bwd_launches == before + 2
    assert all(torch.equal(g, e) for g, e in zip(got, exp))
    res = ref.flash_attention_bwd_check(q, k, v, o, lse, odd, got, window=0,
                                        tol=FLASH_BWD_TOL[torch.float32])
    assert all(r["worst"] <= 1.0 for r in res.values()), res

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_attention_forward_without_lse_writes_none(cuda_device, dtype):
    q, k, v = _flash_views(cuda_device, 1, 70, 4, 2, 64, dtype, seed=3)
    o = flash_mod.flash_attention(q, k, v, window=16)
    o2, lse = flash_mod.flash_attention(q, k, v, window=16, return_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(o, o2) and lse.shape == (1, 4, 70)


# both bodies of the shared scan_bwd kernel: blocks of 64 threads and
# chunks of 32 where B × lanes do not fill the SMs with blocks of 256 (the
# small shapes), blocks of 256 and chunks of 16 where they do (the last)
@pytest.mark.parametrize("shape", [(1, 1, 1), (2, 33, 1000), (1, 100, 64),
                                   (3, 70, 5), (1, 40, 40000)])
def test_rglru_scan_bwd_kernel_on_card(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(shape[1])
    a = torch.rand(shape, generator=gen, device=cuda_device) * 0.75 + 0.2
    b = torch.randn(shape, generator=gen, device=cuda_device)
    g = torch.randn(shape, generator=gen, device=cuda_device)
    h = rglru_mod.rglru_scan(a, b)
    da, db = rglru_mod.rglru_scan_bwd(a, h, g)
    eda, edb = ref.scan_bwd_ref(a, h, g)
    torch.cuda.synchronize()
    assert torch.equal(da, eda) and torch.equal(db, edb)


# the ring body (B × lanes below a full wave of 256-thread blocks): ragged S
# (not a multiple of its 64-step stages), ragged lanes (not a multiple of
# its 16-lane blocks), lanes × 4 bytes or a pointer not a multiple of 16
# (4-byte copies), B of 1 and 4, S = 1
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("shape", [(1, 4096, 2560), (1, 100, 2560), (4, 130, 2560),
                                   (1, 300, 1000), (4, 65, 1001), (1, 1, 64),
                                   (4, 1, 33), (1, 64, 2558), (4, 200, 48)])
def test_rglru_scan_bwd_ring_on_card(cuda_device, shape, offset):
    gen = torch.Generator(device=cuda_device).manual_seed(shape[1] + offset)
    n = int(np.prod(shape))

    def tensor(x):  # a contiguous tensor `offset` floats into its storage
        buf = torch.empty(n + offset, device=cuda_device)
        buf[offset:] = x.reshape(-1)
        return buf[offset:].view(shape)

    a = tensor(torch.rand(shape, generator=gen, device=cuda_device) * 0.75 + 0.2)
    b = tensor(torch.randn(shape, generator=gen, device=cuda_device))
    g = tensor(torch.randn(shape, generator=gen, device=cuda_device))
    h = tensor(rglru_mod.rglru_scan(a, b))
    da, db = rglru_mod.rglru_scan_bwd(a, h, g)
    eda, edb = ref.scan_bwd_ref(a, h, g)
    torch.cuda.synchronize()
    assert torch.equal(da, eda) and torch.equal(db, edb)


@pytest.mark.parametrize("shape", [(1, 1, 3, 2), (2, 33, 125, 3),
                                   (1, 64, 64, 16), (2, 17, 8, 4),
                                   (1, 37, 2176, 16)])
def test_ssm_scan_bwd_kernel_on_card(cuda_device, shape):
    gen = torch.Generator(device=cuda_device).manual_seed(shape[1])
    a = torch.rand(shape, generator=gen, device=cuda_device) * 0.89 + 0.1
    b = torch.randn(shape, generator=gen, device=cuda_device)
    g = torch.randn(shape, generator=gen, device=cuda_device)
    h = ssm_mod.ssm_scan(a, b)
    da, db = ssm_mod.ssm_scan_bwd(a, h, g)
    eda, edb = ref.scan_bwd_ref(a, h, g)
    torch.cuda.synchronize()
    assert torch.equal(da, eda) and torch.equal(db, edb)


def test_cuda_backward_launches_the_kernels(cuda_device):
    """``ops``' differentiable entry points on CUDA tensors that require
    grad: one forward and one backward launch each, and the gradients of
    the plain versions on the CPU."""
    from repro_torch.kernels import ops
    gen = torch.Generator(device=cuda_device).manual_seed(0)
    q, k, v = (torch.randn((1, n, 50, 32), generator=gen, device=cuda_device)
               .requires_grad_() for n in (4, 2, 2))
    before = (flash_mod.launches, flash_mod.bwd_launches)
    ops.flash_attention(q, k, v, window=8).square().sum().backward()
    assert (flash_mod.launches, flash_mod.bwd_launches) == (before[0] + 1,
                                                            before[1] + 1)
    cpu = [t.detach().cpu().requires_grad_() for t in (q, k, v)]
    ops.flash_attention(*cpu, window=8).square().sum().backward()
    for t, c in zip((q, k, v), cpu):
        assert _rel_err(t.grad.cpu(), c.grad) <= 1e-4
    for mod, fn, shape in ((rglru_mod, ops.rglru_scan, (2, 30, 40)),
                           (ssm_mod, ops.ssm_scan, (2, 30, 8, 4))):
        a = (torch.rand(shape, generator=gen, device=cuda_device) * 0.5 + 0.4
             ).requires_grad_()
        b = torch.randn(shape, generator=gen, device=cuda_device).requires_grad_()
        before = (mod.launches, mod.bwd_launches)
        fn(a, b).square().sum().backward()
        assert (mod.launches, mod.bwd_launches) == (before[0] + 1, before[1] + 1)
        ac, bc = (t.detach().cpu().requires_grad_() for t in (a, b))
        fn(ac, bc).square().sum().backward()
        assert torch.equal(a.grad.cpu(), ac.grad) and torch.equal(b.grad.cpu(), bc.grad)
    with torch.no_grad():
        before = flash_mod.bwd_launches
        assert not ops.flash_attention(q, k, v).requires_grad


@pytest.mark.parametrize("arch", ["smollm-360m-reduced", "h2o-danube-3-4b-reduced",
                                  "recurrentgemma-2b-reduced",
                                  "falcon-mamba-7b-reduced",
                                  "mixtral-8x22b-reduced"])
def test_reduced_model_gradients_on_card_match_the_cpu(cuda_device, arch):
    """``train_loss``'s gradients in f32 through the kernels (forward and
    backward) against the CPU's through the plain versions, from the same
    weights and batch: each leaf within 1e-4 of its largest magnitude."""
    from repro_torch.models import Model, resolve_config
    cfg = resolve_config(arch)
    gen = torch.Generator(device="cpu").manual_seed(0)
    cpu = Model(cfg, device="cpu").init(gen).float().requires_grad_(True)
    card = Model(cfg, device=cuda_device)
    card.load_state_dict({k: v.to(cuda_device) for k, v in cpu.state_dict().items()},
                         assign=True)
    card = card.float().requires_grad_(True)
    toks = torch.randint(0, cfg.vocab, (2, 65), generator=gen, dtype=torch.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    mods = (flash_mod, rglru_mod, ssm_mod)
    before = [m.bwd_launches for m in mods]
    loss_c = card.train_loss({k: v.to(cuda_device) for k, v in batch.items()})
    loss_c.backward()
    torch.cuda.synchronize()
    assert sum(m.bwd_launches for m in mods) > sum(before)
    loss = cpu.train_loss(batch)
    loss.backward()
    assert abs(float(loss_c) - float(loss)) <= 1e-5 * abs(float(loss))
    grads = dict(card.named_parameters())
    for name, p in cpu.named_parameters():
        assert _rel_err(grads[name].grad.cpu(), p.grad, floor=1e-6) <= 1e-4, name
