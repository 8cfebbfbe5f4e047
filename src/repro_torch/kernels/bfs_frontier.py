"""Wrapper of the CUDA ``bfs_frontier`` kernel (``csrc/bfs_frontier.cu``):
one BFS level with shortest-path counting for B lanes,

    agg[b, v] = Σ_{u ∈ N(v)} σ[b, u]·[dist[b, u] == level].

Replaces :func:`repro.kernels.bfs_frontier.bfs_frontier`.  The kernel PULLS
over the CSR (``indptr``/``indices``): it assumes the graph is undirected,
so that a vertex's in-neighbours are its out-neighbours, which
:func:`repro_torch.graphs.csr.from_edges` guarantees by storing every edge
as two arcs.  Each call is two launches, counted as one: a pack of the
frontier into bits (with its σ values packed by rank), then the pull, whose
cost follows the frontier's size.  The pack's scratch is as large as σ
(4·32·⌈B/32⌉·n bytes, plus ⌈B/32⌉·n words of bits), whatever the
frontier.  Its plain version is
:func:`repro_torch.kernels.ref.bfs_frontier_ref`; the pack's is
:func:`repro_torch.kernels.ref.frontier_pack_ref`.
"""

from __future__ import annotations

import torch

from . import build

# Kernel launches since the last reset (a run sets it to 0 and reads it).
launches = 0


def _check(tensors, sigma, dist) -> None:
    if any(t.device.type != "cuda" for t in tensors) or \
            len({t.device for t in tensors}) != 1:
        raise ValueError("bfs_frontier kernel needs all tensors on one CUDA "
                         f"device, got {[str(t.device) for t in tensors]}")
    if any(t.dtype != torch.int32 for t in tensors if t is not sigma) or \
            sigma.dtype != torch.float32:
        raise ValueError("bfs_frontier kernel takes int32 indptr/indices/dist "
                         "and float32 sigma")
    if sigma.dim() != 2 or dist.shape != sigma.shape:
        raise ValueError(f"bfs_frontier kernel shapes: sigma "
                         f"{tuple(sigma.shape)}, dist {tuple(dist.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("bfs_frontier kernel needs contiguous tensors")


def bfs_frontier(indptr: torch.Tensor, indices: torch.Tensor,
                 sigma: torch.Tensor, dist: torch.Tensor,
                 level: int) -> torch.Tensor:
    """indptr (n+1,) int32, indices (≥ m,) int32, sigma (B, n) f32 and
    dist (B, n) int32, all contiguous on one CUDA device → agg (B, n) f32."""
    global launches
    _check((indptr, indices, sigma, dist), sigma, dist)
    if indptr.dim() != 1 or indptr.shape[0] != sigma.shape[1] + 1:
        raise ValueError(f"bfs_frontier kernel shapes: indptr "
                         f"{tuple(indptr.shape)}, sigma {tuple(sigma.shape)}")
    b, n = sigma.shape
    agg = torch.empty((b, n), dtype=torch.float32, device=sigma.device)
    # scratch: front (n, G) int32 words of lane bits and sigp (n, G, 32) f32,
    # G = ⌈B/32⌉; the pack writes what the pull reads, so neither is zeroed
    groups = (b + 31) // 32
    front = torch.empty((n, groups), dtype=torch.int32, device=sigma.device)
    sigp = torch.empty((n, groups, 32), dtype=torch.float32, device=sigma.device)
    fn = build.load("bfs_frontier").bfs_frontier_f32
    with torch.cuda.device(sigma.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = fn(indptr.data_ptr(), indices.data_ptr(), sigma.data_ptr(),
                 dist.data_ptr(), int(level), agg.data_ptr(), n, b,
                 front.data_ptr(), sigp.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"bfs_frontier kernel launch failed: cudaError {err}")
    launches += 1
    return agg

