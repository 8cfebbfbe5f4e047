// rglru_scan: the RG-LRU gated linear recurrence  h_t = a_t * h_{t-1} + b_t
// over (B, S, W) float32, h_{-1} = 0, returning every h_t.
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan (Pallas, TPU).  There a
// grid step held one (1, S, block_w) slab of a and b in VMEM and walked S
// with a fori_loop, all block_w lanes at once.  Here one thread still owns
// one (batch, channel) lane and walks S, but a and b reach it through a ring
// of shared-memory stages that the whole block keeps filled ahead of it.
//
// Bit-exact with the Pallas body as the reference runs it and with the plain
// version (repro_torch/kernels/ref.py rglru_scan_ref): each step is one
// fused multiply-add, a*h + b rounded once (__fmaf_rn).  XLA contracts the
// Pallas body's `a * h + b` into an FMA when it compiles it (checked on the
// reference's CPU interpret mode), so a product and a sum rounded apart
// (__fmul_rn, __fadd_rn) would differ from it in the last bits of about a
// third of the outputs (measured at (1, 64, 512)); the plain version
// computes the same single rounding.  A chunked scan (a carry per chunk and
// a fix-up pass) would round in another order, so the recurrence stays one
// serial chain per lane: at the prefill's S = 4096 that is 4096 dependent
// FMAs, about 9 us, far under the byte bound below.
//
// Bound on the H100: bytes, 3 * B*S*W*4 (read a and b, write h), so 252 MB
// and 0.075 ms at the full-width prefill (B=2, S=4096, W=2560).  The first
// kernel (one thread a lane, 16 steps of loads issued before their FMAs)
// missed it by 5.5x: its B*W = 5,120 threads made 80 blocks of 64, so 52 of
// the 132 SMs had no work, and at most 80*64*32*4 B = 655 KB of loads were
// in flight card-wide, where 3.35 TB/s at ~0.7 us of DRAM latency needs
// ~2.3 MB (Little's law).
//
// The design: a block owns one batch row and kC = 32 consecutive channels
// (128-byte rows, one line each), so the prefill has B*W/32 = 160 blocks,
// at least one on every SM.  Its 128 threads copy (kT = 64 steps x 32
// channels) tiles of a and b into a ring of kStages = 3 shared-memory
// stages (48 KB) by cp.async, 16 bytes a copy, and keep the next two stages
// (32 KB a block, ~5 MB card-wide at the prefill) in flight while one warp
// runs the current stage's FMAs.  Each lane writes h over a in the stage,
// and the block stores the stage's h rows back with 16-byte stores.  On the
// card, 64-byte rows (16 channels, 320 blocks) were slower than this, and
// deeper rings, or 64 channels a block, not faster at both of the rg
// paths' shapes.  adaptive_eval's (4, 64, 2560) is one stage a block: one
// round of copies, one pass of FMAs, one store.  Ragged S (a last stage of
// fewer rows) and ragged W (a last group of fewer channels) are masked.
// Where W*4 bytes or a pointer is not a multiple of 16 bytes, the same ring
// runs on 4-byte copies and stores (kVec = 1); the entry point picks the
// body.
//
// Plain C entry point; returns the launch's cudaError_t, and the Python
// wrapper (repro_torch/kernels/rglru_scan.py) raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kC = 32;        // channels of a block: 128-byte rows
constexpr int kT = 64;        // steps of a stage
constexpr int kStages = 3;    // ring depth; kStages - 1 stages in flight
constexpr int kThreads = 128;
constexpr int kChunk = 16;    // steps whose a, b a lane reads at once

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

template <int kVec>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src) {
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kVec floats a copy and a store: 4 (16 bytes) or 1.
template <int kVec>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                      float* __restrict__ h, int S, int W) {
  __shared__ __align__(16) float sa[kStages][kT][kC];  // a, then h
  __shared__ __align__(16) float sb[kStages][kT][kC];
  constexpr int kPieces = kC / kVec;  // copies of a row
  const int w0 = blockIdx.x * kC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * S;  // row (b, 0)
  const int stages = (S + kT - 1) / kT;

  // Stage k's rows t0 .. t0 + kT - 1 of a and b into ring slot k % kStages.
  auto load = [&](int k) {
    const int slot = k % kStages;
    const int t0 = k * kT;
    for (int i = threadIdx.x; i < kT * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int w = (i % kPieces) * kVec;
      if (t0 + r < S && w0 + w < W) {
        const int64_t off = (row0 + t0 + r) * W + w0 + w;
        cp_async<kVec>(smem_u32(&sa[slot][r][w]), a + off);
        cp_async<kVec>(smem_u32(&sb[slot][r][w]), b + off);
      }
    }
  };

#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (k < stages) load(k);
    cp_async_commit();  // one group a stage, empty past the last
  }
  const int c = threadIdx.x;
  const bool lane = c < kC && w0 + c < W;
  float hv = 0.0f;
  for (int k = 0; k < stages; ++k) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage k are in
    __syncthreads();               // everyone's are; slot k-1 is stored back
    if (k + kStages - 1 < stages) load(k + kStages - 1);
    cp_async_commit();
    const int slot = k % kStages;
    const int rows = min(kT, S - k * kT);
    if (lane) {
      if (rows == kT) {
        // 16 steps' a and b read before their FMAs, so the chain waits on
        // shared memory once a chunk and not once a step
        for (int t0 = 0; t0 < kT; t0 += kChunk) {
          float av[kChunk], bv[kChunk];
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            av[u] = sa[slot][t0 + u][c];
            bv[u] = sb[slot][t0 + u][c];
          }
#pragma unroll
          for (int u = 0; u < kChunk; ++u) {
            hv = __fmaf_rn(av[u], hv, bv[u]);
            sa[slot][t0 + u][c] = hv;
          }
        }
      } else {
        for (int t = 0; t < rows; ++t) {
          hv = __fmaf_rn(sa[slot][t][c], hv, sb[slot][t][c]);
          sa[slot][t][c] = hv;
        }
      }
    }
    __syncthreads();  // the stage's h rows are complete
    for (int i = threadIdx.x; i < rows * kPieces; i += kThreads) {
      const int r = i / kPieces;
      const int w = (i % kPieces) * kVec;
      if (w0 + w < W) {
        float* dst = h + (row0 + k * kT + r) * W + w0 + w;
        if constexpr (kVec == 4) {
          *reinterpret_cast<float4*>(dst) =
              *reinterpret_cast<const float4*>(&sa[slot][r][w]);
        } else {
          *dst = sa[slot][r][w];
        }
      }
    }
  }
}

}  // namespace

extern "C" {

int rglru_scan_f32(const void* a, const void* b, void* h, int B, int S, int W,
                   void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const auto bits = reinterpret_cast<uintptr_t>(a) |
                    reinterpret_cast<uintptr_t>(b) |
                    reinterpret_cast<uintptr_t>(h);
  const bool vec = W % 4 == 0 && bits % 16 == 0;
  const dim3 grid((W + kC - 1) / kC, B);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const float*>(a);
  const auto* bp = static_cast<const float*>(b);
  auto* hp = static_cast<float*>(h);
  if (vec) {
    rglru_scan_kernel<4><<<grid, kThreads, 0, st>>>(ap, bp, hp, S, W);
  } else {
    rglru_scan_kernel<1><<<grid, kThreads, 0, st>>>(ap, bp, hp, S, W);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
