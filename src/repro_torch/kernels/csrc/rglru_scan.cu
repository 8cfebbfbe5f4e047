// rglru_scan: the RG-LRU gated linear recurrence  h_t = a_t * h_{t-1} + b_t
// over (B, S, W) float32, h_{-1} = 0, returning every h_t.
//
// Replaces repro/kernels/rglru_scan.py::rglru_scan (Pallas, TPU).  There a
// grid step held one (1, S, block_w) slab of a and b in VMEM and walked S
// with a fori_loop, all block_w lanes at once.  Here one thread owns one
// (batch, channel) lane and walks S: a_t and b_t do not depend on h, so the
// loads of a chunk of kChunk steps are issued together before its
// recurrence runs, and consecutive threads read consecutive channels, so
// every load and store of a warp is one coalesced 128-byte line.
//
// Bit-exact with the Pallas body as the reference runs it and with the plain
// version (repro_torch/kernels/ref.py rglru_scan_ref): each step is one
// fused multiply-add, a*h + b rounded once (__fmaf_rn).  XLA contracts the
// Pallas body's `a * h + b` into an FMA when it compiles it (checked on the
// reference's CPU interpret mode), so a product and a sum rounded apart
// (__fmul_rn, __fadd_rn) would differ from it in the last bits of about a
// third of the outputs (measured at (1, 64, 512)); the plain version
// computes the same single rounding.
//
// Bound on the H100: the bytes are 3 * B*S*W*4 (read a and b, write h), so
// 252 MB and 0.075 ms at the full-width prefill (B=2, S=4096, W=2560).  But
// B*W = 5,120 threads fill 80 blocks of 64 on 132 SMs, and each step waits
// on the step before it, so the kernel is bound by load latency and the
// serial chain, far above the byte bound.  A chunked scan (carry per chunk,
// then a fix-up pass) that puts more threads to work is a later PR's work.
//
// Plain C entry point; returns the launch's cudaError_t, and the Python
// wrapper (repro_torch/kernels/rglru_scan.py) raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 64;
constexpr int kChunk = 16;

__global__ void rglru_scan_kernel(const float* __restrict__ a,
                                  const float* __restrict__ b,
                                  float* __restrict__ h, int S, int W) {
  const int w = blockIdx.x * blockDim.x + threadIdx.x;
  if (w >= W) return;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * W + w;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = 0.0f;
  int t = 0;
  for (; t + kChunk <= S; t += kChunk) {
    float av[kChunk], bv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      av[u] = __ldg(ap + static_cast<int64_t>(t + u) * W);
      bv[u] = __ldg(bp + static_cast<int64_t>(t + u) * W);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      hv = __fmaf_rn(av[u], hv, bv[u]);
      hp[static_cast<int64_t>(t + u) * W] = hv;
    }
  }
  for (; t < S; ++t) {
    const int64_t off = static_cast<int64_t>(t) * W;
    hv = __fmaf_rn(__ldg(ap + off), hv, __ldg(bp + off));
    hp[off] = hv;
  }
}

}  // namespace

extern "C" {

int rglru_scan_f32(const void* a, const void* b, void* h, int B, int S, int W,
                   void* stream) {
  if (B <= 0 || S <= 0 || W <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((W + kThreads - 1) / kThreads, B);
  rglru_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, W);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
