// ssm_scan: the Mamba selective-scan recurrence  h_t = a_t * h_{t-1} + b_t
// over (B, S, D, N) float32, h_{-1} = 0, returning every h_t.
//
// Replaces repro/kernels/ssm_scan.py::ssm_scan (Pallas, TPU).  There a grid
// step of (B, D / block_d) held one (S, block_d, N) slab of a and b in VMEM
// and walked S with a fori_loop, block_d * N lanes at once.  Here the
// recurrence is independent in every (b, d, n), so one thread owns one
// lane and walks S: consecutive threads take consecutive (d, n), so every
// load and store of a warp is one coalesced 128-byte line, and a_t and b_t
// do not depend on h, so the loads of a chunk of kChunk steps are issued
// together before its chain of FMAs.  Any D * N works (the ragged last
// block is masked); offsets are int64, since at B = 2, S = 4096, D = 8192,
// N = 16 a tensor holds 2^30 elements.
//
// Bit-exact with the Pallas body as the reference runs it and with the plain
// version (repro_torch/kernels/ref.py ssm_scan_ref): each step is one fused
// multiply-add, a*h + b rounded once (__fmaf_rn), as XLA contracts the
// Pallas body's `a * h + b`.
//
// Bound on the H100: the bytes, 3 * B*S*D*N*4 (read a and b, write h), so
// 12.9 GB and 3.85 ms at falcon-mamba-7b's full-width prefill (B = 2,
// S = 4096, D = 8192, N = 16); the FMAs (B*S*D*N, 2 operations each) take
// a hundredth of that.  B*D*N = 262,144 threads are about one full wave on
// 132 SMs, each with up to 2 * kChunk loads in flight: more bytes in flight
// than the memory's latency asks for, so the kernel streams close to the
// memory rate (PERF.md has its time beside the bound).  The larger cost on
// the prefill path is writing a and b to device memory before the scan; a
// scan fused with the discretisation that builds them is a later PR's work.
//
// Plain C entry point; returns the launch's cudaError_t, and the Python
// wrapper (repro_torch/kernels/ssm_scan.py) raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 16;

__global__ void ssm_scan_kernel(const float* __restrict__ a,
                                const float* __restrict__ b,
                                float* __restrict__ h, int S, int DN) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= DN) return;
  const int64_t step = DN;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * step + lane;
  const float* ap = a + base;
  const float* bp = b + base;
  float* hp = h + base;
  float hv = 0.0f;
  int t = 0;
  for (; t + kChunk <= S; t += kChunk) {
    float av[kChunk], bv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      av[u] = __ldg(ap + (t + u) * step);
      bv[u] = __ldg(bp + (t + u) * step);
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      hv = __fmaf_rn(av[u], hv, bv[u]);
      hp[(t + u) * step] = hv;
    }
  }
  for (; t < S; ++t) {
    const int64_t off = t * step;
    hv = __fmaf_rn(__ldg(ap + off), hv, __ldg(bp + off));
    hp[off] = hv;
  }
}

}  // namespace

extern "C" {

int ssm_scan_f32(const void* a, const void* b, void* h, int B, int S, int DN,
                 void* stream) {
  if (B <= 0 || S <= 0 || DN <= 0) return static_cast<int>(cudaSuccess);
  const dim3 grid((DN + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(h), S, DN);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
