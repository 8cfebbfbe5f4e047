// alias_draw: batched Walker/Vose alias-table draws (the wrs workload's SAMPLE()).
//
// For every draw i:  bucket = min(trunc_f32(u1[i] * n), n - 1);
//                    idx[i] = bucket if u2[i] < prob[bucket] else alias[bucket].
//
// Replaces repro/kernels/alias_draw.py::alias_draw (Pallas, TPU).  There the
// prob/alias table stayed resident in VMEM across a serial grid over draw
// blocks, which capped the table at about 2 M buckets.  Here the table stays
// in device memory and is read through the 50 MB L2, so there is no cap: one
// thread per draw in a grid-stride loop.  The loads of u1/u2 and the store of
// idx are coalesced; the table reads are __ldg gathers, and alias[bucket] is
// read only for a rejected draw.
//
// Bit-exact with the reference's jnp.minimum((u1 * n).astype(int32), n - 1):
// the product is one f32 multiply rounded to nearest (__fmul_rn, never
// contracted or widened to double), truncated toward zero (__float2int_rz)
// and clamped, because for u1 just below 1 and n not a power of two u1 * n
// rounds up to n.  The comparison is strict (u2 < prob).  The lower clamp at
// 0 only guards the gathers against inputs outside [0, 1).
//
// Bound by bytes: 12 B a draw are streamed (u1, u2, idx) plus 8 B for each
// distinct bucket touched.  Once the table is larger than L2 the random
// 4-byte gathers each cost a 32-byte sector, which is the realistic limit.
//
// Plain C entry point; returns the launch's cudaError_t, and the Python
// wrapper (repro_torch/kernels/alias_draw.py) raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

__global__ void alias_draw_kernel(const float* __restrict__ prob,
                                  const int* __restrict__ alias,
                                  const float* __restrict__ u1,
                                  const float* __restrict__ u2,
                                  int* __restrict__ idx, int n, int64_t b) {
  const float nf = __int2float_rn(n);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < b; i += stride) {
    int bucket = __float2int_rz(__fmul_rn(u1[i], nf));
    bucket = min(max(bucket, 0), n - 1);
    const float keep_below = __ldg(prob + bucket);
    idx[i] = (u2[i] < keep_below) ? bucket : __ldg(alias + bucket);
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 16;  // 16 blocks of 256 on each of 132 SMs

}  // namespace

extern "C" {

int alias_draw_f32(const void* prob, const void* alias, const void* u1,
                   const void* u2, void* idx, int n, long long b, void* stream) {
  if (b <= 0) return static_cast<int>(cudaSuccess);
  int64_t blocks = (b + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  alias_draw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prob), static_cast<const int*>(alias),
      static_cast<const float*>(u1), static_cast<const float*>(u2),
      static_cast<int*>(idx), n, b);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
