// alias_draw: batched Walker/Vose alias-table draws (the wrs workload's SAMPLE()).
//
// For every draw i:  bucket = min(trunc_f32(u1[i] * n), n - 1);
//                    idx[i] = bucket if u2[i] < prob[bucket] else alias[bucket].
//
// Replaces repro/kernels/alias_draw.py::alias_draw (Pallas, TPU).  There the
// prob/alias table stayed resident in VMEM across a serial grid over draw
// blocks, which capped the table at about 2 M buckets.  Here the table stays
// in device memory and is read through the 50 MB L2, so there is no cap.
//
// Bit-exact with the reference's jnp.minimum((u1 * n).astype(int32), n - 1):
// the product is one f32 multiply rounded to nearest (__fmul_rn, never
// contracted or widened to double), truncated toward zero (__float2int_rz)
// and clamped, because for u1 just below 1 and n not a power of two u1 * n
// rounds up to n.  The comparison is strict (u2 < prob).  The lower clamp at
// 0 only guards the gathers against inputs outside [0, 1).
//
// Bound on the H100: 12 B a draw are streamed (u1, u2, idx), and the table
// is read in 32-byte sectors: each distinct sector of prob that a draw
// touches, and each distinct sector of alias that a rejected draw touches,
// read once.  At the wrs path's 262,144 draws on its 2^24-bucket table
// (128 MB, larger than the 50 MB L2) nearly every gather is a sector of
// its own; at 2^24 draws every sector of both arrays is touched, and the
// bound is ~329 MB, ~0.1 ms.  Draws reach that only if the draws of one
// sector meet in L2, and in random order they do not: the kernel pays one
// DRAM access for each gather (the probes of launch/time_kernels.py, and
// PERF.md), and only draws taken in bucket order would pay less.  The
// first kernel (one draw a thread, scalar loads) issued the alias gather
// only once prob[bucket] had arrived and been compared, and a thread had
// one draw's gathers in flight.
//
// The design: a thread makes kDraws = 4 consecutive draws.  It loads their
// uniforms (one float4 of u1 and of u2 where u1, u2 and idx are 16-byte
// aligned and all four draws lie below b, else four scalar loads),
// computes the four buckets, issues the four prob gathers together, and
// then the alias gathers of its rejected draws together: a thread has
// four draws' gathers in flight.  Issuing every alias gather with the
// prob gathers (one round trip, but a sector more for each accepted draw)
// measured no faster on the card at 2^18 to 2^24 draws, so a rejected
// draw's alias is read only once prob has said so.  Blocks of 128
// threads, at most 8 an SM: 262,144 draws are 512 blocks, one wave over
// all 132 SMs.
//
// Plain C entry point; returns the launch's cudaError_t, and the Python
// wrapper (repro_torch/kernels/alias_draw.py) raises if it is not 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kDraws = 4;      // consecutive draws a thread
constexpr int kThreads = 128;
constexpr int64_t kMaxBlocks = 132 * 8;        // 8 blocks of 128 an SM

// vec: u1, u2 and idx are 16-byte aligned, so a thread's four draws are
// one float4 of each and one int4 of idx.
__global__ void __launch_bounds__(kThreads)
    alias_draw_kernel(const float* __restrict__ prob,
                      const int* __restrict__ alias,
                      const float* __restrict__ u1,
                      const float* __restrict__ u2, int* __restrict__ idx,
                      int n, int64_t b, bool vec) {
  const float nf = __int2float_rn(n);
  const int64_t groups = (b + kDraws - 1) / kDraws;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t g = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       g < groups; g += stride) {
    const int64_t pos = g * kDraws;
    const bool whole = vec && pos + kDraws <= b;
    float x1[kDraws], x2[kDraws];
    if (whole) {
      const float4 v1 = reinterpret_cast<const float4*>(u1)[g];
      const float4 v2 = reinterpret_cast<const float4*>(u2)[g];
      x1[0] = v1.x; x1[1] = v1.y; x1[2] = v1.z; x1[3] = v1.w;
      x2[0] = v2.x; x2[1] = v2.y; x2[2] = v2.z; x2[3] = v2.w;
    } else {
#pragma unroll
      for (int r = 0; r < kDraws; ++r) {
        const bool in = pos + r < b;  // past b: bucket 0, never stored
        x1[r] = in ? u1[pos + r] : 0.0f;
        x2[r] = in ? u2[pos + r] : 0.0f;
      }
    }
    int bucket[kDraws], out[kDraws];
    float keep_below[kDraws];
#pragma unroll
    for (int r = 0; r < kDraws; ++r) {
      bucket[r] = min(max(__float2int_rz(__fmul_rn(x1[r], nf)), 0), n - 1);
    }
#pragma unroll
    for (int r = 0; r < kDraws; ++r) keep_below[r] = __ldg(prob + bucket[r]);
#pragma unroll
    for (int r = 0; r < kDraws; ++r) {
      out[r] = x2[r] < keep_below[r] ? bucket[r] : __ldg(alias + bucket[r]);
    }
    if (whole) {
      reinterpret_cast<int4*>(idx)[g] =
          make_int4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int r = 0; r < kDraws; ++r) {
        if (pos + r < b) idx[pos + r] = out[r];
      }
    }
  }
}

}  // namespace

extern "C" {

int alias_draw_f32(const void* prob, const void* alias, const void* u1,
                   const void* u2, void* idx, int n, long long b, void* stream) {
  if (b <= 0) return static_cast<int>(cudaSuccess);
  const int64_t groups = (b + kDraws - 1) / kDraws;
  int64_t blocks = (groups + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const auto bits = reinterpret_cast<uintptr_t>(u1) |
                    reinterpret_cast<uintptr_t>(u2) |
                    reinterpret_cast<uintptr_t>(idx);
  alias_draw_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(prob), static_cast<const int*>(alias),
      static_cast<const float*>(u1), static_cast<const float*>(u2),
      static_cast<int*>(idx), n, b, bits % 16 == 0);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
