// frame_accum: the sum of W worker frames, (W, n) -> (n,)  (Alg. 2 line 27).
//
// Replaces repro/kernels/frame_accum.py::frame_accum (Pallas, TPU).  There a
// grid step loaded a (W, BLOCK_N) tile into VMEM and summed it over W.  Here
// a thread owns one 16-byte vector of columns (4 int32 or f32, 8 bf16) and
// walks the W rows; nothing is carried between blocks.
// Accumulation is in int32 for int32 frames and in f32 for f32 and bf16
// frames, cast back to the input type (bf16 rounded once), as the reference
// does.  The order is w = 0, 1, ..., W - 1 from 0, with no atomics and no
// tree, so f32 and bf16 results are the plain left-to-right sum bit for bit
// and INDEXED_FRAME's totals do not depend on how the frames were split.
//
// Bound by bytes: (W + 1) * n * itemsize moved (each input element read once,
// each output element written once) and W - 1 adds per column: 0.00626 ms at
// (4, 2^20) int32 and 0.1002 ms at (4, 2^24) on an H100 SXM (3.35 TB/s).
// The first port (one thread a column, W scalar 4-byte loads in a loop over
// a runtime W, a block for every 256 columns) reached 43 % of it at 2^20.
// This design:
//   - 16-byte vectors, chosen by the entry point when the base pointers of
//     frames and out are 16-byte aligned and n is a multiple of the vector
//     width (so every row starts aligned); else the element-wise
//     instantiation of the same kernel (a choice by shape, not a fallback);
//   - W at run time, the loop over it unrolled by 4: the loads of a vector
//     do not depend on the sum, so they are issued together.  A body with W
//     a template parameter (1, 2, 4, 8) was no faster at the paths'
//     (4, 2^20) and (4, 2^24), beyond the spread of its runs, and slower at
//     W = 2 and 8;
//   - read-only loads (ld.global.nc).  Streaming loads (ld.global.cs, and
//     .cs.nc or .nc.L1::no_allocate alike) were faster at (4, 2^20) but
//     slower at (4, 2^24), where they fell behind the first port in most
//     runs; .nc was ahead of the first port at both shapes in every run;
//   - one vector a thread, a block for every 256 vectors; a frame of at
//     most one block's worth of vectors runs as one block.  A grid-stride
//     loop with the grid capped at one or four waves, and two vectors a
//     thread, were no faster at those two shapes.
// Those trials ran on an H100 SXM at 700 W (PERF.md).
// What is left at the two shapes is the memory system and the launch:
// src/repro_torch/launch/time_kernels.py times the kernel also after an L2
// flush that leaves clean lines, beside the usual one that leaves the
// 256 MB it zeroes dirty in L2 for the kernel's reads to write back.
// Frames of a few elements (most calls on the conformance path) are bound by
// the host's time a call, not by this kernel.
//
// Plain C entry points, one per dtype, return the launch's cudaError_t; the
// Python wrapper (repro_torch/kernels/frame_accum.py) raises if it is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int to_acc(int x) { return x; }
__device__ __forceinline__ float to_acc(float x) { return x; }
__device__ __forceinline__ float to_acc(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_acc(int x);
template <typename T> __device__ __forceinline__ T from_acc(float x);
template <> __device__ __forceinline__ int from_acc<int>(int x) { return x; }
template <> __device__ __forceinline__ float from_acc<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_acc<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}

// kVec elements of T: one 16-byte vector (kVec * sizeof(T) == 16) or one
// element (kVec == 1).
template <typename T, int kVec>
struct alignas(kVec == 1 ? alignof(T) : 16) Pack {
  T v[kVec];
};

template <typename T, int kVec>
__device__ __forceinline__ Pack<T, kVec> load_nc(const T* p) {
  Pack<T, kVec> r;
  if constexpr (kVec == 1) {
    if constexpr (sizeof(T) == 4) {
      const int bits = __ldg(reinterpret_cast<const int*>(p));
      r.v[0] = *reinterpret_cast<const T*>(&bits);
    } else {
      const unsigned short bits = __ldg(reinterpret_cast<const unsigned short*>(p));
      r.v[0] = *reinterpret_cast<const T*>(&bits);
    }
  } else {
    static_assert(kVec * sizeof(T) == 16, "one 16-byte vector");
    const int4 bits = __ldg(reinterpret_cast<const int4*>(p));
    r = *reinterpret_cast<const Pack<T, kVec>*>(&bits);
  }
  return r;
}

template <typename T, int kVec>
__device__ __forceinline__ void store(T* p, const Pack<T, kVec>& r) {
  if constexpr (kVec == 1)
    *p = r.v[0];
  else
    *reinterpret_cast<int4*>(p) = *reinterpret_cast<const int4*>(&r);
}

// frames is (W, n), every row cut into `units` units of kVec elements, one
// a thread.  The loads of a unit do not depend on the sum, so the unrolled
// loop issues them together.
template <typename T, typename Acc, int kVec>
__global__ void __launch_bounds__(kThreads)
    frame_accum_kernel(const T* __restrict__ frames, T* __restrict__ out, int W,
                       int64_t n, int64_t units) {
  const int64_t u = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (u >= units) return;
  const T* col = frames + u * kVec;
  Acc acc[kVec];
#pragma unroll
  for (int e = 0; e < kVec; ++e) acc[e] = 0;
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    const Pack<T, kVec> x = load_nc<T, kVec>(col + w * n);
#pragma unroll
    for (int e = 0; e < kVec; ++e) acc[e] += to_acc(x.v[e]);
  }
  Pack<T, kVec> r;
#pragma unroll
  for (int e = 0; e < kVec; ++e) r.v[e] = from_acc<T>(acc[e]);
  store<T, kVec>(out + u * kVec, r);
}

template <typename T, typename Acc, int kVec>
cudaError_t launch_vec(const T* frames, T* out, int W, int64_t n, cudaStream_t stream) {
  const int64_t units = n / kVec;
  const auto blocks = static_cast<unsigned>((units + kThreads - 1) / kThreads);
  frame_accum_kernel<T, Acc, kVec><<<blocks, kThreads, 0, stream>>>(frames, out, W, n, units);
  return cudaGetLastError();
}

template <typename T, typename Acc>
cudaError_t launch(const void* frames, void* out, int W, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  constexpr int kVec = 16 / sizeof(T);
  const auto* f = static_cast<const T*>(frames);
  auto* o = static_cast<T*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  const bool aligned = reinterpret_cast<uintptr_t>(f) % 16 == 0 &&
                       reinterpret_cast<uintptr_t>(o) % 16 == 0 && n % kVec == 0;
  return aligned ? launch_vec<T, Acc, kVec>(f, o, W, n, s)
                 : launch_vec<T, Acc, 1>(f, o, W, n, s);
}

}  // namespace

extern "C" {

int frame_accum_i32(const void* frames, void* out, int W, long long n, void* stream) {
  return static_cast<int>(launch<int, int>(frames, out, W, n, stream));
}

int frame_accum_f32(const void* frames, void* out, int W, long long n, void* stream) {
  return static_cast<int>(launch<float, float>(frames, out, W, n, stream));
}

int frame_accum_bf16(const void* frames, void* out, int W, long long n, void* stream) {
  return static_cast<int>(launch<__nv_bfloat16, float>(frames, out, W, n, stream));
}

}  // extern "C"
