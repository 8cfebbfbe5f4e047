// frame_accum: the sum of W worker frames, (W, n) -> (n,)  (Alg. 2 line 27).
//
// Replaces repro/kernels/frame_accum.py::frame_accum (Pallas, TPU).  There a
// grid step loaded a (W, BLOCK_N) tile into VMEM and summed it over W.  Here
// one thread owns one column j and walks the W rows: at every row the warp's
// 32 threads read 32 neighbouring elements, so every load is coalesced and
// nothing is carried between blocks.  Accumulation is in int32 for int32
// frames (exact, any order) and in f32 for f32 and bf16 frames, cast back to
// the input type, as the reference does.
//
// Bound by bytes: (W + 1) * n * itemsize moved (each input element read once,
// each output element written once) and W - 1 adds per column.
//
// Plain C entry points, one per dtype, return the launch's cudaError_t; the
// Python wrapper (repro_torch/kernels/frame_accum.py) raises if it is not 0.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

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

template <typename T, typename Acc>
__global__ void frame_accum_kernel(const T* __restrict__ frames, T* __restrict__ out,
                                   int W, int64_t n) {
  const int64_t j = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (j >= n) return;
  Acc acc = 0;
  for (int w = 0; w < W; ++w) acc += to_acc(frames[static_cast<int64_t>(w) * n + j]);
  out[j] = from_acc<T>(acc);
}

constexpr int kThreads = 256;

template <typename T, typename Acc>
cudaError_t launch(const void* frames, void* out, int W, int64_t n, void* stream) {
  if (n <= 0) return cudaSuccess;
  const int64_t blocks = (n + kThreads - 1) / kThreads;
  frame_accum_kernel<T, Acc><<<static_cast<unsigned>(blocks), kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(frames), static_cast<T*>(out), W, n);
  return cudaGetLastError();
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
