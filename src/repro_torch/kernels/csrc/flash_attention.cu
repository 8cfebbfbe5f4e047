// flash_attention: causal grouped-query attention with an optional sliding
// window and a streaming softmax, in float32 arithmetic.
//
//   o[b, h, q] = Σ_k softmax_k(q·k / √hd over admissible k) · v[b, h/G, k]
//   admissible: k ≤ q, and k > q − window when window > 0;  G = H / KV.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (Pallas, TPU).
// There a sequential grid (B, H, q blocks, kv blocks) carried the softmax
// state (m, l, acc) in VMEM scratch from one kv step to the next.  Blocks of
// a CUDA grid run in parallel in no order, so here one block owns one
// (b, h, query tile) and walks its kv tiles in a loop, in ascending order,
// with (m, l) in registers and acc spread over the block's registers.  Kv
// tiles wholly in the future or wholly outside the window are never
// visited (the Pallas kernel's `live` guard, :44-47).  GQA is the index
// map's h // G: query head h reads kv head h / G.
//
// Numerics as the Pallas body: q, k, v are widened to float32, the scores
// are the f32 dot times 1/√hd, the softmax statistics, the probabilities
// and the accumulator stay f32, and the output is rounded once to q's type.
// A masked score is −inf, and a row whose maximum is still −inf after a
// tile (no admissible key seen yet) takes p = 0 and keeps its state, so no
// garbage from a fully masked row ever enters acc (the Pallas kernel uses a
// finite −1e30 and relies on a later tile's corr = 0 to wipe it).  The last
// query tile and the last kv tile may be ragged: rows past S are loaded as
// zeros and not stored, keys past S are zeros and masked.
//
// Layout: each tensor is given by its base pointer and its strides (in
// elements) over (b, head, position); the head dimension must be
// contiguous.  The model passes its (B, S, H, hd) projections as
// (B, H, S, hd) views, so no transpose is copied.
//
// Bound on the H100 at the full-width prefill of recurrentgemma-2b
// (B=2, H=10, KV=1, S=4096, hd=256, window 2048): 1.26e8 admissible (q, k)
// pairs, 4·hd flops each, 1.29e11 flops: 0.13 ms at the bf16 tensor-core
// rate, 1.9 ms at the f32 rate of the CUDA cores that this scalar kernel
// uses; about 92 MB of bytes, 0.027 ms.  It is bound by operations, and,
// being scalar, by the f32 rate and by its shared-memory loads: the
// products read q rows as broadcast float4s and K transposed (padded, so
// conflict-free), P·V reads P as broadcast float4s and V row-major.  Tensor
// cores (wgmma), TMA loads and reuse of a K/V tile across the G query heads
// of a group are later PRs' work.
//
// Plain C entry points; each returns the launch's cudaError_t, and the
// Python wrapper (repro_torch/kernels/flash_attention.py) raises if it is
// not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;            // query rows of a block
constexpr int kBK = 32;            // keys of a kv tile (one per lane)
constexpr int kRowsPerWarp = kBQ / kWarps;

struct Strides {                   // (b, head, position) strides in elements
  long long q[3], k[3], v[3], o[3];
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as astype
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int HD>
constexpr int smem_floats() {
  // Q tile, K tile transposed (rows padded to kBK + 1), V tile, P, corr, l
  return kBQ * HD + HD * (kBK + 1) + kBK * HD + kBQ * kBK + 2 * kBQ;
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int group, int window, float scale, Strides st) {
  static_assert(HD % 32 == 0 && kThreads % HD == 0, "head dim 32 … 256");
  constexpr int kRowGroups = kThreads / HD;        // 1, 2, 4 or 8
  constexpr int kRowsPerThread = kBQ / kRowGroups;  // 64, 32, 16 or 8

  extern __shared__ float4 smem4[];
  float* Qs = reinterpret_cast<float*>(smem4);     // [kBQ][HD]
  float* Kt = Qs + kBQ * HD;                       // [HD][kBK + 1]
  float* Vs = Kt + HD * (kBK + 1);                 // [kBK][HD]
  float* Ps = Vs + kBK * HD;                       // [kBQ][kBK]
  float* corr_s = Ps + kBQ * kBK;                  // [kBQ]
  float* l_s = corr_s + kBQ;                       // [kBQ]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y, bi = blockIdx.z;
  const int hk = h / group;
  const T* qb = q + bi * st.q[0] + h * st.q[1];
  const T* kb = k + bi * st.k[0] + hk * st.k[1];
  const T* vb = v + bi * st.v[0] + hk * st.v[1];
  T* ob = o + bi * st.o[0] + h * st.o[1];

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qp = q0 + r;
    Qs[idx] = qp < S ? to_f32(qb[qp * st.q[2] + d]) : 0.0f;
  }

  // softmax state of this warp's rows, held alike by all 32 lanes
  float m[kRowsPerWarp], l[kRowsPerWarp];
#pragma unroll
  for (int i = 0; i < kRowsPerWarp; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  // acc[i] is row g + kRowGroups*i, column c
  const int c = tid % HD, g = tid / HD;
  float acc[kRowsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) acc[i] = 0.0f;

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int kt_hi = q_last / kBK;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    __syncthreads();  // the previous tile's P·V has read Vs and Ps
    for (int idx = tid; idx < kBK * HD; idx += kThreads) {
      const int j = idx / HD, d = idx % HD;
      const int kp = k0 + j;
      const bool in = kp < S;
      Kt[d * (kBK + 1) + j] = in ? to_f32(kb[kp * st.k[2] + d]) : 0.0f;
      Vs[idx] = in ? to_f32(vb[kp * st.v[2] + d]) : 0.0f;
    }
    __syncthreads();

    // scores: warp w, lane j → rows w*kRowsPerWarp + i, key k0 + j
    float s[kRowsPerWarp];
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) s[i] = 0.0f;
    const float* qrow = Qs + warp * kRowsPerWarp * HD;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      const float k_0 = Kt[(d + 0) * (kBK + 1) + lane];
      const float k_1 = Kt[(d + 1) * (kBK + 1) + lane];
      const float k_2 = Kt[(d + 2) * (kBK + 1) + lane];
      const float k_3 = Kt[(d + 3) * (kBK + 1) + lane];
#pragma unroll
      for (int i = 0; i < kRowsPerWarp; ++i) {
        const float4 q4 = *reinterpret_cast<const float4*>(qrow + i * HD + d);
        s[i] += q4.x * k_0 + q4.y * k_1 + q4.z * k_2 + q4.w * k_3;
      }
    }

    const int kp = k0 + lane;
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) {
      const int r = warp * kRowsPerWarp + i;
      const int qp = q0 + r;
      const bool ok = kp <= qp && kp < S && (window <= 0 || kp > qp - window);
      const float sc = ok ? s[i] * scale : -INFINITY;
      const float m_new = fmaxf(m[i], warp_max(sc));
      float p = 0.0f, corr = 1.0f;
      if (m_new != -INFINITY) {  // some admissible key seen in this row
        p = expf(sc - m_new);
        corr = expf(m[i] - m_new);
      }
      l[i] = l[i] * corr + warp_sum(p);
      m[i] = m_new;
      Ps[r * kBK + lane] = p;
      if (lane == 0) corr_s[r] = corr;
    }
    __syncthreads();

    // acc = acc·corr + P·V
    float vr[kBK];
#pragma unroll
    for (int j = 0; j < kBK; ++j) vr[j] = Vs[j * HD + c];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      const int r = g + kRowGroups * i;
      const float* prow = Ps + r * kBK;
      float a = acc[i] * corr_s[r];
#pragma unroll
      for (int j = 0; j < kBK; j += 4) {
        const float4 p4 = *reinterpret_cast<const float4*>(prow + j);
        a += p4.x * vr[j] + p4.y * vr[j + 1] + p4.z * vr[j + 2] + p4.w * vr[j + 3];
      }
      acc[i] = a;
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsPerWarp; ++i) l_s[warp * kRowsPerWarp + i] = l[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = g + kRowGroups * i;
    const int qp = q0 + r;
    if (qp < S) ob[qp * st.o[2] + c] = from_f32<T>(acc[i] / fmaxf(l_s[r], 1e-30f));
  }
}

template <typename T, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int S, int window, const long long* strides,
           cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * 4;
  auto kernel = flash_attention_kernel<T, HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), S, H / KV, window,
      1.0f / sqrtf(static_cast<float>(HD)), st);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int S, int hd, int window,
             const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<T, 32>(q, k, v, o, B, H, KV, S, window, strides, s);
    case 64: return launch<T, 64>(q, k, v, o, B, H, KV, S, window, strides, s);
    case 128: return launch<T, 128>(q, k, v, o, B, H, KV, S, window, strides, s);
    case 256: return launch<T, 256>(q, k, v, o, B, H, KV, S, window, strides, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 12 values, (b, head, position) of q, k, v and o, in elements.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int S, int hd, int window,
                        const long long* strides, void* stream) {
  return dispatch<float>(q, k, v, o, B, H, KV, S, hd, window, strides, stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int S, int hd, int window,
                         const long long* strides, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, B, H, KV, S, hd, window, strides,
                                 stream);
}

}  // extern "C"
