// flash_attention: causal grouped-query attention with an optional sliding
// window and a streaming softmax.
//
//   o[b, h, q] = Σ_k softmax_k(q·k / √hd over admissible k) · v[b, h/G, k]
//   admissible: k ≤ q, and k > q − window when window > 0;  G = H / KV.
//
// Replaces repro/kernels/flash_attention.py::flash_attention (Pallas, TPU).
// There a sequential grid (B, H, q blocks, kv blocks) carried the softmax
// state (m, l, acc) in VMEM scratch from one kv step to the next.  Blocks of
// a CUDA grid run in parallel in no order, so here one block owns one
// (b, h, 64-query tile) and walks its kv tiles in a loop, in ascending
// order, with the state in registers.  Kv tiles wholly in the future or
// wholly outside the window are never visited (the Pallas kernel's `live`
// guard, :44-47).  GQA is the index map's h // G: query head h reads kv
// head h / G.  A masked score is −inf, and a row whose maximum is still −inf
// after a tile (no admissible key seen yet) takes p = 0 and keeps its state
// (the Pallas kernel uses a finite −1e30 and relies on a later tile's
// corr = 0 to wipe it).  Ragged S: rows past S are loaded as zeros and not
// stored, keys past S are zeros and masked.
//
// Layout: each tensor is given by its base pointer and its strides (in
// elements) over (b, head, position); the head dimension must be
// contiguous.  The model passes its (B, S, H, hd) projections as
// (B, H, S, hd) views, so no transpose is copied.
//
// Two bodies, chosen by dtype at the entry point (not a fallback):
//
// bf16 — tensor cores.  What bounds it on an H100: at recurrentgemma-2b's
// prefill (B=2, H=10, KV=1, S=4096, hd=256, window 2048) 1.26e8 admissible
// (q, k) pairs, 4·hd flops each, 1.29e11 flops: 0.13 ms at the bf16
// tensor-core rate, against ~92 MB of bytes (0.027 ms), so operations.  The
// first port ran this on the CUDA cores in f32 (1.9 ms at their rate) and
// took 8.3 ms.  This body runs Q·Kᵀ and P·V as mma.sync.m16n8k16 (bf16 in,
// f32 accumulate; HMMA in the SASS), FlashAttention-2's warp layout:
//   - 4 warps, 16 query rows each; Q (64 × hd) is copied once into shared
//     memory and read per 16-wide k-step with ldmatrix;
//   - K and V tiles of BK keys (64, or 32 at hd = 256) come in by cp.async
//     (16 bytes a copy, zero-filled past S) into a two-stage ring: tile t+1
//     is in flight while tile t is multiplied; one block barrier a tile
//     both publishes the landed tile and frees the other stage;
//   - S = Q·Kᵀ stays in registers (the mma's f32 accumulators), is masked
//     only on tiles that cross the diagonal, the window's edge or S, and the
//     softmax runs on it in f32 in the log2 domain (exp2f, scale·log2 e);
//     m and l are f32; the row max takes two quad shuffles;
//   - P is rounded to bf16 for the P·V product (the accumulators of S are
//     exactly the A fragments of P·V), as tensor-core flash kernels do; l
//     sums the f32 probabilities; the f32 output accumulator (hd/2 registers
//     a thread) is scaled by exp2(m_old − m_new) per tile;
//   - shared-memory rows are padded by 16 bytes, so ldmatrix's eight rows
//     fall in distinct banks;
//   - query tiles are launched longest first (the last tiles of a causal
//     row have the most kv tiles).
//   Shared memory (dynamic): (64 + 4·BK)·(hd + 8)·2 bytes: 25,600 at hd 32,
//   46,080 at 64, 87,040 at 128, 101,376 at 256, two blocks an SM.
//   Registers (nvcc -Xptxas -v for sm_90a, launch bounds 128 threads and 2
//   blocks an SM): 114 at hd 32, 153 at 64, 222 at 128, 254 at 256, no
//   spills; the build phase of chip_smoke.py prints them and counts the
//   HMMAs in the SASS.  wgmma (64-row warpgroup products, the card's full
//   rate), TMA with mbarriers instead of a block barrier a tile, and reuse
//   of a K/V tile across the G query heads of a group are left to later work.
//
// f32 — the CUDA cores, as ported first: q, k, v, scores, probabilities and
// acc all f32 (the Pallas body's numerics); 8 warps, 32-key tiles loaded
// synchronously, K transposed in shared memory; 178 registers at hd 256.
// It is bound by the f32 core rate (1.92 ms at the prefill shape) and was
// already faster there than scaled_dot_product_attention in f32.
//
// Plain C entry points; each returns the launch's cudaError_t, and the
// Python wrapper (repro_torch/kernels/flash_attention.py) raises if it is
// not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

struct Strides {                   // (b, head, position) strides in elements
  long long q[3], k[3], v[3], o[3];
};

// ---------------------------------------------------------------- f32 body

constexpr int kThreads = 256;      // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kBQ = 64;            // query rows of a block (both bodies)
constexpr int kBK = 32;            // keys of a kv tile (one per lane)
constexpr int kRowsPerWarp = kBQ / kWarps;

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

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, int S,
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
  const float* qb = q + bi * st.q[0] + h * st.q[1];
  const float* kb = k + bi * st.k[0] + hk * st.k[1];
  const float* vb = v + bi * st.v[0] + hk * st.v[1];
  float* ob = o + bi * st.o[0] + h * st.o[1];

  for (int idx = tid; idx < kBQ * HD; idx += kThreads) {
    const int r = idx / HD, d = idx % HD;
    const int qp = q0 + r;
    Qs[idx] = qp < S ? qb[qp * st.q[2] + d] : 0.0f;
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
      Kt[d * (kBK + 1) + j] = in ? kb[kp * st.k[2] + d] : 0.0f;
      Vs[idx] = in ? vb[kp * st.v[2] + d] : 0.0f;
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
    if (qp < S) ob[qp * st.o[2] + c] = acc[i] / fmaxf(l_s[r], 1e-30f);
  }
}

// --------------------------------------------------------- bf16 tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;      // 4 warps × 16 query rows
constexpr unsigned kFull = 0xffffffffu;

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 32 : 64;   // keys of a kv tile
  static constexpr int LD = HD + 8;                // padded row, in bf16
  static constexpr int kSmemBytes = (kBQ + 4 * BK) * LD * 2;  // Q, 2×(K, V)
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool in) {
  const int bytes = in ? 16 : 0;  // 0: the 16 bytes are zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

// d += a·b for a 16×16 bf16 A (row), a 16×8 bf16 B (col), f32 D
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 p = __floats2bfloat162_rn(lo, hi);  // .x in the low half
  return *reinterpret_cast<const uint32_t*>(&p);
}

// ROWS rows of hd bf16 from rows row0… of a strided tensor into a padded
// shared tile, by cp.async; rows at or past S are zero-filled.
template <int HD, int ROWS>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long stride, int row0, int S,
                                          int tid) {
  constexpr int kChunks = HD / 8;  // 16-byte copies a row
  static_assert(ROWS * kChunks % kThreads == 0, "whole copies a thread");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = i % kChunks;
    const int pos = row0 + r;
    const bool in = pos < S;
    cp_async16(smem_u32(tile + r * Cfg<HD>::LD + c * 8),
               src + (in ? pos : 0) * stride + c * 8, in);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                  int group, int window, float scale_log2, Strides st) {
  constexpr int BK = Cfg<HD>::BK, LD = Cfg<HD>::LD;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [kBQ][LD]
  bf16* Ks = Qs + kBQ * LD;                      // [2][BK][LD]
  bf16* Vs = Ks + 2 * BK * LD;                   // [2][BK][LD]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gq = lane / 4, tq = lane % 4;        // the mma's group, thread
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, bi = blockIdx.z, hk = h / group;
  const bf16* qb = q + bi * st.q[0] + h * st.q[1];
  const bf16* kb = k + bi * st.k[0] + hk * st.k[1];
  const bf16* vb = v + bi * st.v[0] + hk * st.v[1];
  bf16* ob = o + bi * st.o[0] + h * st.o[1];

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BK : 0;
  const int kt_hi = q_last / BK;

  load_tile<HD, kBQ>(Qs, qb, st.q[2], q0, S, tid);
  load_tile<HD, BK>(Ks, kb, st.k[2], kt_lo * BK, S, tid);
  load_tile<HD, BK>(Vs, vb, st.v[2], kt_lo * BK, S, tid);
  cp_async_commit();

  // this thread's rows of the output: r0 = q0 + 16·warp + gq, r1 = r0 + 8
  const int r0 = q0 + warp * 16 + gq, r1 = r0 + 8;
  float acc[HD / 8][4];
#pragma unroll
  for (int i = 0; i < HD / 8; ++i)
    acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY;  // running max, log2 domain
  float l0 = 0.0f, l1 = 0.0f;            // this thread's part of the row sums

  // ldmatrix addresses of this lane: Q rows, K rows, V rows (see the mma
  // fragment layouts: A row-major 16×16, B = Kᵀ and V as 8×8 quarters)
  const bf16* q_lane = Qs + (warp * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int k_row = lane % 8 + (lane / 16) * 8, k_col = ((lane / 8) % 2) * 8;
  const int v_row = lane % 8 + ((lane / 8) % 2) * 8, v_col = (lane / 16) * 8;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt is visible; every warp is done with kt − 1
    if (kt < kt_hi) {
      const int next = (stage ^ 1) * BK * LD;
      load_tile<HD, BK>(Ks + next, kb, st.k[2], (kt + 1) * BK, S, tid);
      load_tile<HD, BK>(Vs + next, vb, st.v[2], (kt + 1) * BK, S, tid);
    }
    cp_async_commit();
    const bf16* Kc = Ks + stage * BK * LD;
    const bf16* Vc = Vs + stage * BK * LD;

    // s = Q·Kᵀ, a 16 × BK tile a warp, in the mma's f32 accumulators
    float s[BK / 8][4];
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.0f;
#pragma unroll
    for (int kk = 0; kk < HD; kk += 16) {
      uint32_t a[4];
      ldmatrix_x4(a, smem_u32(q_lane + kk));
#pragma unroll
      for (int j = 0; j < BK / 8; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, smem_u32(Kc + (j * 8 + k_row) * LD + kk + k_col));
        mma_bf16(s[j], a, b[0], b[1]);
        mma_bf16(s[j + 1], a, b[2], b[3]);
      }
    }

    // mask (only tiles that cross the diagonal, the window's edge or S)
    const int k0 = kt * BK;
    const bool inside = k0 + BK - 1 <= q0 && k0 + BK <= S &&
                        (window <= 0 || k0 > q_last - window);
    float t0 = -INFINITY, t1 = -INFINITY;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[j][e] * scale_log2;
        if (!inside) {
          const int kp = k0 + j * 8 + 2 * tq + (e & 1);
          const int r = e < 2 ? r0 : r1;
          const bool ok = kp <= r && kp < S && (window <= 0 || kp > r - window);
          x = ok ? x : -INFINITY;
        }
        s[j][e] = x;
      }
      t0 = fmaxf(t0, fmaxf(s[j][0], s[j][1]));
      t1 = fmaxf(t1, fmaxf(s[j][2], s[j][3]));
    }
    t0 = fmaxf(t0, __shfl_xor_sync(kFull, t0, 1));
    t0 = fmaxf(t0, __shfl_xor_sync(kFull, t0, 2));
    t1 = fmaxf(t1, __shfl_xor_sync(kFull, t1, 1));
    t1 = fmaxf(t1, __shfl_xor_sync(kFull, t1, 2));
    const float mn0 = fmaxf(m0, t0), mn1 = fmaxf(m1, t1);
    // a row with no admissible key yet: base 0 gives p = exp2(−inf) = 0
    // and corr = 0 on a state that is still all zeros
    const float base0 = mn0 == -INFINITY ? 0.0f : mn0;
    const float base1 = mn1 == -INFINITY ? 0.0f : mn1;
    const float corr0 = exp2f(m0 - base0), corr1 = exp2f(m1 - base1);
    m0 = mn0;
    m1 = mn1;

    // p, rounded to bf16 as the A fragments of P·V (k-step js covers the
    // accumulators of key tiles 2·js and 2·js + 1)
    uint32_t pa[BK / 16][4];
    float ls0 = 0.0f, ls1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      const float p0 = exp2f(s[j][0] - base0), p1 = exp2f(s[j][1] - base0);
      const float p2 = exp2f(s[j][2] - base1), p3 = exp2f(s[j][3] - base1);
      ls0 += p0 + p1;
      ls1 += p2 + p3;
      pa[j / 2][(j % 2) * 2] = pack_bf16(p0, p1);
      pa[j / 2][(j % 2) * 2 + 1] = pack_bf16(p2, p3);
    }
    l0 = l0 * corr0 + ls0;
    l1 = l1 * corr1 + ls1;
#pragma unroll
    for (int i = 0; i < HD / 8; ++i) {
      acc[i][0] *= corr0;
      acc[i][1] *= corr0;
      acc[i][2] *= corr1;
      acc[i][3] *= corr1;
    }

    // acc += P·V
#pragma unroll
    for (int js = 0; js < BK / 16; ++js) {
#pragma unroll
      for (int i = 0; i < HD / 8; i += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, smem_u32(Vc + (js * 16 + v_row) * LD + i * 8 + v_col));
        mma_bf16(acc[i], pa[js], b[0], b[1]);
        mma_bf16(acc[i + 1], pa[js], b[2], b[3]);
      }
    }
  }

  // the row sums over the quad, then one rounding of acc / l to bf16
  l0 += __shfl_xor_sync(kFull, l0, 1);
  l0 += __shfl_xor_sync(kFull, l0, 2);
  l1 += __shfl_xor_sync(kFull, l1, 1);
  l1 += __shfl_xor_sync(kFull, l1, 2);
  const float d0 = fmaxf(l0, 1e-30f), d1 = fmaxf(l1, 1e-30f);
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int col = i * 8 + 2 * tq;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * st.o[2] + col) =
          pack_bf16(acc[i][0] / d0, acc[i][1] / d0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * st.o[2] + col) =
          pack_bf16(acc[i][2] / d1, acc[i][3] / d1);
  }
}

}  // namespace tc

template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int S, int window, const Strides& st,
               cudaStream_t stream) {
  constexpr int bytes = smem_floats<HD>() * 4;
  auto kernel = flash_attention_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, H / KV, window,
      1.0f / sqrtf(static_cast<float>(HD)), st);
  return static_cast<int>(cudaGetLastError());
}

template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int S, int window, const Strides& st,
                cudaStream_t stream) {
  constexpr int bytes = tc::Cfg<HD>::kSmemBytes;
  auto kernel = tc::flash_bf16_kernel<HD>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, tc::kThreads, bytes, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), S, H / KV,
      window, 1.4426950408889634f / sqrtf(static_cast<float>(HD)), st);
  return static_cast<int>(cudaGetLastError());
}

template <bool kBf16, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int S, int window, const Strides& st, cudaStream_t stream) {
  if constexpr (kBf16)
    return launch_bf16<HD>(q, k, v, o, B, H, KV, S, window, st, stream);
  else
    return launch_f32<HD>(q, k, v, o, B, H, KV, S, window, st, stream);
}

template <bool kBf16>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int KV, int S, int hd, int window,
             const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  Strides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 32: return launch<kBf16, 32>(q, k, v, o, B, H, KV, S, window, st, s);
    case 64: return launch<kBf16, 64>(q, k, v, o, B, H, KV, S, window, st, s);
    case 128: return launch<kBf16, 128>(q, k, v, o, B, H, KV, S, window, st, s);
    case 256: return launch<kBf16, 256>(q, k, v, o, B, H, KV, S, window, st, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" {

// strides: 12 values, (b, head, position) of q, k, v and o, in elements.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int S, int hd, int window,
                        const long long* strides, void* stream) {
  return dispatch<false>(q, k, v, o, B, H, KV, S, hd, window, strides, stream);
}

// bf16 needs every base pointer 16-byte aligned and every stride a multiple
// of 8 elements (cp.async copies 16 bytes); the wrapper checks both.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int S, int hd, int window,
                         const long long* strides, void* stream) {
  return dispatch<true>(q, k, v, o, B, H, KV, S, hd, window, strides, stream);
}

}  // extern "C"
