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
// Head dims: any hd from 1 to 256.  Each body is instantiated for a padded
// head dim HD ∈ {16, 32, 64, 128, 256} and runs the smallest HD ≥ hd: the
// hd real columns are loaded into shared rows of HD columns and the rest
// zero-filled, so the padding adds nothing to Q·Kᵀ, and its output columns
// are not stored.  The softmax scale is 1/√hd of the true hd.  The Pallas
// kernel's blocks span the whole head dim, so it takes any hd too.  The
// padding costs products: hd 120 runs as 128 (6.7 % of them wasted), hd 20
// as 32 (37.5 %).  Copies are as wide as the views' layout allows (pointers,
// strides and hd): 16 or 4 bytes in f32, 16, 8 or 4 in bf16 (smollm-360m's
// hd 20 with a position stride of 60 takes 8).
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
//     (16, 8 or 4 bytes a copy, zero-filled past S) into a two-stage ring: tile t+1
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
//   Shared memory (dynamic): (64 + 4·BK)·(HD + 8)·2 bytes: 15,360 at HD 16, 25,600 at 32,
//   46,080 at 64, 87,040 at 128, 101,376 at 256, two blocks an SM.
//   Registers (nvcc -Xptxas -v for sm_90a, launch bounds 128 threads and 2
//   blocks an SM): 114 at hd 32, 153 at 64, 222 at 128, 254 at 256, no
//   spills; the build phase of chip_smoke.py prints them and counts the
//   HMMAs in the SASS.  wgmma (64-row warpgroup products, the card's full
//   rate), TMA with mbarriers instead of a block barrier a tile, and reuse
//   of a K/V tile across the G query heads of a group are left to later work.
//
// f32 — the CUDA cores: q, k, v, scores, probabilities, m, l and acc all
// f32 (the Pallas body's numerics).  What bounds it on an H100: the same
// 1.29e11 flops at the prefill shape at the f32 core rate (67 TFLOP/s),
// 1.92 ms.  The first port reached 24 % of that (8.15 ms): its score loop
// made one shared load for every ~2.7 FMAs, its softmax ran full-warp
// reductions for 8 rows a tile, and K and V were loaded synchronously
// (K transposed on the way) with no overlap of load and compute.  This body
// is an SGEMM micro-kernel around a streaming softmax:
//   - 256 threads; warp w owns query rows 8w … 8w + 7 in both products, so
//     P and the row rescale pass between the two products inside the warp;
//   - S = Q·Kᵀ on a 64 × 64 tile: each thread computes 4 rows × 4 keys
//     from float4s of Q and K along hd (rows 4·tr + i, keys tc + 16·j):
//     8 shared loads for 64 FMAs; shared rows are padded by 16 bytes, so
//     the warp's Q loads (2 rows) and K loads (16 rows) hit distinct banks;
//   - the softmax in f32 in the log2 domain (exp2f, scale·log2 e in one
//     multiply); a row's max takes 4 shuffles within its half-warp, and l
//     is kept per thread and summed over the half-warp once at the end;
//     masked only on tiles that cross the diagonal, the window's edge or S;
//   - O += P·V: each thread owns R rows × 4·CV columns of O (8 × 8 at hd
//     256, 8 × 4 at 128, 4 × 4 at 64, 2 × 4 at 32), fed by float4s of P
//     and V: 16 shared loads for 256 FMAs at hd 256;
//   - K and V come in by cp.async (16 bytes a copy where every pointer is
//     16-byte aligned and hd and every stride a multiple of 4, else 4 bytes),
//     zero-filled past S, into one buffer each, and each is refilled while
//     the other is in use: V_t lands during Q·K_tᵀ and K_{t+1} during P·V_t
//     (two block barriers a tile).  A two-stage ring of both would force
//     32-key tiles at hd 256; this keeps 64 keys (the 4 × 4 score tile) in
//     (64 + 2·64)·(hd + 4)·4 + 64·68·4 + 512 bytes: 45,568 at hd 32, 70,144
//     at 64, 119,296 at 128, 217,600 at 256 (one block an SM; two at ≤ 64);
//   - a warp whose rows all lie past S skips both products;
//   - query tiles are launched longest first, as in the bf16 body.
//   Registers (nvcc -Xptxas -v for sm_90a, 256 threads, 1 block an SM, 2 at
//   hd ≤ 64): 128 at hd 32 and 64, 148 at 128, 168 at 256, no spills.  On
//   an H100 SXM at 700 W this body takes 3.83–3.94 ms at the prefill shape
//   (49–50 % of the bound; the first port 8.07).  In trials on the card
//   these were no faster and were not kept: other unroll depths; register
//   double-buffering of the Q and K fragments; half the shared-memory
//   wavefronts in Q·Kᵀ (each row block split over two warps by key
//   halves); 8 × 8 score tiles over quarters of hd (half the shared loads
//   an FMA, 254 registers); and 16 warps with tiles half as large (slower).
//   3xTF32 on the tensor cores (split-precision products) is left to later
//   work: it changes the numerics and the bound.
//
// Plain C entry points; each returns the launch's cudaError_t, and the
// Python wrapper (repro_torch/kernels/flash_attention.py) raises if it is
// not 0.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

struct Strides {                   // (b, head, position) strides in elements
  long long q[3], k[3], v[3], o[3];
};

constexpr int kBQ = 64;            // query rows of a block (both bodies)
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------- f32 body

namespace fp {

constexpr int kThreads = 256;      // 8 warps; warp w owns query rows 8w … 8w + 7
constexpr int kBK = 64;            // keys of a kv tile

template <int HD>
struct Cfg {
  static constexpr int LD = HD + 4;         // padded Q, K, V row: rows 4 banks apart
  static constexpr int LDP = kBK + 4;       // padded P row
  // P·V: a thread owns R rows × CV float4s of O's columns
  static constexpr int CG = HD / 4 < 32 ? HD / 4 : 32;  // column groups a row
  static constexpr int CV = HD / (4 * CG);               // 1, 1, 1, 2
  static constexpr int R = 8 * CG / 32;                  // 2, 4, 8, 8
  static constexpr int kSmemBytes =
      ((kBQ + 2 * kBK) * LD + kBQ * LDP + 2 * kBQ) * 4;  // Q, K, V, P, corr, l
  static constexpr int kMinBlocks = HD <= 64 ? 2 : 1;
};

// kVec floats a copy: 4 (16 bytes, .cg) or 1 (4 bytes, .ca); `in` false
// zero-fills the destination.
template <int kVec>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src, bool in) {
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
  }
}

// 64 rows of hd floats from rows row0… of a strided tensor into a padded
// shared tile of HD columns, by cp.async; rows at or past S and columns at
// or past hd are zero-filled.
template <int HD, int kVec>
__device__ __forceinline__ void load_rows(float* tile, const float* src,
                                          long long stride, int row0, int S,
                                          int hd, int tid) {
  constexpr int kPieces = HD / kVec;  // copies a row
  static_assert(64 * kPieces % kThreads == 0, "whole copies a thread");
#pragma unroll 4
  for (int it = 0; it < 64 * kPieces / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kPieces, c = (i % kPieces) * kVec;
    const int pos = row0 + r;
    const bool in = pos < S && c < hd;
    cp_async<kVec>(smem_u32(tile + r * Cfg<HD>::LD + c),
                   src + (in ? pos * stride + c : 0), in);
  }
}

template <int HD, int kVec>
__global__ void __launch_bounds__(kThreads, Cfg<HD>::kMinBlocks)
flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, float* __restrict__ o,
                 float* __restrict__ lse, int S, int hd, int group, int window,
                 float scale_log2, Strides st) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, LDP = C::LDP, R = C::R, CV = C::CV, CG = C::CG;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [kBQ][LD]
  float* Ks = Qs + kBQ * LD;         // [kBK][LD]
  float* Vs = Ks + kBK * LD;         // [kBK][LD]
  float* Ps = Vs + kBK * LD;         // [kBQ][LDP]
  float* corr_s = Ps + kBQ * LDP;    // [kBQ]
  float* l_s = corr_s + kBQ;         // [kBQ]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kBQ;  // longest rows first
  const int h = blockIdx.y, bi = blockIdx.z, hk = h / group;
  const float* qb = q + bi * st.q[0] + h * st.q[1];
  const float* kb = k + bi * st.k[0] + hk * st.k[1];
  const float* vb = v + bi * st.v[0] + hk * st.v[1];
  float* ob = o + bi * st.o[0] + h * st.o[1];

  const int q_last = min(q0 + kBQ, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / kBK : 0;
  const int kt_hi = q_last / kBK;
  // a warp whose 8 rows all lie past S computes nothing (S < 64 or ragged)
  const bool live = q0 + 8 * warp < S;

  // Q·Kᵀ: thread (tr, tc) holds rows 4·tr + i and keys tc + 16·j (i, j < 4);
  // the 16 lanes of a half-warp share its rows
  const int tr = 2 * warp + lane / 16, tc = lane % 16;
  // P·V: rows pr0 + i (i < R), columns 4·cg + 4·CG·c + e (c < CV, e < 4)
  const int cg = lane % CG, pr0 = 8 * warp + (lane / CG) * R;

  load_rows<HD, kVec>(Qs, qb, st.q[2], q0, S, hd, tid);
  load_rows<HD, kVec>(Ks, kb, st.k[2], kt_lo * kBK, S, hd, tid);
  cp_async_commit();

  float m[4], l[4];  // running max (log2 domain); this thread's part of l
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.0f;
  }
  float acc[R][CV][4];
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int c = 0; c < CV; ++c) acc[i][c][0] = acc[i][c][1] = acc[i][c][2] = acc[i][c][3] = 0.0f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int k0 = kt * kBK;
    cp_async_wait_all();
    __syncthreads();  // K_t is in; every warp is done with V_{t−1} and P
    load_rows<HD, kVec>(Vs, vb, st.v[2], k0, S, hd, tid);  // lands during Q·K_tᵀ
    cp_async_commit();

    if (live) {
      // s = Q·K_tᵀ, 4 × 4 a thread from float4s along hd: 8 shared loads
      // for 64 FMAs
      float s[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = s[i][2] = s[i][3] = 0.0f;
      const float* qr = Qs + 4 * tr * LD;
      const float* kr = Ks + tc * LD;
#pragma unroll 8
      for (int d = 0; d < HD; d += 4) {
        float4 a[4], b[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(qr + i * LD + d);
#pragma unroll
        for (int j = 0; j < 4; ++j) b[j] = *reinterpret_cast<const float4*>(kr + 16 * j * LD + d);
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
            s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
            s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
            s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
          }
      }

      // mask (only tiles that cross the diagonal, the window's edge or S),
      // into the log2 domain; the row max over the half-warp
      const bool inside = k0 + kBK - 1 <= q0 && k0 + kBK <= S &&
                          (window <= 0 || k0 > q_last - window);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = q0 + 4 * tr + i;
        float t = -INFINITY;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float x = s[i][j] * scale_log2;
          if (!inside) {
            const int kp = k0 + tc + 16 * j;
            const bool ok = kp <= r && kp < S && (window <= 0 || kp > r - window);
            x = ok ? x : -INFINITY;
          }
          s[i][j] = x;
          t = fmaxf(t, x);
        }
#pragma unroll
        for (int off = 1; off < 16; off <<= 1)
          t = fmaxf(t, __shfl_xor_sync(kFull, t, off));
        const float mn = fmaxf(m[i], t);
        // a row with no admissible key yet: base 0 gives p = exp2(−inf) = 0
        // and corr = 0 on a state that is still all zeros
        const float base = mn == -INFINITY ? 0.0f : mn;
        const float corr = exp2f(m[i] - base);
        m[i] = mn;
        float ls = 0.0f;
        float* prow = Ps + (4 * tr + i) * LDP + tc;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float p = exp2f(s[i][j] - base);
          ls += p;
          prow[16 * j] = p;
        }
        l[i] = l[i] * corr + ls;
        if (tc == 0) corr_s[4 * tr + i] = corr;
      }
    }

    cp_async_wait_all();
    __syncthreads();  // V_t is in; every warp is done with K_t
    if (kt < kt_hi)   // lands during P·V_t
      load_rows<HD, kVec>(Ks, kb, st.k[2], k0 + kBK, S, hd, tid);
    cp_async_commit();

    if (live) {
      // acc = acc·corr + P·V_t; the warp's own rows of P and corr
#pragma unroll
      for (int i = 0; i < R; ++i) {
        const float c = corr_s[pr0 + i];
#pragma unroll
        for (int cc = 0; cc < CV; ++cc)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[i][cc][e] *= c;
      }
      const float* pr = Ps + pr0 * LDP;
      const float* vc = Vs + 4 * cg;
#pragma unroll 4
      for (int j = 0; j < kBK; j += 4) {
        float4 p4[R];
#pragma unroll
        for (int i = 0; i < R; ++i) p4[i] = *reinterpret_cast<const float4*>(pr + i * LDP + j);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          float4 v4[CV];
#pragma unroll
          for (int cc = 0; cc < CV; ++cc)
            v4[cc] = *reinterpret_cast<const float4*>(vc + (j + jj) * LD + 4 * CG * cc);
#pragma unroll
          for (int i = 0; i < R; ++i) {
            const float p = jj == 0 ? p4[i].x : jj == 1 ? p4[i].y : jj == 2 ? p4[i].z : p4[i].w;
#pragma unroll
            for (int cc = 0; cc < CV; ++cc) {
              acc[i][cc][0] = fmaf(p, v4[cc].x, acc[i][cc][0]);
              acc[i][cc][1] = fmaf(p, v4[cc].y, acc[i][cc][1]);
              acc[i][cc][2] = fmaf(p, v4[cc].z, acc[i][cc][2]);
              acc[i][cc][3] = fmaf(p, v4[cc].w, acc[i][cc][3]);
            }
          }
        }
      }
    }
  }

  if (!live) return;
  // the row sums over the half-warp, then acc / l
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 1; off < 16; off <<= 1) l[i] += __shfl_xor_sync(kFull, l[i], off);
    if (tc == 0) l_s[4 * tr + i] = l[i];
    const int r = q0 + 4 * tr + i;
    if (lse != nullptr && tc == 0 && r < S)  // natural log: (m + log2 l)·ln 2
      lse[(static_cast<long long>(bi) * gridDim.y + h) * S + r] =
          (m[i] + log2f(l[i])) * 0.6931471805599453f;
  }
  __syncwarp();
#pragma unroll
  for (int i = 0; i < R; ++i) {
    const int row = q0 + pr0 + i;
    if (row >= S) continue;
    const float d = fmaxf(l_s[pr0 + i], 1e-30f);
    float* orow = ob + row * st.o[2];
#pragma unroll
    for (int cc = 0; cc < CV; ++cc) {
      const int col = 4 * cg + 4 * CG * cc;  // the padding's columns are not stored
      if (col >= hd) continue;
      const float4 r = make_float4(acc[i][cc][0] / d, acc[i][cc][1] / d,
                                   acc[i][cc][2] / d, acc[i][cc][3] / d);
      float* dst = orow + col;
      if constexpr (kVec == 4) {  // hd is a multiple of 4 here
        *reinterpret_cast<float4*>(dst) = r;
      } else {
        dst[0] = r.x;
        if (col + 1 < hd) dst[1] = r.y;
        if (col + 2 < hd) dst[2] = r.z;
        if (col + 3 < hd) dst[3] = r.w;
      }
    }
  }
}

}  // namespace fp

// --------------------------------------------------------- bf16 tensor cores

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int kThreads = 128;      // 4 warps × 16 query rows

template <int HD>
struct Cfg {
  static constexpr int BK = HD == 256 ? 32 : 64;   // keys of a kv tile
  static constexpr int LD = HD + 8;                // padded row, in bf16
  static constexpr int kSmemBytes = (kBQ + 4 * BK) * LD * 2;  // Q, 2×(K, V)
};

// kBytes a copy (16 by .cg, 8 or 4 by .ca); `in` false zero-fills them
template <int kBytes>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src, bool in) {
  if constexpr (kBytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 16 : 0)
                 : "memory");
  } else if constexpr (kBytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 8 : 0)
                 : "memory");
  } else {
    static_assert(kBytes == 4, "cp.async copies 4, 8 or 16 bytes");
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
                 "l"(src), "r"(in ? 4 : 0)
                 : "memory");
  }
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

__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
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
// shared tile of HD columns, by the NT threads of a block, cp.async of
// kBytes a copy; rows at or past S and columns at or past hd are
// zero-filled.
template <int HD, int ROWS, int kBytes, int NT = kThreads>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long stride, int row0, int S,
                                          int hd, int tid) {
  constexpr int kElems = kBytes / 2;     // bf16 a copy
  constexpr int kChunks = HD / kElems;   // copies a row
  constexpr int kCopies = ROWS * kChunks;
  // the 16-byte copies unrolled whole (at most 16 a thread); the narrower
  // ones by 4, or the 8-byte instances at HD 128 and 256 spill
#pragma unroll(kBytes == 16 ? 16 : 4)
  for (int it = 0; it < (kCopies + NT - 1) / NT; ++it) {
    const int i = tid + it * NT;
    if (kCopies % NT == 0 || i < kCopies) {  // fewer copies than threads
      const int r = i / kChunks, c = (i % kChunks) * kElems;
      const int pos = row0 + r;
      const bool in = pos < S && c < hd;
      cp_async<kBytes>(smem_u32(tile + r * Cfg<HD>::LD + c),
                       src + (in ? pos * stride + c : 0), in);
    }
  }
}

template <int HD, int kBytes>
__global__ void __launch_bounds__(kThreads, 2)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o,
                  float* __restrict__ lse, int S, int hd, int group,
                  int window, float scale_log2, Strides st) {
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

  load_tile<HD, kBQ, kBytes>(Qs, qb, st.q[2], q0, S, hd, tid);
  load_tile<HD, BK, kBytes>(Ks, kb, st.k[2], kt_lo * BK, S, hd, tid);
  load_tile<HD, BK, kBytes>(Vs, vb, st.v[2], kt_lo * BK, S, hd, tid);
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
      load_tile<HD, BK, kBytes>(Ks + next, kb, st.k[2], (kt + 1) * BK, S, hd, tid);
      load_tile<HD, BK, kBytes>(Vs + next, vb, st.v[2], (kt + 1) * BK, S, hd, tid);
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
  if (lse != nullptr && tq == 0) {  // natural log: (m + log2 l)·ln 2, from the f32 l
    float* lrow = lse + (static_cast<long long>(bi) * gridDim.y + h) * S;
    if (r0 < S) lrow[r0] = (m0 + log2f(l0)) * 0.6931471805599453f;
    if (r1 < S) lrow[r1] = (m1 + log2f(l1)) * 0.6931471805599453f;
  }
#pragma unroll
  for (int i = 0; i < HD / 8; ++i) {
    const int col = i * 8 + 2 * tq;  // even, and hd is even: col < hd covers col + 1
    if (col >= hd) continue;         // the padding's columns are not stored
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(ob + r0 * st.o[2] + col) =
          pack_bf16(acc[i][0] / d0, acc[i][1] / d0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(ob + r1 * st.o[2] + col) =
          pack_bf16(acc[i][2] / d1, acc[i][3] / d1);
  }
}

}  // namespace tc

// The softmax scale is 1/√hd of the true head dim, not of the padded HD.
float scale_log2(int hd) { return 1.4426950408889634f / sqrtf(static_cast<float>(hd)); }

template <int HD, int kVec>
int launch_f32_body(const void* q, const void* k, const void* v, void* o,
                    float* lse, int B, int H, int KV, int S, int hd,
                    int window, const Strides& st, cudaStream_t stream) {
  constexpr int bytes = fp::Cfg<HD>::kSmemBytes;
  auto kernel = fp::flash_f32_kernel<HD, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, fp::kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), lse, S, hd,
      H / KV, window, scale_log2(hd), st);
  return static_cast<int>(cudaGetLastError());
}

// The widest copy, in bytes (16, 8, 4 or 2, at most `widest`), that every
// base pointer, every (b, head, position) stride and hd allow.
int copy_bytes(const void* q, const void* k, const void* v, const void* o,
               const Strides& st, int hd, int elem, int widest) {
  const uintptr_t ptrs = reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
                         reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o);
  int w = widest;
  auto fits = [&](int bytes) {
    const int e = bytes / elem;
    bool ok = ptrs % bytes == 0 && hd % e == 0;
    for (int i = 0; i < 3; ++i)
      ok = ok && st.q[i] % e == 0 && st.k[i] % e == 0 && st.v[i] % e == 0 &&
           st.o[i] % e == 0;
    return ok;
  };
  while (w > elem && !fits(w)) w /= 2;
  return w;
}

// 16-byte copies and stores where the layout allows them (every base
// pointer 16-byte aligned, hd and every stride a multiple of 4 floats);
// 4-byte ones otherwise (a choice by the views' layout, not a fallback).
template <int HD>
int launch_f32(const void* q, const void* k, const void* v, void* o,
               float* lse, int B, int H, int KV, int S, int hd, int window,
               const Strides& st, cudaStream_t stream) {
  return copy_bytes(q, k, v, o, st, hd, 4, 16) == 16
             ? launch_f32_body<HD, 4>(q, k, v, o, lse, B, H, KV, S, hd, window, st, stream)
             : launch_f32_body<HD, 1>(q, k, v, o, lse, B, H, KV, S, hd, window, st, stream);
}

template <int HD, int kBytes>
int launch_bf16_body(const void* q, const void* k, const void* v, void* o,
                     float* lse, int B, int H, int KV, int S, int hd,
                     int window, const Strides& st, cudaStream_t stream) {
  constexpr int bytes = tc::Cfg<HD>::kSmemBytes;
  auto kernel = tc::flash_bf16_kernel<HD, kBytes>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, tc::kThreads, bytes, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), lse, S,
      hd, H / KV, window, scale_log2(hd), st);
  return static_cast<int>(cudaGetLastError());
}

// cp.async copies of 16, 8 or 4 bytes, the widest the views' layout allows
// (a choice by layout, not a fallback); the wrapper refuses a layout that
// allows none (an odd hd or stride, or a pointer not 4-byte aligned).
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                float* lse, int B, int H, int KV, int S, int hd, int window,
                const Strides& st, cudaStream_t stream) {
  switch (copy_bytes(q, k, v, o, st, hd, 2, 16)) {
    case 16: return launch_bf16_body<HD, 16>(q, k, v, o, lse, B, H, KV, S, hd, window, st, stream);
    case 8: return launch_bf16_body<HD, 8>(q, k, v, o, lse, B, H, KV, S, hd, window, st, stream);
    case 4: return launch_bf16_body<HD, 4>(q, k, v, o, lse, B, H, KV, S, hd, window, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kBf16, int HD>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int KV, int S, int hd, int window, const Strides& st,
           cudaStream_t stream) {
  if constexpr (kBf16)
    return launch_bf16<HD>(q, k, v, o, lse, B, H, KV, S, hd, window, st, stream);
  else
    return launch_f32<HD>(q, k, v, o, lse, B, H, KV, S, hd, window, st, stream);
}

template <bool kBf16>
int dispatch(const void* q, const void* k, const void* v, void* o, void* lse_,
             int B, int H, int KV, int S, int hd, int window,
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
  auto* lse = static_cast<float*>(lse_);
  // the body instantiated for the smallest padded head dim HD ≥ hd
  if (hd < 1 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 16) return launch<kBf16, 16>(q, k, v, o, lse, B, H, KV, S, hd, window, st, s);
  if (hd <= 32) return launch<kBf16, 32>(q, k, v, o, lse, B, H, KV, S, hd, window, st, s);
  if (hd <= 64) return launch<kBf16, 64>(q, k, v, o, lse, B, H, KV, S, hd, window, st, s);
  if (hd <= 128) return launch<kBf16, 128>(q, k, v, o, lse, B, H, KV, S, hd, window, st, s);
  return launch<kBf16, 256>(q, k, v, o, lse, B, H, KV, S, hd, window, st, s);
}

// ---------------------------------------------------------------- backward
//
// flash_attention_bwd: the gradients of the forward above given dO, from
// q, k, v, the forward's output o and its row logsumexp lse (natural log,
// (B, H, S) f32).  The reference has no Pallas backward: XLA differentiates
// its attention (repro/models/attention.py attn_full / attn_chunked).
// FlashAttention-2's recurrences:
//   D = rowsum(dO ∘ O),  P = exp(S·scale − lse) (0 where masked),
//   dP = dO·Vᵀ,  dS = P ∘ (dP − D),
//   dV = Pᵀ·dO,  dK = dSᵀ·Q·scale,  dQ = dS·K·scale,
// with the forward's masks exactly (key k admissible for query q when
// k ≤ q and, with a window, k > q − window) and 1/√hd of the true hd.
//
// Three launches (four where bf16 splits the dK/dV grid, below), no atomics
// (deterministic: remat's recompute and resumed runs rely on identical
// bits):
//   1. D, one warp a (b, head, row): the dot of dO and O over hd, in f32;
//   2. dK and dV, one block a (b, kv head, key tile): it walks the group's
//      G query heads and, for each, the query tiles that can see the key
//      tile (rows [k0, k_last + window) with a window, [k0, S) without),
//      and sums into f32 registers, so each GQA group's sum is one block's;
//   3. dQ, one block a (b, head, query tile): it walks the key tiles the
//      forward walks for that tile.
// Both tile passes rebuild P and dS for each (query tile, key tile) pair
// (S and dP twice: 7 products of hd against the 5 the gradients need).
//
// Bound on the H100: operations, 5 products × 2 × hd × admissible pairs × B
// × H, at the bf16 tensor-core rate (989 TFLOP/s) in bf16 and the f32 core
// rate (67 TFLOP/s) in f32: 3.22e11 and 0.326 ms in bf16 at h2o-danube-3-4b's
// train shape (1, 32, 4096, 120), kv 8, window 4096, 4.81 ms in f32; the f32
// body's own arithmetic, three TF32 products for each, at the TF32 rate
// (495 TFLOP/s): 1.95 ms.
//
// Two bodies, chosen by dtype at the entry point (not a fallback):
//
// f32 (namespace tf3) — 3xTF32 on the tensor cores.  The first port ran f32
// on the CUDA cores (register-tiled SGEMM micro-kernels whose score tiles
// read shared memory for every other FMA, tiles loaded element by element
// with no overlap, 170 KB of shared memory and one block an SM, key tiles of
// one kv head before the next): 21.52 ms at danube's shape, slower than its
// plain version (16.93) and SDPA's f32 backward (10.82); 7 padded products
// on the CUDA cores are 7.2 ms at their rate alone.  This body has tcb's
// shape (below): 64 resident rows a block, BC-row tiles through a two-stage
// cp.async ring (16, 8 or 4 bytes a copy, the widest the views allow; every
// f32 view allows 4), warps 4 row groups × 2 column halves, the score pair
// and then the gradient products, P and dS through shared memory, row tiles
// launched longest first.  What differs:
//   - every product is three mma.sync.m16n8k8 on TF32 operands
//     (HMMA.1688.F32.TF32 in the SASS; CUTLASS's "fast f32"): x = big +
//     small, big = x rounded to TF32 on its bits, small = x − big, which the
//     tensor cores read truncated to TF32, and a·b = small·big + big·small
//     + big·big (small·small, 2⁻²² of it, dropped): each term's error is
//     near 2⁻²⁰ of its size against the f32 FMA's 2⁻²⁴, well inside the
//     row-by-row check;
//   - the tensor cores add into their f32 accumulator truncating, so a long
//     chain of mmas into one register drifts (a first trial that summed a
//     block's whole dV in one accumulator missed the check's allowance at
//     danube's shape): the score products keep the cross terms in
//     accumulators of their own (which also halves the chain of dependent
//     mmas), and the gradient products sum each pair in fresh accumulators
//     that are added to the block's in f32;
//   - the K, V, Q and dO tiles are unpadded f32 rows with XOR-swizzled
//     16-byte chunks (swz below), so both the row-wise ldmatrix reads and
//     the transposed 32-bit reads of the gradient products' B fragments are
//     free of bank conflicts; P and dS are padded f32 rows (BC + 4);
//   - up to HD 128 the two resident tiles are split once into shared memory
//     (big in place, small beside), so the score products take their A
//     fragments split; the streamed tiles and P and dS are split as they
//     are read (cvt.rna.tf32.f32 compiles to a compare-and-select sequence,
//     so big is rounded on the bits);
//   - all HD/8 k-steps and HD/8 gradient column tiles run, the padding's on
//     zeros (hd 120 as 128, as tcb): branching at hd kept the compiler from
//     overlapping the k-steps;
//   - BC = 64 columns up to HD 64, 32 at 128, 16 at 256 (shared memory);
//   - the dK/dV grid is not split over the group's heads: f32 runs in the
//     gradient checks and f32 training, and danube's grid has 512 blocks;
//     a grid with one kv head (recurrentgemma's 64 blocks) leaves half the
//     SMs idle, which splitting as tcb does is left to later work;
//   - dK, dV and dQ are stored once in f32, one float a store (any hd and
//     strides), dK and dQ after the 1/√hd scale.
//   Shared memory (dynamic), dK/dV: 68,608 bytes at HD 16, 101,376 at 32,
//   166,912 at 64, 215,552 at 128, 207,104 at 256; dQ: 50,176, 82,944,
//   148,480, 205,824, 201,728: one block an SM.
//   Registers (nvcc -Xptxas -v for sm_90a, 256 threads, one block an SM),
//   dK/dV: 164-172 at HD 16, 176-186 at 32, 184-196 at 64, 221-231 at 128,
//   254 at 256; dQ: 158-165, 168-182, 185-187, 165-167, 221-225; no spills.
//   On an H100 SXM at 700 W this body takes 8.50-8.53 ms at danube's train
//   shape (time_kernels.py; the first port's 21.45-21.66 in the same run),
//   below SDPA's f32 backward (10.82).  In trials on the card these were
//   slower and were not kept: cvt.rna for both parts; small rounded to
//   TF32 on its bits as well; 4 k-steps unrolled at a time up to HD 128;
//   the resident tiles split as they are read; BC = 64 at HD 128 (without
//   the resident split, which it leaves no room for; it spilled).  wgmma
//   (TF32 operands from shared memory, pre-split) and TMA are left to
//   later work.
//
// bf16 (namespace tcb) — the tensor cores.  The first port ran bf16 through
// the f32 body (P and dS rounded to bf16 as the products' operands): 22.10
// ms at danube's shape, 68× the bound and 9.2× SDPA's backward; 7 products
// at padded HD 128 on the CUDA cores are 7.2 ms at their rate alone.  This
// body runs all 7 as mma.sync.m16n8k16 (bf16 in, f32 accumulate; HMMA in the
// SASS), FlashAttention-2's backward, with the forward's tc:: helpers:
//   - both tile passes have one shape.  A block of 8 warps owns 64 rows
//     (keys in dK/dV, queries in dQ) whose two tiles (K and V, or Q and
//     dO) are copied into shared memory once, and streams tiles of BC
//     columns (Q and dO with their lse and D rows, or K and V) through a
//     two-stage cp.async ring (16, 8 or 4 bytes a copy, zero-filled past S):
//     pair p + 1 is in flight while pair p is multiplied, and one block
//     barrier a pair both publishes the landed tile and frees the other
//     stage;
//   - the score pair (Sᵀ = K·Qᵀ and dPᵀ = V·dOᵀ in dK/dV, S = Q·Kᵀ and
//     dP = dO·Vᵀ in dQ): warp w takes rows 16·(w mod 4) … + 15 and column
//     half w / 4, in the mma's f32 accumulators.  There P = exp2(S·scale·
//     log2 e − lse·log2 e) and dS = P ∘ (dP − D) are formed in f32, masked
//     only on tiles that cross the diagonal, the window's edge or S (a zero
//     row past S would give P = exp2(−lse)), and written to shared memory
//     in bf16: their one rounding, as the products' operands, the same as
//     the first port's;
//   - a second block barrier, then the gradient products (dV += Pᵀ·dO and
//     dK += dSᵀ·Q, or dQ += dS·K): warp w takes the same 16 rows and hd
//     half w / 4, P or dS by ldmatrix as A, the streamed tile by
//     ldmatrix.trans as B;
//   - why P and dS go through shared memory, and not through registers as
//     the forward's P does (S's accumulators are P·V's A fragments): a warp
//     that owns 16 key rows across all of hd holds HD f32 accumulators a
//     thread for dK and dV (128 at HD 128, 256 at 256) beside Sᵀ and dPᵀ,
//     where the forward's HD 128 body already takes 222 registers for 112
//     live f32.  Split over hd halves, a warp holds HD/2 (and HD/4 for dQ)
//     beside BC/2 score values, at every HD with one code path; the price
//     is one bf16 write of P and dS a pair and two reads of it;
//   - BC = 64 columns, 32 at HD 256 (shared memory).  Blocks are launched
//     row tile by row tile, each across every head: key tiles ascending in
//     dK/dV (the first see the most query tiles), query tiles descending in
//     dQ, so the longest start first;
//   - where the (key tile, kv head, b) grid has fewer blocks than the SMs
//     hold (recurrentgemma's one kv head: 64 blocks for 132 SMs), the
//     group's heads are split into the fewest parts (a divisor of the group)
//     that bring the longest block's walk down to an SM's share of all the
//     walks; each part writes its f32 sums to scratch after D, and
//     flash_bwd_tc_sum_kernel adds the parts in order (deterministic) and
//     rounds once.  Other grids keep the sum in one block;
//   - dK, dV and dQ are rounded to bf16 once, at the store (dK and dQ after
//     the 1/√hd scale).
//   Shared memory (dynamic), dK/dV: (128·(HD + 8) + 4·BC·(HD + 8) + 128·(BC
//   + 8))·2 + 16·BC bytes: 37,888 at HD 16, 50,176 at 32, 74,752 at 64,
//   123,904 at 128, 145,920 at 256; dQ: (128 + 4·BC)·(HD + 8)·2 + 128·(BC +
//   8) bytes: 27,648, 39,936, 64,512, 113,664, 140,288.
//   Registers (nvcc -Xptxas -v for sm_90a, 256 threads): dK/dV, one block
//   an SM, 93-98 at HD 16, 120-136 at 32, 132-163 at 64, 168-198 at 128,
//   237-242 at 256; dQ, two blocks an SM up to HD 128, 84-87, 108-120,
//   123-128, 126-128, and one at 256, 165-180; the sum kernel 32; no
//   spills.  On an H100 SXM at 700 W this body takes 2.35-2.49 ms at
//   danube's train shape (the first port 22.07-22.13, SDPA's backward with
//   a boolean mask 2.40-2.77): dK/dV 1.41, dQ 0.89.  At recurrentgemma's (1, 10, 4096, 256) kv 1, window 2048, the
//   whole group in a block took 2.41-2.48 ms, 1.7-1.8 of it dK/dV; split
//   into 5 parts (320 blocks) it takes 1.35-1.51 (2 parts 1.52, 10 parts
//   1.39).  Forced splits at danube's shape (2 parts 2.55 ms, 4 parts 2.49)
//   gained nothing there.  In trials on the card these were not kept: dQ at
//   one block an SM (1.17 ms instead of 0.89); BC = 32 at HD 128 (3.15 ms
//   in all), and with it two blocks an SM for dK/dV too (2.38 ms, but 4-8
//   bytes of spills).  wgmma and TMA (FlashAttention-3's backward) are left
//   to later work.

namespace bw {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

struct BwdStrides {                // (b, head, position) strides in elements
  long long q[3], k[3], v[3], o[3], dO[3], dq[3], dk[3], dv[3];
};

// D[b, h, s] = Σ_c dO·O, one warp a row (rows = B·H·S, in (b, h, s) order)
template <typename E>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dot_kernel(const E* __restrict__ o, const E* __restrict__ dO,
                     float* __restrict__ D, int H, int S, int hd, long long rows,
                     BwdStrides st) {
  const long long row = static_cast<long long>(blockIdx.x) * (kThreads / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int s = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const E* orow = o + b * st.o[0] + h * st.o[1] + s * st.o[2];
  const E* drow = dO + b * st.dO[0] + h * st.dO[1] + s * st.dO[2];
  float acc = 0.0f;
  for (int c = lane; c < hd; c += 32) acc = fmaf(to_f32(drow[c]), to_f32(orow[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(kFull, acc, off);
  if (lane == 0) D[row] = acc;
}

// D = rowsum(dO ∘ O) for the B·H·S rows, either body's first launch
template <typename E>
int launch_dot(const void* o, const void* dO, void* D, int B, int H, int S,
               int hd, const BwdStrides& st, cudaStream_t stream) {
  const long long rows = static_cast<long long>(B) * H * S;
  flash_bwd_dot_kernel<E><<<static_cast<unsigned>((rows + kThreads / 32 - 1) / (kThreads / 32)),
                            kThreads, 0, stream>>>(
      static_cast<const E*>(o), static_cast<const E*>(dO), static_cast<float*>(D),
      H, S, hd, rows, st);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace bw

// -------------------------------------------- backward, bf16 tensor cores

namespace tcb {

using tc::bf16;
constexpr int kThreads = 256;  // 8 warps: 4 row groups of 16 × 2 column halves
constexpr int kRows = 64;      // rows of a block: keys (dK/dV) or queries (dQ)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  static constexpr int LD = tc::Cfg<HD>::LD;      // the forward's padded row
  static constexpr int BC = HD == 256 ? 32 : 64;  // columns of a pair's tile
  static constexpr int LDP = BC + 8;              // padded bf16 row of P or dS
  static constexpr int NJ = BC / 16;  // 8-column mma tiles of a warp's scores
  static constexpr int NI = HD / 16;  // 8-column mma tiles of a warp's gradient
  // K, V; two stages of Q and dO; Pᵀ and dSᵀ; two stages of lse and D
  static constexpr int kDkdvSmem =
      (2 * kRows * LD + 4 * BC * LD + 2 * kRows * LDP) * 2 + 4 * BC * 4;
  // Q, dO; two stages of K and V; dS
  static constexpr int kDqSmem = (2 * kRows * LD + 4 * BC * LD + kRows * LDP) * 2;
};

// x = R1·C1ᵀ and y = R2·C2ᵀ on this warp's 16 rows (row group rw) and BC/2
// columns (half cw) of a pair's 64 × BC score tiles, in the mma's f32
// accumulators.  R1, R2: [64][LD] row tiles; C1, C2: [BC][LD] column tiles.
template <int HD>
__device__ __forceinline__ void tile_scores(float (&x)[Cfg<HD>::NJ][4],
                                            float (&y)[Cfg<HD>::NJ][4],
                                            const bf16* R1, const bf16* R2,
                                            const bf16* C1, const bf16* C2,
                                            int rw, int cw, int lane) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, NJ = C::NJ;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    x[j][0] = x[j][1] = x[j][2] = x[j][3] = 0.0f;
    y[j][0] = y[j][1] = y[j][2] = y[j][3] = 0.0f;
  }
  // ldmatrix rows of this lane, as the forward reads Q (A) and K (B)
  const int a_off = (rw * 16 + lane % 16) * LD + (lane / 16) * 8;
  const int b_off = (cw * (C::BC / 2) + lane % 8 + (lane / 16) * 8) * LD +
                    ((lane / 8) % 2) * 8;
#pragma unroll
  for (int kk = 0; kk < HD; kk += 16) {
    uint32_t a1[4], a2[4];
    tc::ldmatrix_x4(a1, smem_u32(R1 + a_off + kk));
    tc::ldmatrix_x4(a2, smem_u32(R2 + a_off + kk));
#pragma unroll
    for (int j = 0; j < NJ; j += 2) {
      uint32_t b[4];
      tc::ldmatrix_x4(b, smem_u32(C1 + b_off + j * 8 * LD + kk));
      tc::mma_bf16(x[j], a1, b[0], b[1]);
      tc::mma_bf16(x[j + 1], a1, b[2], b[3]);
      tc::ldmatrix_x4(b, smem_u32(C2 + b_off + j * 8 * LD + kk));
      tc::mma_bf16(y[j], a2, b[0], b[1]);
      tc::mma_bf16(y[j + 1], a2, b[2], b[3]);
    }
  }
}

// This warp's 16 × BC/2 part of a score tile, rounded to bf16, into the
// shared [64][LDP] tile P (row-major, as the accumulators lie)
template <int HD>
__device__ __forceinline__ void store_scores(bf16* P, const float (&x)[Cfg<HD>::NJ][4],
                                             int rw, int cw, int lane) {
  using C = Cfg<HD>;
  bf16* row = P + (rw * 16 + lane / 4) * C::LDP + cw * (C::BC / 2) + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < C::NJ; ++j) {
    *reinterpret_cast<uint32_t*>(row + j * 8) = tc::pack_bf16(x[j][0], x[j][1]);
    *reinterpret_cast<uint32_t*>(row + 8 * C::LDP + j * 8) =
        tc::pack_bf16(x[j][2], x[j][3]);
  }
}

// acc += A·B on this warp's 16 rows (row group rw) and HD/2 columns (half
// cw): A the shared [64][LDP] P or dS tile (by ldmatrix), B a [BC][LD]
// column tile whose rows are the product's depth (by ldmatrix.trans, as the
// forward reads V).
template <int HD>
__device__ __forceinline__ void tile_product(float (&acc)[Cfg<HD>::NI][4],
                                             const bf16* A, const bf16* B,
                                             int rw, int cw, int lane) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, NI = C::NI;
  const int a_off = (rw * 16 + lane % 16) * C::LDP + (lane / 16) * 8;
  const int b_off = (lane % 8 + ((lane / 8) % 2) * 8) * LD + cw * (HD / 2) +
                    (lane / 16) * 8;
#pragma unroll
  for (int ks = 0; ks < C::BC; ks += 16) {
    uint32_t a[4];
    tc::ldmatrix_x4(a, smem_u32(A + a_off + ks));
    if constexpr (NI == 1) {  // HD 16: one 8-column tile a warp
      uint32_t b[2];
      tc::ldmatrix_x2_trans(b, smem_u32(B + b_off + ks * LD));
      tc::mma_bf16(acc[0], a, b[0], b[1]);
    } else {
#pragma unroll
      for (int i = 0; i < NI; i += 2) {
        uint32_t b[4];
        tc::ldmatrix_x4_trans(b, smem_u32(B + b_off + ks * LD + i * 8));
        tc::mma_bf16(acc[i], a, b[0], b[1]);
        tc::mma_bf16(acc[i + 1], a, b[2], b[3]);
      }
    }
  }
}

// rows r0 and r0 + 8 (< S) of this warp's HD/2 gradient columns, times mul,
// rounded to bf16 once (hd is even: col < hd covers col + 1)
template <int HD>
__device__ __forceinline__ void store_grad(bf16* dst, long long stride,
                                           const float (&acc)[Cfg<HD>::NI][4],
                                           float mul, int r0, int S, int hd,
                                           int cw, int lane) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < Cfg<HD>::NI; ++i) {
    const int col = cw * (HD / 2) + i * 8 + 2 * (lane % 4);
    if (col >= hd) continue;  // the padding's columns are not stored
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dst + r0 * stride + col) =
          tc::pack_bf16(acc[i][0] * mul, acc[i][1] * mul);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dst + r1 * stride + col) =
          tc::pack_bf16(acc[i][2] * mul, acc[i][3] * mul);
  }
}

// rows r0 and r0 + 8 (< S) of this warp's HD/2 gradient columns, in f32,
// into a partial sum's [S][hd] rows
template <int HD>
__device__ __forceinline__ void store_part(float* dst, const float (&acc)[Cfg<HD>::NI][4],
                                           int r0, int S, int hd, int cw, int lane) {
  const int r1 = r0 + 8;
#pragma unroll
  for (int i = 0; i < Cfg<HD>::NI; ++i) {
    const int col = cw * (HD / 2) + i * 8 + 2 * (lane % 4);
    if (col >= hd) continue;
    if (r0 < S)
      *reinterpret_cast<float2*>(dst + static_cast<long long>(r0) * hd + col) =
          make_float2(acc[i][0], acc[i][1]);
    if (r1 < S)
      *reinterpret_cast<float2*>(dst + static_cast<long long>(r1) * hd + col) =
          make_float2(acc[i][2], acc[i][3]);
  }
}

// dK, dV of one (b, kv head, 64-key tile), summed over `heads` consecutive
// query heads of the group (all of it, or part hp of group / heads parts)
// and the query tiles of BC rows that see the key tile.  The whole group
// stores bf16 into dk and dv; a part stores its f32 sums into `part`
// ([2: dK, dV][parts][B][KV][S][hd]), which flash_bwd_tc_sum_kernel adds.
template <int HD, int kBytes>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tc_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                         const bf16* __restrict__ v, const bf16* __restrict__ dO,
                         const float* __restrict__ lse, const float* __restrict__ D,
                         bf16* __restrict__ dk, bf16* __restrict__ dv,
                         float* __restrict__ part, int H, int S, int hd, int group,
                         int heads, int window, float scale_log2, float scale,
                         bw::BwdStrides st) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, BC = C::BC, NJ = C::NJ, NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* Vs = Ks + kRows * LD;                    // [64][LD]
  bf16* Qs = Vs + kRows * LD;                    // [2][BC][LD]
  bf16* dOs = Qs + 2 * BC * LD;                  // [2][BC][LD]
  bf16* PT = dOs + 2 * BC * LD;                  // [64 keys][LDP]: Pᵀ
  bf16* dST = PT + kRows * C::LDP;               // [64 keys][LDP]: dSᵀ
  float* lse_s = reinterpret_cast<float*>(dST + kRows * C::LDP);  // [2][BC]
  float* D_s = lse_s + 2 * BC;                                    // [2][BC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp % 4, cw = warp / 4;
  // key tiles ascending, each across every (kv head, part) before the next
  const long long lin = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int k0 = static_cast<int>(lin / gridDim.y) * kRows;
  const int parts = group / heads, hy = static_cast<int>(lin % gridDim.y);
  const int hk = hy / parts, hp = hy % parts, bi = blockIdx.z;
  const int k_last = min(k0 + kRows, S) - 1;
  const int qt_lo = k0 / BC;
  const int qt_hi = (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / BC;
  const int nq = qt_hi - qt_lo + 1, pairs = heads * nq;

  // pair p: query head hk·G + hp·heads + p / nq, query tile qt_lo + p % nq,
  // with its lse and D rows, into ring stage `stage`
  auto load_pair = [&](int p, int stage) {
    const int h = hk * group + hp * heads + p / nq, q0 = (qt_lo + p % nq) * BC;
    tc::load_tile<HD, BC, kBytes, kThreads>(Qs + stage * BC * LD,
                                            q + bi * st.q[0] + h * st.q[1],
                                            st.q[2], q0, S, hd, tid);
    tc::load_tile<HD, BC, kBytes, kThreads>(dOs + stage * BC * LD,
                                            dO + bi * st.dO[0] + h * st.dO[1],
                                            st.dO[2], q0, S, hd, tid);
    if (tid < 2 * BC) {
      const int r = tid % BC, pos = q0 + r;
      const bool in = pos < S;
      const float* src = (tid < BC ? lse : D) +
                         (in ? (static_cast<long long>(bi) * H + h) * S + pos : 0);
      tc::cp_async<4>(smem_u32((tid < BC ? lse_s : D_s) + stage * BC + r), src, in);
    }
  };

  tc::load_tile<HD, kRows, kBytes, kThreads>(Ks, k + bi * st.k[0] + hk * st.k[1],
                                             st.k[2], k0, S, hd, tid);
  tc::load_tile<HD, kRows, kBytes, kThreads>(Vs, v + bi * st.v[0] + hk * st.v[1],
                                             st.v[2], k0, S, hd, tid);
  load_pair(0, 0);
  cp_async_commit();

  float acc_k[NI][4], acc_v[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.0f;
  const int kr = k0 + rw * 16 + lane / 4;  // this thread's keys kr, kr + 8

  for (int p = 0; p < pairs; ++p) {
    const int stage = p & 1;
    cp_async_wait_all();
    __syncthreads();  // pair p is in; every warp is done with pair p − 1
    if (p + 1 < pairs) load_pair(p + 1, stage ^ 1);
    cp_async_commit();
    const bf16* Qc = Qs + stage * BC * LD;
    const bf16* dOc = dOs + stage * BC * LD;
    const float* lse_c = lse_s + stage * BC;
    const float* D_c = D_s + stage * BC;
    const int q0 = (qt_lo + p % nq) * BC;

    float x[NJ][4], y[NJ][4];
    tile_scores<HD>(x, y, Ks, Vs, Qc, dOc, rw, cw, lane);  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ

    // Pᵀ and dSᵀ: lse and D by the accumulator's column, the query; masked
    // only on tiles that cross the diagonal, the window's edge or S
    const bool inside = k0 + kRows - 1 <= q0 && q0 + BC <= S &&
                        (window <= 0 || k0 > q0 + BC - 1 - window);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int c = cw * (BC / 2) + j * 8 + 2 * (lane % 4);
      const float2 l2 = *reinterpret_cast<const float2*>(lse_c + c);
      const float2 d2 = *reinterpret_cast<const float2*>(D_c + c);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kp = kr + (e >= 2 ? 8 : 0), qp = q0 + c + (e & 1);
        const bool ok = inside || (kp <= qp && qp < S && (window <= 0 || kp > qp - window));
        const float lq = ((e & 1) ? l2.y : l2.x) * kLog2e;
        const float pr = ok ? exp2f(x[j][e] * scale_log2 - lq) : 0.0f;
        x[j][e] = pr;
        y[j][e] = pr * (y[j][e] - ((e & 1) ? d2.y : d2.x));
      }
    }
    store_scores<HD>(PT, x, rw, cw, lane);
    store_scores<HD>(dST, y, rw, cw, lane);
    __syncthreads();  // Pᵀ and dSᵀ are whole
    tile_product<HD>(acc_v, PT, dOc, rw, cw, lane);   // dV += Pᵀ·dO
    tile_product<HD>(acc_k, dST, Qc, rw, cw, lane);   // dK += dSᵀ·Q
  }
  if (part == nullptr) {
    store_grad<HD>(dk + bi * st.dk[0] + hk * st.dk[1], st.dk[2], acc_k, scale, kr, S,
                   hd, cw, lane);
    store_grad<HD>(dv + bi * st.dv[0] + hk * st.dv[1], st.dv[2], acc_v, 1.0f, kr, S,
                   hd, cw, lane);
  } else {
    const int KV = gridDim.y / parts;
    const long long slab = static_cast<long long>(S) * hd;
    const long long per_part = gridDim.z * KV * slab;  // one part of dK or dV
    float* pk = part + hp * per_part + (static_cast<long long>(bi) * KV + hk) * slab;
    store_part<HD>(pk, acc_k, kr, S, hd, cw, lane);
    store_part<HD>(pk + parts * per_part, acc_v, kr, S, hd, cw, lane);
  }
}

// dK = scale · Σ_p part_p and dV = Σ_p part_p, the parts added in order
// (deterministic), rounded to bf16 once; blockIdx.y: 0 dK, 1 dV.  Two
// columns a thread (hd is even).
__global__ void __launch_bounds__(kThreads)
flash_bwd_tc_sum_kernel(const float* __restrict__ part, int parts, int KV, int S,
                        int hd, long long per_part, float scale,
                        bf16* __restrict__ dk, bf16* __restrict__ dv,
                        bw::BwdStrides st) {
  const bool is_v = blockIdx.y == 1;
  const float2* src = reinterpret_cast<const float2*>(part + (is_v ? parts * per_part : 0));
  const long long half = per_part / 2;
  const float mul = is_v ? 1.0f : scale;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
       i < half; i += static_cast<long long>(gridDim.x) * kThreads) {
    float2 sum = src[i];
    for (int p = 1; p < parts; ++p) {
      const float2 t = src[p * half + i];
      sum.x += t.x;
      sum.y += t.y;
    }
    const long long row = 2 * i / hd;
    const int col = static_cast<int>(2 * i - row * hd), pos = static_cast<int>(row % S);
    const long long bh = row / S;
    const long long b = bh / KV, h = bh % KV;
    bf16* dst = is_v ? dv + b * st.dv[0] + h * st.dv[1] + pos * st.dv[2]
                     : dk + b * st.dk[0] + h * st.dk[1] + pos * st.dk[2];
    *reinterpret_cast<uint32_t*>(dst + col) = tc::pack_bf16(sum.x * mul, sum.y * mul);
  }
}

// The parts each GQA group's dK/dV blocks are split into (a divisor of the
// group: 1 keeps the sum in one block).  Where the (key tile, kv head, b)
// grid leaves the SMs idle, at most one block each, the longest block is
// the group's walk of the first key tile; the group is split into the
// fewest parts that bring it down to an SM's share of all the walks
// (pairs_max · heads ≤ Σ pairs · G · KV · B / slots).
template <int HD>
int dkdv_split(int B, int KV, int S, int group, int window, long long slots, int* parts) {
  const int tiles = (S + kRows - 1) / kRows;
  const long long blocks = static_cast<long long>(tiles) * KV * B;
  *parts = 1;
  if (blocks >= slots) return static_cast<int>(cudaSuccess);
  long long sum = 0, most = 0;  // query tiles the key tiles see: Σ and max
  for (int t = 0; t < tiles; ++t) {
    const int k0 = t * kRows, k_last = (k0 + kRows < S ? k0 + kRows : S) - 1;
    const int seen = window > 0 && k_last + window - 1 < S - 1 ? k_last + window - 1 : S - 1;
    const long long nq = seen / Cfg<HD>::BC - k0 / Cfg<HD>::BC + 1;
    sum += nq;
    most = nq > most ? nq : most;
  }
  for (int d = 1; d <= group; ++d) {
    if (group % d) continue;
    *parts = d;
    if (most * (group / d) * slots <= sum * group * KV * B) break;
  }
  return static_cast<int>(cudaSuccess);
}

template <int HD>
int dkdv_parts(int B, int KV, int S, int group, int window, int* parts) {
  using C = Cfg<HD>;
  static int slots_of[64] = {};  // resident dK/dV blocks of a device, once known
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  int slots = device < 64 ? slots_of[device] : 0;
  if (slots == 0) {
    auto kernel = flash_bwd_tc_dkdv_kernel<HD, 16>;
    int sms = 0, per_sm = 0;
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               C::kDkdvSmem);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                          C::kDkdvSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    slots = sms * per_sm;
    if (device < 64) slots_of[device] = slots;
  }
  return dkdv_split<HD>(B, KV, S, group, window, slots, parts);
}

// Floats of the scratch the bf16 backward takes: D's B·H·S, then, where
// the dK/dV grid is split, its f32 partial sums from a 16-byte boundary.
long long part_offset(int B, int H, int S) {
  return (static_cast<long long>(B) * H * S + 3) / 4 * 4;
}

// dQ of one (b, head, 64-query tile), over the key tiles of BC keys it sees;
// two blocks an SM up to HD 128 (128 registers, no spills)
template <int HD, int kBytes>
__global__ void __launch_bounds__(kThreads, HD <= 128 ? 2 : 1)
flash_bwd_tc_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v, const bf16* __restrict__ dO,
                       const float* __restrict__ lse, const float* __restrict__ D,
                       bf16* __restrict__ dq, int H, int S, int hd, int group,
                       int window, float scale_log2, float scale,
                       bw::BwdStrides st) {
  using C = Cfg<HD>;
  constexpr int LD = C::LD, BC = C::BC, NJ = C::NJ, NI = C::NI;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);  // [64][LD]
  bf16* dOs = Qs + kRows * LD;                   // [64][LD]
  bf16* Ks = dOs + kRows * LD;                   // [2][BC][LD]
  bf16* Vs = Ks + 2 * BC * LD;                   // [2][BC][LD]
  bf16* dSs = Vs + 2 * BC * LD;                  // [64 queries][LDP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp % 4, cw = warp / 4;
  // query tiles descending (the last see the most keys), each across every
  // head before the next
  const long long lin = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int q0 = (static_cast<int>(gridDim.x) - 1 - static_cast<int>(lin / gridDim.y)) * kRows;
  const int h = static_cast<int>(lin % gridDim.y), bi = blockIdx.z, hk = h / group;
  const int q_last = min(q0 + kRows, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BC : 0;
  const int kt_hi = q_last / BC;
  const bf16* kb = k + bi * st.k[0] + hk * st.k[1];
  const bf16* vb = v + bi * st.v[0] + hk * st.v[1];

  tc::load_tile<HD, kRows, kBytes, kThreads>(Qs, q + bi * st.q[0] + h * st.q[1],
                                             st.q[2], q0, S, hd, tid);
  tc::load_tile<HD, kRows, kBytes, kThreads>(dOs, dO + bi * st.dO[0] + h * st.dO[1],
                                             st.dO[2], q0, S, hd, tid);
  tc::load_tile<HD, BC, kBytes, kThreads>(Ks, kb, st.k[2], kt_lo * BC, S, hd, tid);
  tc::load_tile<HD, BC, kBytes, kThreads>(Vs, vb, st.v[2], kt_lo * BC, S, hd, tid);
  cp_async_commit();

  // this thread's rows r0, r0 + 8: lse (log2 domain) and D in registers
  const int r0 = q0 + rw * 16 + lane / 4, r1 = r0 + 8;
  const long long lrow = (static_cast<long long>(bi) * H + h) * S;
  const float l0 = r0 < S ? lse[lrow + r0] * kLog2e : 0.0f;
  const float l1 = r1 < S ? lse[lrow + r1] * kLog2e : 0.0f;
  const float d0 = r0 < S ? D[lrow + r0] : 0.0f;
  const float d1 = r1 < S ? D[lrow + r1] : 0.0f;

  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with kt − 1
    if (kt < kt_hi) {
      const int next = (stage ^ 1) * BC * LD;
      tc::load_tile<HD, BC, kBytes, kThreads>(Ks + next, kb, st.k[2], (kt + 1) * BC, S,
                                              hd, tid);
      tc::load_tile<HD, BC, kBytes, kThreads>(Vs + next, vb, st.v[2], (kt + 1) * BC, S,
                                              hd, tid);
    }
    cp_async_commit();
    const bf16* Kc = Ks + stage * BC * LD;
    const bf16* Vc = Vs + stage * BC * LD;

    float x[NJ][4], y[NJ][4];
    tile_scores<HD>(x, y, Qs, dOs, Kc, Vc, rw, cw, lane);  // S = Q·Kᵀ, dP = dO·Vᵀ

    const int k0 = kt * BC;
    const bool inside = k0 + BC - 1 <= q0 && q0 + kRows <= S &&
                        (window <= 0 || k0 > q0 + kRows - 1 - window);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int qp = e < 2 ? r0 : r1;
        const int kp = k0 + cw * (BC / 2) + j * 8 + 2 * (lane % 4) + (e & 1);
        const bool ok = inside || (kp <= qp && qp < S && (window <= 0 || kp > qp - window));
        const float pr = ok ? exp2f(x[j][e] * scale_log2 - (e < 2 ? l0 : l1)) : 0.0f;
        y[j][e] = pr * (y[j][e] - (e < 2 ? d0 : d1));
      }
    }
    store_scores<HD>(dSs, y, rw, cw, lane);
    __syncthreads();  // dS is whole
    tile_product<HD>(acc, dSs, Kc, rw, cw, lane);  // dQ += dS·K
  }
  store_grad<HD>(dq + bi * st.dq[0] + h * st.dq[1], st.dq[2], acc, scale, r0, S, hd,
                 cw, lane);
}

template <int HD, int kBytes>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dO, void* dq, void* dk, void* dv,
               void* D, int B, int H, int KV, int S, int hd, int window,
               const bw::BwdStrides& st, cudaStream_t stream) {
  using C = Cfg<HD>;
  const float sl2 = scale_log2(hd);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaError_t err = static_cast<cudaError_t>(
      bw::launch_dot<bf16>(o, dO, D, B, H, S, hd, st, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kRows - 1) / kRows, group = H / KV;
  int parts = 1;
  err = static_cast<cudaError_t>(dkdv_parts<HD>(B, KV, S, group, window, &parts));
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part = parts > 1 ? static_cast<float*>(D) + part_offset(B, H, S) : nullptr;
  auto dkdv = flash_bwd_tc_dkdv_kernel<HD, kBytes>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(tiles, KV * parts, B), kThreads, C::kDkdvSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), part, H, S, hd, group,
      group / parts, window, sl2, scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  if (part != nullptr) {
    const long long per_part = static_cast<long long>(B) * KV * S * hd;
    const long long need = (per_part / 2 + kThreads - 1) / kThreads;
    const long long blocks = need < 4096 ? need : 4096;
    flash_bwd_tc_sum_kernel<<<dim3(static_cast<unsigned>(blocks), 2), kThreads, 0, stream>>>(
        part, parts, KV, S, hd, per_part, scale, static_cast<bf16*>(dk),
        static_cast<bf16*>(dv), st);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  auto dqk = flash_bwd_tc_dq_kernel<HD, kBytes>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3(tiles, H, B), kThreads, C::kDqSmem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<bf16*>(dq), H, S, hd, H / KV, window, sl2, scale, st);
  return static_cast<int>(cudaGetLastError());
}

// cp.async copies of 16, 8 or 4 bytes, the widest that q, k, v and dO allow
// (a choice by layout, not a fallback); the wrapper makes dO contiguous, and
// refuses q, k, v, where their layout allows none.
template <int HD>
int launch_widths(const void* q, const void* k, const void* v, const void* o,
                  const void* lse, const void* dO, void* dq, void* dk, void* dv,
                  void* D, int B, int H, int KV, int S, int hd, int window,
                  const bw::BwdStrides& st, cudaStream_t stream) {
  Strides loads;  // q, k, v, and dO in the place of o
  for (int i = 0; i < 3; ++i) {
    loads.q[i] = st.q[i];
    loads.k[i] = st.k[i];
    loads.v[i] = st.v[i];
    loads.o[i] = st.dO[i];
  }
  switch (copy_bytes(q, k, v, dO, loads, hd, 2, 16)) {
    case 16: return launch_bwd<HD, 16>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, stream);
    case 8: return launch_bwd<HD, 8>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, stream);
    case 4: return launch_bwd<HD, 4>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The scratch's floats (part_offset) at the padded HD that holds hd
int scratch_floats(int B, int H, int KV, int S, int hd, int window, long long* floats) {
  *floats = static_cast<long long>(B) * H * S;
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  if (hd < 1 || hd > 256 || KV < 1 || H % KV) return static_cast<int>(cudaErrorInvalidValue);
  const int group = H / KV;
  int parts = 1, err;
  if (hd <= 16) err = dkdv_parts<16>(B, KV, S, group, window, &parts);
  else if (hd <= 32) err = dkdv_parts<32>(B, KV, S, group, window, &parts);
  else if (hd <= 64) err = dkdv_parts<64>(B, KV, S, group, window, &parts);
  else if (hd <= 128) err = dkdv_parts<128>(B, KV, S, group, window, &parts);
  else err = dkdv_parts<256>(B, KV, S, group, window, &parts);
  if (parts > 1)
    *floats = part_offset(B, H, S) + 2LL * parts * B * KV * S * hd;
  return err;
}

}  // namespace tcb

// ----------------------------------------- backward, f32 3xTF32 tensor cores

namespace tf3 {

constexpr int kThreads = 256;  // 8 warps: 4 row groups of 16 × 2 column halves
constexpr int kRows = 64;      // rows of a block: keys (dK/dV) or queries (dQ)
constexpr float kLog2e = 1.4426950408889634f;

template <int HD>
struct Cfg {
  // columns of a pair's tile: what shared memory holds beside the 64 rows
  static constexpr int BC = HD == 256 ? 16 : HD == 128 ? 32 : 64;
  static constexpr int LDP = BC + 4;  // padded f32 row of P or dS
  static constexpr int NJ = BC / 16;  // 8-column mma tiles of a warp's scores
  static constexpr int NI = HD / 16;  // 8-column mma tiles of a warp's gradient
  // k-steps of the score products unrolled together: all of them up to
  // HD 128, 8 of the 32 at HD 256 (16 spill there)
  static constexpr int KI = HD == 256 ? 8 : HD / 8;
  // the two resident tiles split once into shared memory (big, small): at
  // HD 256 their small parts would not fit
  static constexpr bool kPre = HD <= 128;
  static constexpr int kResident = (kPre ? 4 : 2) * kRows * HD;  // floats
  // K, V (and their small parts); two stages of Q and dO; Pᵀ and dSᵀ; two
  // stages of lse and D
  static constexpr int kDkdvSmem = (kResident + 4 * BC * HD + 2 * kRows * LDP + 4 * BC) * 4;
  // Q, dO (and their small parts); two stages of K and V; dS
  static constexpr int kDqSmem = (kResident + 4 * BC * HD + kRows * LDP) * 4;
};

// The K, V, Q and dO tiles are f32 rows of HD floats, unpadded, with their
// 16-byte chunks swizzled: logical chunk c of row r lies at chunk c ^ swz(r).
// Two reads meet these tiles: row-wise fragments (ldmatrix, 8 rows × one
// chunk, and a[g][t]) and the transposed B fragments of the gradient
// products (B[k = t][n = g]: 4 rows × 2 chunks).  A padded row (HD + 4)
// serves the first without conflicts (banks 4g + t) and the second 2-way
// conflicted (banks 4t + g); this swizzle serves both: swz takes 8 distinct
// values over 8 consecutive rows (the row-wise reads land in 8 distinct
// 4-bank groups), and over rows t and t + 4 of a k-step it is 2t and 2t + 1,
// so chunks c0, c0 + 1 (c0 even) of 4 rows fill 8 distinct groups.  At
// HD 16 a row is 4 chunks (two rows a bank line) and swz takes the values
// that keep both properties within 4.
template <int HD>
__device__ __forceinline__ int swz(int r) {
  if constexpr (HD == 16)
    return 2 * ((r >> 1) & 1) + ((r >> 2) & 1);
  else
    return 2 * (r & 3) + ((r >> 2) & 1);
}

// The float offset of element (r, c) of a swizzled tile
template <int HD>
__device__ __forceinline__ int at(int r, int c) {
  return r * HD + (((c >> 2) ^ swz<HD>(r)) << 2) + (c & 3);
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(addr));
}

// x rounded to TF32 (10 mantissa bits), to nearest with ties away from zero,
// on its bits (cvt.rna.tf32.f32 compiles to a compare-and-select sequence
// for NaN and infinity, which dominated the split's instructions)
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x (f32 bits) = big + small: big = tf32(x), small = x − big exactly (an f32
// of at most 13 significant bits below big's last), passed as it is: the
// tensor cores read the top 19 bits of a TF32 operand, which truncates
// small to TF32 (an error below 2⁻²¹ of x)
template <int N>
__device__ __forceinline__ void split(const uint32_t (&x)[N], uint32_t (&big)[N],
                                      uint32_t (&small)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const float f = __uint_as_float(x[i]);
    big[i] = tf32(f);
    small[i] = __float_as_uint(f - __uint_as_float(big[i]));
  }
}

// The two resident 64-row tiles (adjacent, 2·64·HD floats) split in place:
// big where they lie, small 2·64·HD floats further on
template <int HD>
__device__ __forceinline__ void presplit(float* tiles, int tid) {
  float4* big = reinterpret_cast<float4*>(tiles);
  float4* small = reinterpret_cast<float4*>(tiles + 2 * kRows * HD);
  for (int i = tid; i < 2 * kRows * HD / 4; i += kThreads) {
    const float4 f = big[i];
    const float4 b = make_float4(__uint_as_float(tf32(f.x)), __uint_as_float(tf32(f.y)),
                                 __uint_as_float(tf32(f.z)), __uint_as_float(tf32(f.w)));
    big[i] = b;
    small[i] = make_float4(f.x - b.x, f.y - b.y, f.z - b.z, f.w - b.w);
  }
}

// d += a·b for a 16×8 TF32 A (row), an 8×8 TF32 B (col), f32 D
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a·b in 3xTF32: small·big, big·small, then big·big (small·small dropped)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(d, as, bb0, bb1);
  mma_tf32(d, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// a·b in 3xTF32: the cross terms small·big and big·small into e, big·big
// into d (small·small dropped).  Two accumulators halve the chain of
// dependent mmas, and keep the cross terms, 2⁻¹¹ of the product, from being
// truncated against its size: the tensor cores add into an f32 accumulator
// rounding toward zero, so a long chain into one accumulator drifts.
__device__ __forceinline__ void mma3(float (&d)[4], float (&e)[4], const uint32_t (&ab)[4],
                                     const uint32_t (&as)[4], uint32_t bb0,
                                     uint32_t bb1, uint32_t bs0, uint32_t bs1) {
  mma_tf32(e, as, bb0, bb1);
  mma_tf32(e, ab, bs0, bs1);
  mma_tf32(d, ab, bb0, bb1);
}

// This lane's shared-memory offsets (floats) into a block's tiles.  The
// chunk of k-step ks (2·ks + h) has its low three bits in 2·(ks mod 4) + h
// and the rest in ks / 4, and the swizzle only touches the low three, so a
// k-step's offset is one of four per lane plus (ks / 4)·32.
template <int HD>
struct Lane {
  int a[4];       // A fragments (ldmatrix) of the warp's 16 rows of a row tile
  int b[4];       // B fragments (ldmatrix) of its BC/2 rows of a column tile
  int t0[4], t1[4];  // transposed B: depth rows t, t + 4; column tile i: [i mod 4] + (i / 4)·32
  int p;          // A fragments (ldmatrix) of a [64][LDP] P or dS tile

  __device__ __forceinline__ Lane(int rw, int cw, int lane) {
    const int g = lane / 4, t = lane % 4;
    // ldmatrix: lane L gives a row of matrix L / 8
    const int ar = rw * 16 + (lane & 7) + ((lane >> 3) & 1) * 8, ah = lane >> 4;
    const int br = cw * (Cfg<HD>::BC / 2) + (lane & 7) + (lane >> 4) * 8, bh = (lane >> 3) & 1;
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      a[e] = ar * HD + (((2 * e + ah) ^ swz<HD>(ar)) << 2);
      b[e] = br * HD + (((2 * e + bh) ^ swz<HD>(br)) << 2);
      const int c = cw * (HD / 8) + 2 * e + (g >> 2);  // the column's chunk
      t0[e] = t * HD + ((c ^ swz<HD>(t)) << 2) + (g & 3);
      t1[e] = (t + 4) * HD + ((c ^ swz<HD>(t + 4)) << 2) + (g & 3);
    }
    p = ar * Cfg<HD>::LDP + ah * 4;
  }
};

// ROWS rows of hd floats from rows row0… of a strided tensor into a
// swizzled tile of HD columns, by cp.async of kBytes a copy; rows at or past
// S and columns at or past hd are zero-filled.  A thread copies one column
// of kBytes, every kStep-th row: its column, first row and pointer are
// computed once.
template <int HD, int ROWS, int kBytes>
__device__ __forceinline__ void load_tile(float* tile, const float* src,
                                          long long stride, int row0, int S,
                                          int hd, int tid) {
  constexpr int kElems = kBytes / 4;           // floats a copy
  constexpr int kChunks = HD / kElems;         // copies a row (a power of 2 ≤ 256)
  constexpr int kStep = kThreads / kChunks;    // rows a pass of the block
  static_assert(kThreads % kChunks == 0, "whole rows a pass");
  const int r0 = tid / kChunks, c = (tid % kChunks) * kElems;
  const bool col_in = c < hd;
  const float* p = src + static_cast<long long>(row0 + r0) * stride + c;
#pragma unroll(kBytes == 16 ? 16 : 4)
  for (int it = 0; it < (ROWS + kStep - 1) / kStep; ++it) {
    const int r = r0 + it * kStep;
    if (ROWS % kStep == 0 || r < ROWS) {
      const bool in = col_in && row0 + r < S;
      tc::cp_async<kBytes>(smem_u32(tile + at<HD>(r, c)),
                           in ? p + static_cast<long long>(it) * kStep * stride : src, in);
    }
  }
}

// x = R1·C1ᵀ and y = R2·C2ᵀ on this warp's 16 rows and BC/2 columns of a
// pair's 64 × BC score tiles, in 3xTF32, in f32.  R1, R2: the resident
// [64][HD] row tiles, their small parts 2·64·HD floats on where kPre;
// C1, C2: [BC][HD] column tiles.  All HD/8 k-steps run, the padding's on
// zeros (a branch at the padding would keep the compiler from moving a
// k-step's loads ahead of the last one's mmas), unrolled KI at a time.
template <int HD>
__device__ __forceinline__ void tile_scores(float (&x)[Cfg<HD>::NJ][4],
                                            float (&y)[Cfg<HD>::NJ][4],
                                            const float* R1, const float* R2,
                                            const float* C1, const float* C2,
                                            const Lane<HD>& ln) {
  constexpr int NJ = Cfg<HD>::NJ, KI = Cfg<HD>::KI;
  constexpr int kSmall = 2 * kRows * HD;
  static_assert(KI % 4 == 0 || KI == HD / 8, "k-steps a group: whole lane offsets");
  float xs[NJ][4], ys[NJ][4];  // the cross terms
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) x[j][e] = y[j][e] = xs[j][e] = ys[j][e] = 0.0f;
#pragma unroll 1
  for (int kq = 0; kq < HD / 8 / KI; ++kq) {
#pragma unroll
    for (int e = 0; e < KI; ++e) {
      const int kc = (kq * (KI / 4) + e / 4) * 32;  // k-step kq·KI + e
      const int ka = ln.a[e % 4] + kc, kb = ln.b[e % 4] + kc;
      uint32_t a1b[4], a1s[4], a2b[4], a2s[4];
      if constexpr (Cfg<HD>::kPre) {
        tc::ldmatrix_x4(a1b, smem_u32(R1 + ka));
        tc::ldmatrix_x4(a1s, smem_u32(R1 + kSmall + ka));
        tc::ldmatrix_x4(a2b, smem_u32(R2 + ka));
        tc::ldmatrix_x4(a2s, smem_u32(R2 + kSmall + ka));
      } else {
        uint32_t a[4];
        tc::ldmatrix_x4(a, smem_u32(R1 + ka));
        split(a, a1b, a1s);
        tc::ldmatrix_x4(a, smem_u32(R2 + ka));
        split(a, a2b, a2s);
      }
      if constexpr (NJ == 1) {
        uint32_t b[2], bb[2], bs[2];
        ldmatrix_x2(b, smem_u32(C1 + kb));
        split(b, bb, bs);
        mma3(x[0], xs[0], a1b, a1s, bb[0], bb[1], bs[0], bs[1]);
        ldmatrix_x2(b, smem_u32(C2 + kb));
        split(b, bb, bs);
        mma3(y[0], ys[0], a2b, a2s, bb[0], bb[1], bs[0], bs[1]);
      } else {
#pragma unroll
        for (int j = 0; j < NJ; j += 2) {
          uint32_t b[4], bb[4], bs[4];
          tc::ldmatrix_x4(b, smem_u32(C1 + kb + j * 8 * HD));
          split(b, bb, bs);
          mma3(x[j], xs[j], a1b, a1s, bb[0], bb[1], bs[0], bs[1]);
          mma3(x[j + 1], xs[j + 1], a1b, a1s, bb[2], bb[3], bs[2], bs[3]);
          tc::ldmatrix_x4(b, smem_u32(C2 + kb + j * 8 * HD));
          split(b, bb, bs);
          mma3(y[j], ys[j], a2b, a2s, bb[0], bb[1], bs[0], bs[1]);
          mma3(y[j + 1], ys[j + 1], a2b, a2s, bb[2], bb[3], bs[2], bs[3]);
        }
      }
    }
  }
#pragma unroll
  for (int j = 0; j < NJ; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[j][e] += xs[j][e];
      y[j][e] += ys[j][e];
    }
}

// This warp's 16 × BC/2 part of a score tile, in f32, into the shared
// [64][LDP] tile P (row-major, as the accumulators lie)
template <int HD>
__device__ __forceinline__ void store_scores(float* P, const float (&x)[Cfg<HD>::NJ][4],
                                             int rw, int cw, int lane) {
  using C = Cfg<HD>;
  float* row = P + (rw * 16 + lane / 4) * C::LDP + cw * (C::BC / 2) + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < C::NJ; ++j) {
    *reinterpret_cast<float2*>(row + j * 8) = make_float2(x[j][0], x[j][1]);
    *reinterpret_cast<float2*>(row + 8 * C::LDP + j * 8) = make_float2(x[j][2], x[j][3]);
  }
}

// acc += A·B on this warp's 16 rows and HD/2 columns, 3xTF32: A the shared
// [64][LDP] P or dS tile (ldmatrix, split once for all its k-steps), B a
// [BC][HD] column tile whose rows are the product's depth (transposed
// 32-bit loads).  The pair's product is summed in fresh accumulators, up to
// eight column tiles at a time, and added to acc in f32 (round to nearest):
// a block's sum runs over hundreds of pairs, too long a chain for the
// tensor cores' truncating accumulation.  The padding's columns run on zeros.
template <int HD>
__device__ __forceinline__ void tile_product(float (&acc)[Cfg<HD>::NI][4],
                                             const float* A, const float* B,
                                             const Lane<HD>& ln) {
  using C = Cfg<HD>;
  constexpr int KS = C::BC / 8, NG = C::NI < 8 ? C::NI : 8;
  uint32_t ab[KS][4], as[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks) {
    uint32_t a[4];
    tc::ldmatrix_x4(a, smem_u32(A + ln.p + ks * 8));
    split(a, ab[ks], as[ks]);
  }
#pragma unroll
  for (int i0 = 0; i0 < C::NI; i0 += NG) {
    float t[NG][4];
#pragma unroll
    for (int i = 0; i < NG; ++i) t[i][0] = t[i][1] = t[i][2] = t[i][3] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const float* Bk = B + ks * 8 * HD + (i0 / 4) * 32;
#pragma unroll
      for (int i = 0; i < NG; ++i) {
        const int off = ln.t0[i % 4] + (i / 4) * 32, off1 = ln.t1[i % 4] + (i / 4) * 32;
        const uint32_t b[2] = {__float_as_uint(Bk[off]), __float_as_uint(Bk[off1])};
        uint32_t bb[2], bs[2];
        split(b, bb, bs);
        mma3(t[i], ab[ks], as[ks], bb[0], bb[1], bs[0], bs[1]);
      }
    }
#pragma unroll
    for (int i = 0; i < NG; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i0 + i][e] += t[i][e];
  }
}

// rows r0 and r0 + 8 (< S) of this warp's HD/2 gradient columns (< hd),
// times mul, in f32 (any hd and strides: one float a store)
template <int HD>
__device__ __forceinline__ void store_grad(float* dst, long long stride,
                                           const float (&acc)[Cfg<HD>::NI][4],
                                           float mul, int r0, int S, int hd,
                                           int cw, int lane) {
#pragma unroll
  for (int i = 0; i < Cfg<HD>::NI; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = r0 + (e >= 2 ? 8 : 0);
      const int col = cw * (HD / 2) + i * 8 + 2 * (lane % 4) + (e & 1);
      if (row < S && col < hd) dst[row * stride + col] = acc[i][e] * mul;
    }
  }
}

// dK, dV of one (b, kv head, 64-key tile), summed over the group's query
// heads and the query tiles of BC rows that see the key tile
template <int HD, int kBytes>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf3_dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                          const float* __restrict__ v, const float* __restrict__ dO,
                          const float* __restrict__ lse, const float* __restrict__ D,
                          float* __restrict__ dk, float* __restrict__ dv, int H, int S,
                          int hd, int group, int window, float scale_log2, float scale,
                          bw::BwdStrides st) {
  using C = Cfg<HD>;
  constexpr int BC = C::BC, NJ = C::NJ, NI = C::NI;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                  // [64][HD]
  float* Vs = Ks + kRows * HD;       // [64][HD]; then their small parts (kPre)
  float* Qs = Ks + C::kResident;     // [2][BC][HD]
  float* dOs = Qs + 2 * BC * HD;     // [2][BC][HD]
  float* PT = dOs + 2 * BC * HD;     // [64 keys][LDP]: Pᵀ
  float* dST = PT + kRows * C::LDP;  // [64 keys][LDP]: dSᵀ
  float* lse_s = dST + kRows * C::LDP;  // [2][BC]
  float* D_s = lse_s + 2 * BC;          // [2][BC]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp % 4, cw = warp / 4;
  // key tiles ascending, each across every kv head before the next
  const long long lin = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int k0 = static_cast<int>(lin / gridDim.y) * kRows;
  const int hk = static_cast<int>(lin % gridDim.y), bi = blockIdx.z;
  const int k_last = min(k0 + kRows, S) - 1;
  const int qt_lo = k0 / BC;
  const int qt_hi = (window > 0 ? min(S - 1, k_last + window - 1) : S - 1) / BC;
  const int nq = qt_hi - qt_lo + 1, pairs = group * nq;
  const Lane<HD> ln(rw, cw, lane);

  // pair p: query head hk·G + p / nq, query tile qt_lo + p % nq, with its
  // lse and D rows, into ring stage `stage`
  auto load_pair = [&](int p, int stage) {
    const int h = hk * group + p / nq, q0 = (qt_lo + p % nq) * BC;
    load_tile<HD, BC, kBytes>(Qs + stage * BC * HD, q + bi * st.q[0] + h * st.q[1],
                              st.q[2], q0, S, hd, tid);
    load_tile<HD, BC, kBytes>(dOs + stage * BC * HD, dO + bi * st.dO[0] + h * st.dO[1],
                              st.dO[2], q0, S, hd, tid);
    if (tid < 2 * BC) {
      const int r = tid % BC, pos = q0 + r;
      const bool in = pos < S;
      const float* src = (tid < BC ? lse : D) +
                         (in ? (static_cast<long long>(bi) * H + h) * S + pos : 0);
      tc::cp_async<4>(smem_u32((tid < BC ? lse_s : D_s) + stage * BC + r), src, in);
    }
  };

  load_tile<HD, kRows, kBytes>(Ks, k + bi * st.k[0] + hk * st.k[1], st.k[2], k0, S, hd, tid);
  load_tile<HD, kRows, kBytes>(Vs, v + bi * st.v[0] + hk * st.v[1], st.v[2], k0, S, hd, tid);
  load_pair(0, 0);
  cp_async_commit();
  if constexpr (C::kPre) {
    cp_async_wait_all();
    __syncthreads();
    presplit<HD>(Ks, tid);  // published by the loop's first barrier
  }

  float acc_k[NI][4], acc_v[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.0f;
  const int kr = k0 + rw * 16 + lane / 4;  // this thread's keys kr, kr + 8

  for (int p = 0; p < pairs; ++p) {
    const int stage = p & 1;
    cp_async_wait_all();
    __syncthreads();  // pair p is in; every warp is done with pair p − 1
    if (p + 1 < pairs) load_pair(p + 1, stage ^ 1);
    cp_async_commit();
    const float* Qc = Qs + stage * BC * HD;
    const float* dOc = dOs + stage * BC * HD;
    const float* lse_c = lse_s + stage * BC;
    const float* D_c = D_s + stage * BC;
    const int q0 = (qt_lo + p % nq) * BC;

    float x[NJ][4], y[NJ][4];
    tile_scores<HD>(x, y, Ks, Vs, Qc, dOc, ln);  // Sᵀ = K·Qᵀ, dPᵀ = V·dOᵀ

    // Pᵀ and dSᵀ in f32: lse and D by the accumulator's column, the query;
    // masked only on tiles that cross the diagonal, the window's edge or S
    const bool inside = k0 + kRows - 1 <= q0 && q0 + BC <= S &&
                        (window <= 0 || k0 > q0 + BC - 1 - window);
    auto probs = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const int c = cw * (BC / 2) + j * 8 + 2 * (lane % 4);
        const float2 l2 = *reinterpret_cast<const float2*>(lse_c + c);
        const float2 d2 = *reinterpret_cast<const float2*>(D_c + c);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kp = kr + (e >= 2 ? 8 : 0), qp = q0 + c + (e & 1);
          const bool ok = !decltype(masked)::value || (kp <= qp && qp < S && (window <= 0 || kp > qp - window));
          const float lq = ((e & 1) ? l2.y : l2.x) * kLog2e;
          const float pr = ok ? exp2f(x[j][e] * scale_log2 - lq) : 0.0f;
          x[j][e] = pr;
          y[j][e] = pr * (y[j][e] - ((e & 1) ? d2.y : d2.x));
        }
      }
    };
    if (inside)
      probs(std::false_type{});
    else
      probs(std::true_type{});
    store_scores<HD>(PT, x, rw, cw, lane);
    store_scores<HD>(dST, y, rw, cw, lane);
    __syncthreads();  // Pᵀ and dSᵀ are whole
    tile_product<HD>(acc_v, PT, dOc, ln);   // dV += Pᵀ·dO
    tile_product<HD>(acc_k, dST, Qc, ln);   // dK += dSᵀ·Q
  }
  store_grad<HD>(dk + bi * st.dk[0] + hk * st.dk[1], st.dk[2], acc_k, scale, kr, S, hd,
                 cw, lane);
  store_grad<HD>(dv + bi * st.dv[0] + hk * st.dv[1], st.dv[2], acc_v, 1.0f, kr, S, hd,
                 cw, lane);
}

// dQ of one (b, head, 64-query tile), over the key tiles of BC keys it sees
template <int HD, int kBytes>
__global__ void __launch_bounds__(kThreads, 1)
flash_bwd_tf3_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                        const float* __restrict__ v, const float* __restrict__ dO,
                        const float* __restrict__ lse, const float* __restrict__ D,
                        float* __restrict__ dq, int H, int S, int hd, int group,
                        int window, float scale_log2, float scale, bw::BwdStrides st) {
  using C = Cfg<HD>;
  constexpr int BC = C::BC, NJ = C::NJ, NI = C::NI;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                  // [64][HD]
  float* dOs = Qs + kRows * HD;      // [64][HD]; then their small parts (kPre)
  float* Ks = Qs + C::kResident;     // [2][BC][HD]
  float* Vs = Ks + 2 * BC * HD;      // [2][BC][HD]
  float* dSs = Vs + 2 * BC * HD;     // [64 queries][LDP]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rw = warp % 4, cw = warp / 4;
  // query tiles descending (the last see the most keys), each across every
  // head before the next
  const long long lin = static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x;
  const int q0 = (static_cast<int>(gridDim.x) - 1 - static_cast<int>(lin / gridDim.y)) * kRows;
  const int h = static_cast<int>(lin % gridDim.y), bi = blockIdx.z, hk = h / group;
  const int q_last = min(q0 + kRows, S) - 1;
  const int kt_lo = window > 0 ? max(0, q0 - window + 1) / BC : 0;
  const int kt_hi = q_last / BC;
  const float* kb = k + bi * st.k[0] + hk * st.k[1];
  const float* vb = v + bi * st.v[0] + hk * st.v[1];
  const Lane<HD> ln(rw, cw, lane);

  load_tile<HD, kRows, kBytes>(Qs, q + bi * st.q[0] + h * st.q[1], st.q[2], q0, S, hd, tid);
  load_tile<HD, kRows, kBytes>(dOs, dO + bi * st.dO[0] + h * st.dO[1], st.dO[2], q0, S, hd,
                               tid);
  load_tile<HD, BC, kBytes>(Ks, kb, st.k[2], kt_lo * BC, S, hd, tid);
  load_tile<HD, BC, kBytes>(Vs, vb, st.v[2], kt_lo * BC, S, hd, tid);
  cp_async_commit();
  if constexpr (C::kPre) {
    cp_async_wait_all();
    __syncthreads();
    presplit<HD>(Qs, tid);  // published by the loop's first barrier
  }

  // this thread's rows r0, r0 + 8: lse (log2 domain) and D in registers
  const int r0 = q0 + rw * 16 + lane / 4, r1 = r0 + 8;
  const long long lrow = (static_cast<long long>(bi) * H + h) * S;
  const float l0 = r0 < S ? lse[lrow + r0] * kLog2e : 0.0f;
  const float l1 = r1 < S ? lse[lrow + r1] * kLog2e : 0.0f;
  const float d0 = r0 < S ? D[lrow + r0] : 0.0f;
  const float d1 = r1 < S ? D[lrow + r1] : 0.0f;

  float acc[NI][4];
#pragma unroll
  for (int i = 0; i < NI; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.0f;

  for (int kt = kt_lo; kt <= kt_hi; ++kt) {
    const int stage = (kt - kt_lo) & 1;
    cp_async_wait_all();
    __syncthreads();  // tile kt is in; every warp is done with kt − 1
    if (kt < kt_hi) {
      const int next = (stage ^ 1) * BC * HD;
      load_tile<HD, BC, kBytes>(Ks + next, kb, st.k[2], (kt + 1) * BC, S, hd, tid);
      load_tile<HD, BC, kBytes>(Vs + next, vb, st.v[2], (kt + 1) * BC, S, hd, tid);
    }
    cp_async_commit();
    const float* Kc = Ks + stage * BC * HD;
    const float* Vc = Vs + stage * BC * HD;

    float x[NJ][4], y[NJ][4];
    tile_scores<HD>(x, y, Qs, dOs, Kc, Vc, ln);  // S = Q·Kᵀ, dP = dO·Vᵀ

    const int k0 = kt * BC;
    const bool inside = k0 + BC - 1 <= q0 && q0 + kRows <= S &&
                        (window <= 0 || k0 > q0 + kRows - 1 - window);
    auto grads = [&](auto masked) {
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int qp = e < 2 ? r0 : r1;
          const int kp = k0 + cw * (BC / 2) + j * 8 + 2 * (lane % 4) + (e & 1);
          const bool ok = !decltype(masked)::value || (kp <= qp && qp < S && (window <= 0 || kp > qp - window));
          const float pr = ok ? exp2f(x[j][e] * scale_log2 - (e < 2 ? l0 : l1)) : 0.0f;
          y[j][e] = pr * (y[j][e] - (e < 2 ? d0 : d1));
        }
      }
    };
    if (inside)
      grads(std::false_type{});
    else
      grads(std::true_type{});
    store_scores<HD>(dSs, y, rw, cw, lane);
    __syncthreads();  // dS is whole
    tile_product<HD>(acc, dSs, Kc, ln);  // dQ += dS·K
  }
  store_grad<HD>(dq + bi * st.dq[0] + h * st.dq[1], st.dq[2], acc, scale, r0, S, hd, cw,
                 lane);
}

template <int HD, int kBytes>
int launch_bwd(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dO, void* dq, void* dk, void* dv,
               void* D, int B, int H, int KV, int S, int hd, int window,
               const bw::BwdStrides& st, cudaStream_t stream) {
  using C = Cfg<HD>;
  const float sl2 = scale_log2(hd);
  const float scale = 1.0f / sqrtf(static_cast<float>(hd));
  cudaError_t err = static_cast<cudaError_t>(
      bw::launch_dot<float>(o, dO, D, B, H, S, hd, st, stream));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int tiles = (S + kRows - 1) / kRows;
  auto dkdv = flash_bwd_tf3_dkdv_kernel<HD, kBytes>;
  err = cudaFuncSetAttribute(dkdv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             C::kDkdvSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dkdv<<<dim3(tiles, KV, B), kThreads, C::kDkdvSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<float*>(dk), static_cast<float*>(dv), H, S, hd, H / KV, window, sl2,
      scale, st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  auto dqk = flash_bwd_tf3_dq_kernel<HD, kBytes>;
  err = cudaFuncSetAttribute(dqk, cudaFuncAttributeMaxDynamicSharedMemorySize, C::kDqSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dqk<<<dim3(tiles, H, B), kThreads, C::kDqSmem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(dO),
      static_cast<const float*>(lse), static_cast<const float*>(D),
      static_cast<float*>(dq), H, S, hd, H / KV, window, sl2, scale, st);
  return static_cast<int>(cudaGetLastError());
}

// cp.async copies of 16, 8 or 4 bytes, the widest that q, k, v and dO allow
// (a choice by layout, not a fallback); every f32 view allows 4.
template <int HD>
int launch_widths(const void* q, const void* k, const void* v, const void* o,
                  const void* lse, const void* dO, void* dq, void* dk, void* dv,
                  void* D, int B, int H, int KV, int S, int hd, int window,
                  const bw::BwdStrides& st, cudaStream_t stream) {
  Strides loads;  // q, k, v, and dO in the place of o
  for (int i = 0; i < 3; ++i) {
    loads.q[i] = st.q[i];
    loads.k[i] = st.k[i];
    loads.v[i] = st.v[i];
    loads.o[i] = st.dO[i];
  }
  switch (copy_bytes(q, k, v, dO, loads, hd, 4, 16)) {
    case 16: return launch_bwd<HD, 16>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, stream);
    case 8: return launch_bwd<HD, 8>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, stream);
    default: return launch_bwd<HD, 4>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, stream);
  }
}

}  // namespace tf3

// The backward of either dtype: bf16 on the bf16 tensor-core body, f32 on
// the 3xTF32 one, each instantiated for the smallest padded HD ≥ hd.
template <bool kBf16, int HD>
int launch_bwd_body(const void* q, const void* k, const void* v, const void* o,
               const void* lse, const void* dO, void* dq, void* dk, void* dv,
               void* D, int B, int H, int KV, int S, int hd, int window,
               const bw::BwdStrides& st, cudaStream_t stream) {
  if constexpr (kBf16)
    return tcb::launch_widths<HD>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, stream);
  else
    return tf3::launch_widths<HD>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, stream);
}

template <bool kBf16>
int dispatch_bwd(const void* q, const void* k, const void* v, const void* o,
                 const void* lse, const void* dO, void* dq, void* dk, void* dv,
                 void* D, int B, int H, int KV, int S, int hd, int window,
                 const long long* strides, void* stream) {
  if (B <= 0 || H <= 0 || S <= 0) return static_cast<int>(cudaSuccess);
  bw::BwdStrides st;
  for (int i = 0; i < 3; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[3 + i];
    st.v[i] = strides[6 + i];
    st.o[i] = strides[9 + i];
    st.dO[i] = strides[12 + i];
    st.dq[i] = strides[15 + i];
    st.dk[i] = strides[18 + i];
    st.dv[i] = strides[21 + i];
  }
  const auto s = static_cast<cudaStream_t>(stream);
  if (hd < 1 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 16) return launch_bwd_body<kBf16, 16>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, s);
  if (hd <= 32) return launch_bwd_body<kBf16, 32>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, s);
  if (hd <= 64) return launch_bwd_body<kBf16, 64>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, s);
  if (hd <= 128) return launch_bwd_body<kBf16, 128>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, s);
  return launch_bwd_body<kBf16, 256>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd, window, st, s);
}

}  // namespace

extern "C" {

// strides: 12 values, (b, head, position) of q, k, v and o, in elements.
// lse: null, or (B, H, S) contiguous f32 that gets each row's logsumexp.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        void* lse, int B, int H, int KV, int S, int hd,
                        int window, const long long* strides, void* stream) {
  return dispatch<false>(q, k, v, o, lse, B, H, KV, S, hd, window, strides, stream);
}

// bf16 needs hd and every stride even and every base pointer 4-byte aligned
// (cp.async copies 4 bytes at the least); the wrapper checks this.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         void* lse, int B, int H, int KV, int S, int hd,
                         int window, const long long* strides, void* stream) {
  return dispatch<true>(q, k, v, o, lse, B, H, KV, S, hd, window, strides, stream);
}

// The backward: q, k, v, o, lse (B, H, S) f32 and dO in; dq, dk, dv out;
// D (B, H, S) f32 scratch.  strides: 24 values, (b, head, position) of q,
// k, v, o, dO, dq, dk and dv, in elements; every head dimension contiguous.
int flash_attention_bwd_f32(const void* q, const void* k, const void* v,
                            const void* o, const void* lse, const void* dO,
                            void* dq, void* dk, void* dv, void* D, int B, int H,
                            int KV, int S, int hd, int window,
                            const long long* strides, void* stream) {
  return dispatch_bwd<false>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd,
                             window, strides, stream);
}

// bf16 needs what the forward's bf16 body needs of q, k, v and dO (an even
// hd, even strides, 4-byte aligned pointers), and of dq, dk, dv for their
// 4-byte stores; the wrapper checks this.  D is f32 scratch of
// flash_attention_bwd_bf16_scratch's floats (B·H·S, and the dK/dV partial
// sums where the grid is split), 16-byte aligned.
int flash_attention_bwd_bf16(const void* q, const void* k, const void* v,
                             const void* o, const void* lse, const void* dO,
                             void* dq, void* dk, void* dv, void* D, int B,
                             int H, int KV, int S, int hd, int window,
                             const long long* strides, void* stream) {
  return dispatch_bwd<true>(q, k, v, o, lse, dO, dq, dk, dv, D, B, H, KV, S, hd,
                            window, strides, stream);
}

// The floats of flash_attention_bwd_bf16's scratch D at these shapes, on
// the current device.
int flash_attention_bwd_bf16_scratch(int B, int H, int KV, int S, int hd,
                                     int window, long long* floats) {
  return tcb::scratch_floats(B, H, KV, S, hd, window, floats);
}

}  // extern "C"
