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
                 const float* __restrict__ v, float* __restrict__ o, int S,
                 int hd, int group, int window, float scale_log2, Strides st) {
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
// shared tile of HD columns, by cp.async of kBytes a copy; rows at or past
// S and columns at or past hd are zero-filled.
template <int HD, int ROWS, int kBytes>
__device__ __forceinline__ void load_tile(bf16* tile, const bf16* src,
                                          long long stride, int row0, int S,
                                          int hd, int tid) {
  constexpr int kElems = kBytes / 2;     // bf16 a copy
  constexpr int kChunks = HD / kElems;   // copies a row
  static_assert(ROWS * kChunks % kThreads == 0, "whole copies a thread");
  // the 16-byte copies unrolled whole (at most 16 a thread); the narrower
  // ones by 4, or the 8-byte instances at HD 128 and 256 spill
#pragma unroll(kBytes == 16 ? 16 : 4)
  for (int it = 0; it < ROWS * kChunks / kThreads; ++it) {
    const int i = tid + it * kThreads;
    const int r = i / kChunks, c = (i % kChunks) * kElems;
    const int pos = row0 + r;
    const bool in = pos < S && c < hd;
    cp_async<kBytes>(smem_u32(tile + r * Cfg<HD>::LD + c),
                     src + (in ? pos * stride + c : 0), in);
  }
}

template <int HD, int kBytes>
__global__ void __launch_bounds__(kThreads, 2)
flash_bf16_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                  const bf16* __restrict__ v, bf16* __restrict__ o, int S,
                  int hd, int group, int window, float scale_log2, Strides st) {
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
                    int B, int H, int KV, int S, int hd, int window,
                    const Strides& st, cudaStream_t stream) {
  constexpr int bytes = fp::Cfg<HD>::kSmemBytes;
  auto kernel = fp::flash_f32_kernel<HD, kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, fp::kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), S, hd, H / KV,
      window, scale_log2(hd), st);
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
int launch_f32(const void* q, const void* k, const void* v, void* o, int B,
               int H, int KV, int S, int hd, int window, const Strides& st,
               cudaStream_t stream) {
  return copy_bytes(q, k, v, o, st, hd, 4, 16) == 16
             ? launch_f32_body<HD, 4>(q, k, v, o, B, H, KV, S, hd, window, st, stream)
             : launch_f32_body<HD, 1>(q, k, v, o, B, H, KV, S, hd, window, st, stream);
}

template <int HD, int kBytes>
int launch_bf16_body(const void* q, const void* k, const void* v, void* o,
                     int B, int H, int KV, int S, int hd, int window,
                     const Strides& st, cudaStream_t stream) {
  constexpr int bytes = tc::Cfg<HD>::kSmemBytes;
  auto kernel = tc::flash_bf16_kernel<HD, kBytes>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + kBQ - 1) / kBQ, H, B);
  kernel<<<grid, tc::kThreads, bytes, stream>>>(
      static_cast<const tc::bf16*>(q), static_cast<const tc::bf16*>(k),
      static_cast<const tc::bf16*>(v), static_cast<tc::bf16*>(o), S, hd,
      H / KV, window, scale_log2(hd), st);
  return static_cast<int>(cudaGetLastError());
}

// cp.async copies of 16, 8 or 4 bytes, the widest the views' layout allows
// (a choice by layout, not a fallback); the wrapper refuses a layout that
// allows none (an odd hd or stride, or a pointer not 4-byte aligned).
template <int HD>
int launch_bf16(const void* q, const void* k, const void* v, void* o, int B,
                int H, int KV, int S, int hd, int window, const Strides& st,
                cudaStream_t stream) {
  switch (copy_bytes(q, k, v, o, st, hd, 2, 16)) {
    case 16: return launch_bf16_body<HD, 16>(q, k, v, o, B, H, KV, S, hd, window, st, stream);
    case 8: return launch_bf16_body<HD, 8>(q, k, v, o, B, H, KV, S, hd, window, st, stream);
    case 4: return launch_bf16_body<HD, 4>(q, k, v, o, B, H, KV, S, hd, window, st, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

template <bool kBf16, int HD>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int KV, int S, int hd, int window, const Strides& st,
           cudaStream_t stream) {
  if constexpr (kBf16)
    return launch_bf16<HD>(q, k, v, o, B, H, KV, S, hd, window, st, stream);
  else
    return launch_f32<HD>(q, k, v, o, B, H, KV, S, hd, window, st, stream);
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
  // the body instantiated for the smallest padded head dim HD ≥ hd
  if (hd < 1 || hd > 256) return static_cast<int>(cudaErrorInvalidValue);
  if (hd <= 16) return launch<kBf16, 16>(q, k, v, o, B, H, KV, S, hd, window, st, s);
  if (hd <= 32) return launch<kBf16, 32>(q, k, v, o, B, H, KV, S, hd, window, st, s);
  if (hd <= 64) return launch<kBf16, 64>(q, k, v, o, B, H, KV, S, hd, window, st, s);
  if (hd <= 128) return launch<kBf16, 128>(q, k, v, o, B, H, KV, S, hd, window, st, s);
  return launch<kBf16, 256>(q, k, v, o, B, H, KV, S, hd, window, st, s);
}

}  // namespace

extern "C" {

// strides: 12 values, (b, head, position) of q, k, v and o, in elements.
int flash_attention_f32(const void* q, const void* k, const void* v, void* o,
                        int B, int H, int KV, int S, int hd, int window,
                        const long long* strides, void* stream) {
  return dispatch<false>(q, k, v, o, B, H, KV, S, hd, window, strides, stream);
}

// bf16 needs hd and every stride even and every base pointer 4-byte aligned
// (cp.async copies 4 bytes at the least); the wrapper checks this.
int flash_attention_bf16(const void* q, const void* k, const void* v, void* o,
                         int B, int H, int KV, int S, int hd, int window,
                         const long long* strides, void* stream) {
  return dispatch<true>(q, k, v, o, B, H, KV, S, hd, window, strides, stream);
}

}  // extern "C"
