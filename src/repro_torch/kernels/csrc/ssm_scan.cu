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
// scan_bwd: the gradients of either scan's recurrence (this one and
// rglru_scan's, over their lanes flattened: (B, S, D*N) or (B, S, W)) given
// g = dL/dh, walking S from the end (the reference differentiates its
// associative scan in XLA with a custom VJP, repro/models/ssm.py _ls_bwd;
// it has no Pallas backward):
//   gamma_t = a_{t+1} * gamma_{t+1} + g_t  (one FMA; gamma_{S-1} = g_{S-1})
//   db_t = gamma_t,  da_t = gamma_t * h_{t-1}  (h_{-1} = 0, one rounding).
// Bit-exact with the plain version (repro_torch/kernels/ref.py
// scan_bwd_ref): both bodies below make the same two roundings a step, a
// __fmaf_rn and a __fmul_rn, in the same order.  Bound on the H100: bytes,
// 5 * 4 per element (read a, h, g; write da, db): 5.37 GB and 1.60 ms at
// (1, 2048, 8192, 16), 210 MB and 0.063 ms at (1, 4096, 2560).  The entry
// point picks the body from the lane count (a choice by shape, not a
// fallback):
//
// - where the B * lanes threads fill every SM with blocks of 256
//   (falcon-mamba's B * 131,072), scan_bwd_kernel: the forward's lane
//   layout, one thread a lane, consecutive threads on consecutive
//   addresses, the loads of a chunk of 16 steps (a_t, g_t, h_{t-1}) issued
//   before its chain of FMAs (83 % of its bound at (1, 2048, 8192, 16));
//
// - where they do not (recurrentgemma's B * 2,560), scan_bwd_ring_kernel,
//   the rglru_scan forward's cp.async ring (csrc/rglru_scan.cu) walked
//   from the end.  The first kernel ran the lane layout there in blocks of
//   64 with chunks of 32: 40 blocks on 40 of the 132 SMs, each lane with
//   3 * 32 loads in flight, far fewer bytes than the memory's ~0.7 us
//   latency asks for (0.798 ms, 7.8 % of the bound).  A ring block owns one
//   batch row and kRingC consecutive lanes (16: 64-byte rows); its 128
//   threads copy tiles of kRingT = 64 steps of a, g and h, the h tile one
//   step earlier (h_{-1} zero-filled), into a ring of 3 shared-memory
//   stages by cp.async, 16 bytes a copy, and keep the next two stages in
//   flight while one warp runs the current stage's chain, the last step
//   first, with gamma and a_{t+1} carried in registers from stage to
//   stage.  Each lane writes da over a and db over g in the stage, and the
//   block stores the stage's rows back with 16-byte stores.  Ragged S (a
//   first stage of fewer rows) and ragged lanes (a last group of fewer)
//   are masked; where lanes * 4 bytes or a pointer is not a multiple of 16
//   bytes, the same ring runs on 4-byte copies and stores (kVec = 1).
//   Shared memory (dynamic): 3 stages * 3 tensors * 64 * kRingC * 4 bytes,
//   36,864.  On an H100 SXM at 700 W at (1, 4096, 2560), 16 lanes a block
//   (160 blocks, half a warp on the chain) took 0.1028-0.1030 ms and 32
//   lanes (80 blocks, the rglru_scan forward's choice) 0.1136-0.1137, so
//   16 is kept: 0.099-0.103 ms, 61-63 % of the bound (the first kernel
//   0.797-0.809).

// Plain C entry points; each returns the launch's cudaError_t, and the
// Python wrapper (repro_torch/kernels/ssm_scan.py) raises if it is not 0.

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

__global__ void scan_bwd_kernel(const float* __restrict__ a,
                                const float* __restrict__ h,
                                const float* __restrict__ g,
                                float* __restrict__ da,
                                float* __restrict__ db, int S, int lanes) {
  const int lane = blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= lanes) return;
  const int64_t step = lanes;
  const int64_t base = static_cast<int64_t>(blockIdx.y) * S * step + lane;
  const float* ap = a + base;
  const float* hp = h + base;
  const float* gp = g + base;
  float* dap = da + base;
  float* dbp = db + base;
  float gamma = 0.0f, a_next = 0.0f;
  int t = S;  // steps t .. S-1 are done
  for (; t - kChunk >= 0; t -= kChunk) {
    float av[kChunk], gv[kChunk], hv[kChunk];
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int64_t off = (t - 1 - u) * step;
      av[u] = __ldg(ap + off);
      gv[u] = __ldg(gp + off);
      hv[u] = t - 2 - u >= 0 ? __ldg(hp + off - step) : 0.0f;
    }
#pragma unroll
    for (int u = 0; u < kChunk; ++u) {
      const int64_t off = (t - 1 - u) * step;
      gamma = __fmaf_rn(a_next, gamma, gv[u]);
      dbp[off] = gamma;
      dap[off] = __fmul_rn(gamma, hv[u]);
      a_next = av[u];
    }
  }
  for (--t; t >= 0; --t) {
    const int64_t off = t * step;
    gamma = __fmaf_rn(a_next, gamma, __ldg(gp + off));
    dbp[off] = gamma;
    dap[off] = __fmul_rn(gamma, t > 0 ? __ldg(hp + off - step) : 0.0f);
    a_next = __ldg(ap + off);
  }
}

// ------------------------------------------------- scan_bwd's ring body

constexpr int kRingC = 16;       // lanes of a block: 64-byte rows
constexpr int kRingT = 64;       // steps of a stage
constexpr int kRingStages = 3;   // ring depth; kRingStages - 1 in flight
constexpr int kRingThreads = 128;
constexpr int kRingChunk = 16;   // steps whose a, g, h a lane reads at once

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// kVec floats a copy: 4 (16 bytes, .cg) or 1 (4 bytes, .ca)
template <int kVec>
__device__ __forceinline__ void cp_async(uint32_t dst, const float* src) {
  if constexpr (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
                 "l"(src)
                 : "memory");
  }
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// kRingC lanes a block, kVec floats a copy and a store: 4 (16 bytes) or 1.
template <int kVec>
__global__ void __launch_bounds__(kRingThreads)
    scan_bwd_ring_kernel(const float* __restrict__ a,
                         const float* __restrict__ h,
                         const float* __restrict__ g, float* __restrict__ da,
                         float* __restrict__ db, int S, int lanes) {
  // a slot: a (then da), g (then db), h one step earlier; [kRingT][kC] each
  extern __shared__ __align__(16) float ring[];
  constexpr int kC = kRingC;
  constexpr int kTile = kRingT * kC;
  constexpr int kPieces = kC / kVec;  // copies of a row
  const int l0 = blockIdx.x * kC;
  const int64_t row0 = static_cast<int64_t>(blockIdx.y) * S;  // row (b, 0)
  const int stages = (S + kRingT - 1) / kRingT;

  // Stage k's steps t0 .. t0 + rows - 1 of a and g, and t0 - 1 .. of h,
  // into ring slot `slot`.
  auto load = [&](int k, int slot) {
    float* sa = ring + slot * 3 * kTile;
    float* sg = sa + kTile;
    float* sh = sg + kTile;
    const int t0 = k * kRingT, rows = min(kRingT, S - t0);
    for (int i = threadIdx.x; i < rows * kPieces; i += kRingThreads) {
      const int r = i / kPieces;
      const int w = (i % kPieces) * kVec;
      if (l0 + w < lanes) {
        const int64_t off = (row0 + t0 + r) * lanes + l0 + w;
        cp_async<kVec>(smem_u32(sa + r * kC + w), a + off);
        cp_async<kVec>(smem_u32(sg + r * kC + w), g + off);
        if (t0 + r > 0) {
          cp_async<kVec>(smem_u32(sh + r * kC + w), h + off - lanes);
        } else {
#pragma unroll
          for (int u = 0; u < kVec; ++u) sh[w + u] = 0.0f;  // h_{-1}
        }
      }
    }
  };

  // iteration i runs stage stages - 1 - i, in slot i % kRingStages
#pragma unroll
  for (int i = 0; i < kRingStages - 1; ++i) {
    if (i < stages) load(stages - 1 - i, i);
    cp_async_commit();  // one group a stage, empty past the first
  }
  const int c = threadIdx.x;
  const bool lane = c < kC && l0 + c < lanes;
  float gamma = 0.0f, a_next = 0.0f;
  for (int i = 0; i < stages; ++i) {
    cp_async_wait<kRingStages - 2>();  // this thread's copies of stage i are in
    __syncthreads();                   // everyone's are; slot i-1 is stored back
    const int ahead = i + kRingStages - 1;
    if (ahead < stages) load(stages - 1 - ahead, ahead % kRingStages);
    cp_async_commit();
    float* sa = ring + (i % kRingStages) * 3 * kTile;
    float* sg = sa + kTile;
    const float* sh = sg + kTile;
    const int t0 = (stages - 1 - i) * kRingT;
    const int rows = min(kRingT, S - t0);
    if (lane) {
      if (rows == kRingT) {
        // 16 steps' a, g and h read before their chain, so the chain waits
        // on shared memory once a chunk and not once a step
        for (int t1 = kRingT; t1 > 0; t1 -= kRingChunk) {
          float av[kRingChunk], gv[kRingChunk], hv[kRingChunk];
#pragma unroll
          for (int u = 0; u < kRingChunk; ++u) {
            const int r = t1 - 1 - u;
            av[u] = sa[r * kC + c];
            gv[u] = sg[r * kC + c];
            hv[u] = sh[r * kC + c];
          }
#pragma unroll
          for (int u = 0; u < kRingChunk; ++u) {
            const int r = t1 - 1 - u;
            gamma = __fmaf_rn(a_next, gamma, gv[u]);
            sg[r * kC + c] = gamma;
            sa[r * kC + c] = __fmul_rn(gamma, hv[u]);
            a_next = av[u];
          }
        }
      } else {
        for (int r = rows - 1; r >= 0; --r) {
          const float av = sa[r * kC + c];
          gamma = __fmaf_rn(a_next, gamma, sg[r * kC + c]);
          sg[r * kC + c] = gamma;
          sa[r * kC + c] = __fmul_rn(gamma, sh[r * kC + c]);
          a_next = av;
        }
      }
    }
    __syncthreads();  // the stage's da and db rows are complete
    for (int j = threadIdx.x; j < rows * kPieces; j += kRingThreads) {
      const int r = j / kPieces;
      const int w = (j % kPieces) * kVec;
      if (l0 + w < lanes) {
        const int64_t off = (row0 + t0 + r) * lanes + l0 + w;
        if constexpr (kVec == 4) {
          *reinterpret_cast<float4*>(da + off) =
              *reinterpret_cast<const float4*>(sa + r * kC + w);
          *reinterpret_cast<float4*>(db + off) =
              *reinterpret_cast<const float4*>(sg + r * kC + w);
        } else {
          da[off] = sa[r * kC + w];
          db[off] = sg[r * kC + w];
        }
      }
    }
  }
}

template <int kVec>
int launch_ring(const float* a, const float* h, const float* g, float* da,
                float* db, int B, int S, int lanes, cudaStream_t st) {
  constexpr int bytes = kRingStages * 3 * kRingT * kRingC * 4;
  auto kernel = scan_bwd_ring_kernel<kVec>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((lanes + kRingC - 1) / kRingC, B);
  kernel<<<grid, kRingThreads, bytes, st>>>(a, h, g, da, db, S, lanes);
  return static_cast<int>(cudaGetLastError());
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

int scan_bwd_f32(const void* a, const void* h, const void* g, void* da,
                 void* db, int B, int S, int lanes, void* stream) {
  if (B <= 0 || S <= 0 || lanes <= 0) return static_cast<int>(cudaSuccess);
  int device = 0, sms = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  const auto st = static_cast<cudaStream_t>(stream);
  const auto* ap = static_cast<const float*>(a);
  const auto* hp = static_cast<const float*>(h);
  const auto* gp = static_cast<const float*>(g);
  auto* dap = static_cast<float*>(da);
  auto* dbp = static_cast<float*>(db);
  if (static_cast<int64_t>(B) * lanes >= static_cast<int64_t>(sms) * kThreads) {
    const dim3 grid((lanes + kThreads - 1) / kThreads, B);
    scan_bwd_kernel<<<grid, kThreads, 0, st>>>(ap, hp, gp, dap, dbp, S, lanes);
    return static_cast<int>(cudaGetLastError());
  }
  // the ring: 16-byte copies and stores where lanes * 4 bytes and every
  // pointer allow them, else 4-byte ones
  const auto bits = reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(h) |
                    reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(da) |
                    reinterpret_cast<uintptr_t>(db);
  return lanes % 4 == 0 && bits % 16 == 0
             ? launch_ring<4>(ap, hp, gp, dap, dbp, B, S, lanes, st)
             : launch_ring<1>(ap, hp, gp, dap, dbp, B, S, lanes, st);
}

}  // extern "C"
