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
// The same lane layout as the forward above: one thread a lane,
// consecutive threads on consecutive addresses, the loads of a chunk of
// kChunk steps (a_t, g_t, h_{t-1}) issued before its chain of FMAs.  The
// entry point picks the block and the chunk from the lane count: where the
// B * lanes threads fill every SM with blocks of 256 (falcon-mamba's
// B * 131,072), 256 threads and chunks of 16; where they do not
// (recurrentgemma's B * 2,560), blocks of 64, so that the lanes spread
// over more SMs, and chunks of 32, so that each lane has more loads in
// flight.  Bit-exact with the plain version (repro_torch/kernels/ref.py
// scan_bwd_ref).  Bound on the H100: bytes, 5 * 4 per element (read a, h,
// g; write da, db): 5.37 GB and 1.60 ms at (1, 2048, 8192, 16), 210 MB and
// 0.063 ms at (1, 4096, 2560).  At the latter, B * W lanes with 3 * 32
// loads in flight each hold fewer bytes in flight than the memory's
// latency asks for (as rglru_scan's first forward did); that forward's
// cp.async ring is the redesign.
//
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

template <int kChunk>
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
    scan_bwd_kernel<16><<<grid, kThreads, 0, st>>>(ap, hp, gp, dap, dbp, S,
                                                   lanes);
  } else {
    constexpr int kFew = 64;
    const dim3 grid((lanes + kFew - 1) / kFew, B);
    scan_bwd_kernel<32><<<grid, kFew, 0, st>>>(ap, hp, gp, dap, dbp, S, lanes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
