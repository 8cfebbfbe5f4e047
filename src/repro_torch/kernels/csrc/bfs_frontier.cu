// bfs_frontier: one BFS level with shortest-path counting, for B lanes.
//
//   agg[b, v] = sum over neighbours u of v of  sigma[b, u] * [dist[b, u] == level]
//
// Replaces repro/kernels/bfs_frontier.py::bfs_frontier (Pallas, TPU).  That
// kernel streamed edge blocks and scatter-added into a VMEM-resident
// accumulator, which is safe only because a TPU core runs its grid in order.
// Hopper runs blocks in parallel and in no order, so a scatter would need f32
// atomics whose arrival order changes sigma from run to run.  This is a PULL
// over the CSR instead: each (lane, vertex) is summed by one thread, over the
// vertex's arcs in CSR order, in f32, adding only the frontier terms.  The
// sum depends on nothing but its own lane's row, so a lane's result does not
// change with the other lanes of the batch (INDEXED_FRAME's bit-identity for
// every W rests on this), and it is bit-equal to a plain CSR-order loop.  The
// graph is undirected (every edge is two arcs), so in-neighbours are
// out-neighbours.
//
// What bounds it on an H100.  The function needs dist read and agg written,
// ~8 bytes a (lane, vertex): 2 GB at B = 256, n = 2^20 (0.6 ms).  A direct
// pull tests dist[b, u] for every (lane, arc): 4.9e9 random 4-byte gathers of
// a 1 GB array at 19.3 M arcs, each a 32-byte sector, whatever the frontier.
// (The first port did that, one thread a (lane, vertex), ~52 ms a level.)
// So a call is two launches, and the cost follows the frontier:
//
//  1. pack — one warp a (tile of 32 vertices, group g of 32 lanes).  It loads
//     the 32 rows of dist at the tile (32 coalesced loads in flight), makes
//     each row's frontier bits with __ballot_sync and transposes the 32 × 32
//     bit matrix in registers (five __shfl_xor_sync butterflies), so lane c
//     holds vertex c's word: front[u * G + g], bit i = lane 32 g + i
//     (G = ceil(B / 32); 32 MB at the full shape, which the 50 MB L2 holds,
//     where dist does not).  The frontier's sigma is loaded row by row
//     (coalesced), staged in shared memory and written packed by rank,
//     sigp[(u * G + g) * 32 + r] for the r-th set bit, one coalesced prefix a
//     vertex.
//  2. pull — one warp a (tile of 32 vertices, group g), thread i = lane
//     32 g + i.  The tile's arcs are one CSR range; the warp walks it 32
//     arcs at a time, in a pipeline that issues chunk c + 2's word gathers
//     (L2) and chunk c + 3's indices with chunk c's sigma loads.  A chunk
//     with no word set costs nothing more.  Otherwise the same bit transpose
//     turns the 32 arcs' words into each lane's mask of its frontier arcs,
//     and each lane walks its own set bits in arc order (eight sigma loads
//     in flight), reading sigp at its bit's rank and keeping one f32 sum,
//     stored in shared memory when the arc's vertex changes (a 5-step search
//     of the tile's indptr, which a lane holds per vertex).  agg goes out
//     32 vertices a coalesced row.  The G warps of a tile are neighbours in a
//     block, so the tile's CSR slice and front sectors come from memory once.
//
// Measured on an H100 (chip_smoke.py, 256 lanes, n = 2^20, warm L2): an empty
// level costs ~0.4 ms of pack and ~1.25 ms of pull, the pull then bound by
// the word gathers (one L1 wavefront a lane) and the 1 GB agg write; a dense
// level (74 % of the lanes' vertices in the frontier) ~1.3 + 8.3 ms, bound by
// one random sigp sector a (lane, arc) term.  Degree skew costs one warp a
// hub tile.  nvcc -Xptxas -v for sm_90a (printed by chip_smoke.py's build
// phase): pack 56 registers, pull 57, no spills, 33,792 bytes of static
// shared memory each.
//
// Scratch.  The caller allocates agg (B, n) f32 and the scratch front
// (n, G) uint32 and sigp (n, G, 32) f32; nothing in them needs to be
// initialised.  sigp has a slot for every (vertex, lane of the padded
// group), so it is as large as sigma whatever the frontier: 1 GiB + 32 MiB
// of front at B = 256, n = 2^20, on top of sigma, dist and agg (3 GiB).  A
// sigp sized by the frontier's entries would need their count on the host
// before the pull, a device-to-host sync a level.
//
// Plain C entry point; it returns the launches' cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 32;      // vertices of a warp's tile (and lanes of a group)
constexpr int kPackWarps = 8;  // (tile, group) warps of a pack block
constexpr int kPullWarps = 8;  // and of a pull block
constexpr unsigned kFull = 0xffffffffu;

// Lane r holds row r of a 32 × 32 bit matrix (bit c = column c); returns
// column `lane` (bit r = row r's bit `lane`): five butterfly steps, each
// swapping the off-diagonal blocks of size s.
__device__ __forceinline__ unsigned transpose32(unsigned x, int lane) {
  const unsigned masks[5] = {0x0000FFFFu, 0x00FF00FFu, 0x0F0F0F0Fu, 0x33333333u,
                             0x55555555u};
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    const int s = 16 >> i;
    const unsigned m = masks[i];
    const unsigned y = __shfl_xor_sync(kFull, x, s);
    x = (lane & s) ? (x & ~m) | ((y >> s) & m) : (x & m) | ((y & m) << s);
  }
  return x;
}

// One warp a (tile of 32 vertices, group of 32 lanes); the G warps of a tile
// are neighbours, so their 4-byte word stores fill whole sectors together.
__global__ void __launch_bounds__(kPackWarps * 32)
bfs_pack_kernel(const float* __restrict__ sigma, const int* __restrict__ dist,
                int level, unsigned* __restrict__ front,
                float* __restrict__ sigp, int64_t n, int B, int G) {
  __shared__ float s_sig[kPackWarps][kTile][kTile + 1];  // [lane][vertex]
  const int lane = threadIdx.x % 32, wib = threadIdx.x / 32;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kPackWarps + wib;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (w >= tiles * G) return;  // the same for the whole warp
  const int g = static_cast<int>(w % G);
  const int64_t u0 = (w / G) * kTile;
  const int64_t u = u0 + lane;               // this lane's vertex
  const bool in = u < n;
  const int rows = min(32, B - g * 32);      // lanes of the group
  const int64_t row0 = static_cast<int64_t>(g) * 32 * n + u;
  float(*sig_s)[kTile + 1] = s_sig[wib];

  int d[32];  // all 32 rows' loads in flight at once
#pragma unroll
  for (int r = 0; r < 32; ++r)
    d[r] = r < rows && in ? __ldg(dist + row0 + r * n) : 0;
  unsigned mine = 0;  // lane r: row r's frontier bits over the tile
#pragma unroll
  for (int r = 0; r < 32; ++r) {
    const unsigned bits = __ballot_sync(kFull, r < rows && in && d[r] == level);
    if (lane == r) mine = bits;
  }
  const unsigned word = transpose32(mine, lane);  // vertex u's lane bits
  if (in) front[u * G + g] = word;
  if (!__any_sync(kFull, word != 0)) return;
  // the frontier's sigma, row by row (coalesced, all in flight), staged
  // by [row][vertex]
  float sv[32];
#pragma unroll
  for (int r = 0; r < 32; ++r)
    sv[r] = (word >> r) & 1u ? __ldg(sigma + row0 + r * n) : 0.0f;
#pragma unroll
  for (int r = 0; r < 32; ++r) sig_s[r][lane] = sv[r];
  __syncwarp();
  // each vertex's slot: lane r writes rank r's value, a coalesced prefix
  const unsigned below = (1u << lane) - 1u;
  for (int c = 0; c < kTile; ++c) {
    const unsigned wc = __shfl_sync(kFull, word, c);
    if ((wc >> lane) & 1u)
      sigp[((u0 + c) * G + g) * 32 + __popc(wc & below)] = sig_s[lane][c];
  }
}

// One warp a (tile of 32 vertices, group g of 32 lanes), thread i = lane
// 32 g + i.  The tile's arcs are one CSR range; the warp walks it 32 arcs
// at a time.
__global__ void __launch_bounds__(kPullWarps * 32)
bfs_pull_kernel(const int* __restrict__ indptr, const int* __restrict__ indices,
                const unsigned* __restrict__ front,
                const float* __restrict__ sigp, float* __restrict__ agg,
                int64_t n, int B, int G) {
  __shared__ float s_acc[kPullWarps][kTile][kTile + 1];  // [vertex][lane]
  const int lane = threadIdx.x % 32, wib = threadIdx.x / 32;
  const int64_t w = static_cast<int64_t>(blockIdx.x) * kPullWarps + wib;
  const int64_t tiles = (n + kTile - 1) / kTile;
  if (w >= tiles * G) return;  // the same for the whole warp
  const int64_t v0 = (w / G) * kTile;
  const int g = static_cast<int>(w % G);
  const int R = static_cast<int>(min(static_cast<int64_t>(kTile), n - v0));
  float(*acc_s)[kTile + 1] = s_acc[wib];
  const unsigned below = (1u << lane) - 1u;
#pragma unroll
  for (int c = 0; c < kTile; ++c) acc_s[c][lane] = 0.0f;  // vertices with no term

  // vertex v0 + c starts at arc ip of lane c; the tile's arcs: [kbeg, kend)
  const int ip = lane < R ? __ldg(indptr + v0 + lane) : 0;
  const int kend = __ldg(indptr + v0 + R);
  const int kbeg = __shfl_sync(kFull, ip, 0);
  int cur = -1;  // the vertex whose sum this lane holds in acc
  float acc = 0.0f;

  // a pipeline over 32-arc chunks (A = chunk c, B = c + 1, C = c + 2): each
  // iteration issues chunk c + 2's words, chunk c + 3's sources and chunk
  // c's sigma loads together, so a chunk's words come two chunks ahead
  auto source = [&](int k0) {
    return k0 + lane < kend ? __ldg(indices + k0 + lane) : 0;
  };
  auto word_of = [&](int k0, int u) {
    return k0 + lane < kend ? __ldg(front + static_cast<int64_t>(u) * G + g) : 0u;
  };
  int uA = source(kbeg), uB = source(kbeg + 32), uC = source(kbeg + 64);
  unsigned wA = word_of(kbeg, uA), wB = word_of(kbeg + 32, uB);
  for (int c0 = kbeg; c0 < kend; c0 += 32) {
    const unsigned wC = word_of(c0 + 64, uC);
    const int uD = source(c0 + 96);
    if (__any_sync(kFull, wA != 0)) {
      // bit j of h: arc c0 + j's source is in this lane's frontier
      unsigned h = transpose32(wA, lane);
      // this lane's arc c0 + lane lies in vertex vtx: the last start ≤ it
      int vtx = 0;
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) {
        const int start = __shfl_sync(kFull, ip, (vtx + s) & 31);
        if (vtx + s < R && start <= c0 + lane) vtx += s;
      }
      // this lane's terms in arc order, eight loads in flight at a time
      for (int left = __reduce_max_sync(kFull, __popc(h)); left > 0; left -= 8) {
        float val[8];
        int vv[8];
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          const bool have = h != 0;
          const int j = have ? __ffs(h) - 1 : 0;
          h &= h - 1u;
          const int uj = __shfl_sync(kFull, uA, j);
          const unsigned wj = __shfl_sync(kFull, wA, j);
          const int vj = __shfl_sync(kFull, vtx, j);
          vv[t] = have ? vj : -1;
          val[t] = have ? __ldg(sigp + (static_cast<int64_t>(uj) * G + g) * 32 +
                                __popc(wj & below))
                        : 0.0f;
        }
#pragma unroll
        for (int t = 0; t < 8; ++t) {
          if (vv[t] < 0) continue;
          if (vv[t] != cur) {  // a new vertex: the last one's sum is done
            if (cur >= 0) acc_s[cur][lane] = acc;
            acc = 0.0f;
            cur = vv[t];
          }
          acc += val[t];
        }
      }
    }
    uA = uB;
    uB = uC;
    uC = uD;
    wA = wB;
    wB = wC;
  }
  if (cur >= 0) acc_s[cur][lane] = acc;
  __syncwarp();
  // agg rows of the group's lanes, 32 vertices a coalesced store
  for (int r = 0; r < 32 && g * 32 + r < B; ++r)
    if (lane < R) agg[static_cast<int64_t>(g * 32 + r) * n + v0 + lane] = acc_s[lane][r];
}

int launch_pack(const void* sigma, const void* dist, int level, void* front,
                void* sigp, long long n, int B, cudaStream_t stream) {
  const int G = (B + 31) / 32;
  const long long warps = (n + kTile - 1) / kTile * G;
  const long long blocks = (warps + kPackWarps - 1) / kPackWarps;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  bfs_pack_kernel<<<static_cast<unsigned>(blocks), kPackWarps * 32, 0, stream>>>(
      static_cast<const float*>(sigma), static_cast<const int*>(dist), level,
      static_cast<unsigned*>(front), static_cast<float*>(sigp), n, B, G);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

int bfs_frontier_f32(const void* indptr, const void* indices, const void* sigma,
                     const void* dist, int level, void* agg, long long n, int B,
                     void* front, void* sigp, void* stream) {
  if (n <= 0 || B <= 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const int G = (B + 31) / 32;
  const long long warps = (n + kTile - 1) / kTile * G;
  const long long blocks = (warps + kPullWarps - 1) / kPullWarps;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  const int err = launch_pack(sigma, dist, level, front, sigp, n, B, s);
  if (err != 0) return err;
  bfs_pull_kernel<<<static_cast<unsigned>(blocks), kPullWarps * 32, 0, s>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const unsigned*>(front), static_cast<const float*>(sigp),
      static_cast<float*>(agg), n, B, G);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
