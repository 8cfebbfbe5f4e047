// bfs_frontier: one BFS level with shortest-path counting, for B lanes.
//
//   agg[b, v] = sum over neighbours u of v of  sigma[b, u] * [dist[b, u] == level]
//
// Replaces repro/kernels/bfs_frontier.py::bfs_frontier (Pallas, TPU).  That
// kernel streamed edge blocks and scatter-added into a VMEM-resident
// accumulator, which is safe only because a TPU core runs its grid in order.
// Hopper runs blocks in parallel and in no order, so a scatter would need f32
// atomics whose arrival order changes sigma from run to run.  This kernel is
// a PULL over the CSR instead: one thread owns one (lane, vertex) pair and
// sums its neighbours in CSR order with an f32 accumulator.  The sum is
// deterministic and depends on nothing but its own lane's row, so a lane's
// result does not change with the other lanes that share the batch.
//
// The graph is undirected (every edge is stored as two arcs), so a vertex's
// in-neighbours are its out-neighbours and indptr/indices serve the pull.
//
// Blocks are numbered lane-major (blockIdx.x = lane * vertex_blocks +
// vertex_block): the blocks in flight at one time belong to one or two
// lanes, so that lane's dist and sigma rows (8 MB at n = 2^20) stay in L2
// and the random neighbour gathers hit it, while indptr/indices stream from
// device memory once per lane.  (Lane-fastest numbering, which shares the
// CSR slice across lanes instead, made the 256 lanes' rows compete for L2
// and ran slower on an H100.)
//
// Bound by bytes: indptr and indices once, plus per lane the dist gathers of
// every neighbour and the sigma gathers of frontier neighbours, plus B*n*4
// bytes of agg written.  The gathers are random 4-byte reads, so the kernel
// runs far below the card's bandwidth on them.  Degree skew (one thread walks
// a hub's whole list) and the full pass over all arcs on a sparse frontier
// are left to a later kernel.
//
// Plain C entry point; returns the launch's cudaError_t.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void bfs_frontier_kernel(const int* __restrict__ indptr,
                                    const int* __restrict__ indices,
                                    const float* __restrict__ sigma,
                                    const int* __restrict__ dist, int level,
                                    float* __restrict__ agg, int64_t n,
                                    int64_t vblocks) {
  const int64_t bx = blockIdx.x;
  const int b = static_cast<int>(bx / vblocks);
  const int64_t v = (bx % vblocks) * kThreads + threadIdx.x;
  if (v >= n) return;
  const int64_t row = static_cast<int64_t>(b) * n;
  const int* __restrict__ d = dist + row;
  const float* __restrict__ s = sigma + row;
  const int beg = indptr[v];
  const int end = indptr[v + 1];
  float acc = 0.0f;
  for (int k = beg; k < end; ++k) {
    const int u = indices[k];
    if (__ldg(d + u) == level) acc += __ldg(s + u);
  }
  agg[row + v] = acc;
}

}  // namespace

extern "C" int bfs_frontier_f32(const void* indptr, const void* indices,
                                const void* sigma, const void* dist, int level,
                                void* agg, long long n, int B, void* stream) {
  if (n <= 0 || B <= 0) return 0;
  const int64_t vblocks = (n + kThreads - 1) / kThreads;
  const int64_t blocks = vblocks * B;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidConfiguration);
  bfs_frontier_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(indptr), static_cast<const int*>(indices),
      static_cast<const float*>(sigma), static_cast<const int*>(dist), level,
      static_cast<float*>(agg), n, vblocks);
  return static_cast<int>(cudaGetLastError());
}
