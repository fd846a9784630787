// One level of GBDT row routing for Hopper (sm_90a): each row's next node
// id and, unless the level is the tree's last, its id in the next level's
// histogram call.
//
// Replaces no Pallas kernel. The JAX package routes a level in XLA
// (ytk_mp4j_tpu/models/gbdt.py:348, _route_samples) and builds the next
// level's ids with jnp.where; the port did the same in ATen, about nine
// launches a level for the route (two table lookups, a gather of the
// bins, the compare, the arithmetic) and six for the ids. This kernel is
// one launch a level. Contract, for every row i of the call:
//
//   node  = node_ids[i],  f = feat[node],  b = bin[node],  v = bins[i, f]
//   right = v > b                                  (numeric)
//   right = dir[node] > 0          if missing and v == 0
//   right = v == b && b != n_bins - 1   if cat[f]  (overrides the above)
//   next[i] = 2 * node + right
//   hist[i] = right ? members * n_nodes            (the sentinel)
//                   : (i / per) * n_nodes + node   (member-offset left child)
//
// exactly as ops/route_kernel.py's route_reference computes them (the
// rows of member m being [m * per, (m + 1) * per)). A frozen node (b =
// n_bins - 1, dir 0) sends every in-range row left. A row whose node id
// lies outside [0, n_nodes), or whose node's feature lies outside [0,
// n_features), reads no bin: its next id is -1 and its histogram id the
// sentinel, and the launch sets *bad (where given) to 1, which the
// wrapper turns into an error. A row sent to -1 is out of range again on
// the next level, so the last level's flag covers a chain of levels.
//
// What bounds it on this card: bytes. Each row reads its node id and one
// 4-byte bin, which costs the 32-byte sector that holds it (rows are
// n_features * 4 bytes apart), and writes one or two ids: at 11M rows,
// about 44 + 352 + 88 MB, ~0.48 GB or ~0.14 ms a level at 3.35 TB/s.
//
// Design:
//   * The level's split tables (feature, bin, missing direction) and the
//     [n_features] categorical flags are read from global memory through
//     the read-only cache, where they stay (a few KB at the depths
//     trained). A copy into shared memory a block was 1 % faster at 11M x
//     28 and no faster at 1.2M x 968 (PERF.md), not worth a second path.
//   * A grid the size of what the card holds at once (its SMs times the
//     blocks an SM takes, by the CUDA occupancy calculator); each thread
//     takes kUnroll rows a step, neighbouring threads on neighbouring rows
//     (the id loads and the stores coalesce), and starts all its rows' bin
//     loads before it uses any, so many gathers are in flight.
//   * Integer work only: the outputs are exact, the same on every launch
//     and in every grid.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;       // threads a block
constexpr int kUnroll = 4;          // rows a thread a step

struct Level {
  const int* bins;
  long long row_stride;       // elements between rows of bins
  long long n_rows;
  const int* node_ids;
  const int* feat;
  const int* bin;
  const int* dir;             // null unless missing
  const unsigned char* cat;   // [n_features] or null
  int n_nodes;
  int n_features;
  int n_bins;
  int missing;
  int* next;
  int* hist;                  // null on the tree's last level
  long long per;              // rows a member
  int members;
  int* bad;                   // set to 1 on an out-of-range row; or null
};

__global__ void __launch_bounds__(kThreads) route_kernel(const Level lv) {
  const long long sentinel = (long long)lv.members * lv.n_nodes;
  const long long rows_a_block = (long long)kThreads * kUnroll;
  const long long step = gridDim.x * rows_a_block;
  for (long long s0 = blockIdx.x * rows_a_block + threadIdx.x;
       s0 < lv.n_rows; s0 += step) {
    int node[kUnroll], f[kUnroll], v[kUnroll];
    bool ok[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = s0 + (long long)u * kThreads;
      node[u] = r < lv.n_rows ? lv.node_ids[r] : -1;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = s0 + (long long)u * kThreads;
      const bool in = (unsigned int)node[u] < (unsigned int)lv.n_nodes;
      f[u] = in ? __ldg(lv.feat + node[u]) : -1;
      ok[u] = in && (unsigned int)f[u] < (unsigned int)lv.n_features;
      v[u] = ok[u] ? __ldg(lv.bins + r * lv.row_stride + f[u]) : 0;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = s0 + (long long)u * kThreads;
      if (r >= lv.n_rows) continue;
      if (!ok[u]) {
        lv.next[r] = -1;
        if (lv.hist != nullptr) lv.hist[r] = (int)sentinel;
        if (lv.bad != nullptr) *lv.bad = 1;
        continue;
      }
      const int b = __ldg(lv.bin + node[u]);
      bool right = v[u] > b;
      if (lv.missing && v[u] == 0) right = __ldg(lv.dir + node[u]) > 0;
      if (lv.cat != nullptr && __ldg(lv.cat + f[u]) != 0) {
        right = v[u] == b && b != lv.n_bins - 1;
      }
      lv.next[r] = 2 * node[u] + (int)right;
      if (lv.hist != nullptr) {
        const long long member = lv.members > 1 ? r / lv.per : 0;
        lv.hist[r] = (int)(right ? sentinel
                                 : member * lv.n_nodes + node[u]);
      }
    }
  }
}

}  // namespace

extern "C" {

// Launches one level's routing on `stream` on the current device; returns
// cudaGetLastError(). bins: int32 rows of `row_stride` elements, n_rows of
// them; node_ids, next and hist (may be null): int32 [n_rows]; feat, bin
// and dir (may be null): int32 [n_nodes]; cat (may be null): one byte a
// feature; bad (may be null): one int32 the launch sets to 1 where a row
// is out of range. n_rows > 0, n_rows = members * per.
int mp4j_route_launch(const void* bins, long long row_stride,
                      long long n_rows, const void* node_ids,
                      const void* feat, const void* bin, const void* dir,
                      const void* cat, int n_nodes, int n_features,
                      int n_bins, int missing, void* next, void* hist,
                      long long per, int members, void* bad, void* stream) {
  // as many blocks as the card holds at once (each walks its rows in
  // steps), or fewer where the rows fill fewer
  int device = 0, sms = 0, per_sm = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                 device);
  }
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per_sm, route_kernel, kThreads, 0);
  }
  if (err != cudaSuccess) return (int)err;
  const Level lv{(const int*)bins, row_stride, n_rows, (const int*)node_ids,
                 (const int*)feat, (const int*)bin, (const int*)dir,
                 (const unsigned char*)cat, n_nodes, n_features, n_bins,
                 missing, (int*)next, (int*)hist, per, members, (int*)bad};
  const long long rows_a_block = (long long)kThreads * kUnroll;
  const long long tiles = (n_rows + rows_a_block - 1) / rows_a_block;
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  const unsigned int blocks =
      (unsigned int)(tiles < resident ? tiles : resident);
  route_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(lv);
  return (int)cudaGetLastError();
}

const char* mp4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
