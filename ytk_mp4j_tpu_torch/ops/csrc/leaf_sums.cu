// Per-leaf float64 sums of g and h (the GBDT leaf sums) for Hopper (sm_90a).
//
// Replaces no Pallas kernel. The JAX package computes the leaf sums as one
// MXU product of a one-hot [N, n_segments] operand
// (ytk_mp4j_tpu/models/gbdt.py:332, _onehot_segment_sum2); the port first
// computed them with two ATen float64 index_add calls, whose adds were
// global atomics on n_members * n_leaves addresses, contended and in
// another order each run. This kernel takes their place. Contract:
//
//   out[p][m * n_leaves + l] = sum over rows i of member m with
//                              node_ids[i] == l of v_p[i]
//
// in float64, v_0 = g, v_1 = h (float32), member m's rows being
// [m * per, (m + 1) * per). Ids outside [0, n_leaves) add nothing. The
// wrapper (ops/leaf_sums.py) returns zeros without a launch when N == 0.
//
// What bounds it on this card: the bytes it must read, each row's node id,
// g and h once -- N * 12 bytes, 132 MB or ~0.039 ms at N = 11M and 3.35
// TB/s. Its other traffic, the tiles' partial sums (16 bytes a leaf a
// tile), is a few MB up to some thousands of leaves; past that the
// wrapper trades it against the tiles the card runs at once.
//
// Design:
//   * No global atomics. Each block of the sum pass owns one contiguous
//     tile of one member's rows and holds private float64 copies of every
//     leaf's g and h sums in shared memory, laid out [leaf][copy]. The
//     copies are folded at the tile's end and the tile's partials written
//     out; the fold pass sums each (plane, cell) over the tiles.
//   * Row r of a tile (its position from the tile's start) goes to thread
//     r mod T of the block's T threads (neighbouring threads on
//     neighbouring rows), loaded kUnroll rows ahead of the adds.
//   * Where one copy a thread fits the shared-memory budget (the wrapper's
//     launch_geometry: at most 64 leaves), each thread owns its copy: its
//     adds need no atomic and meet no bank conflict whatever leaves the
//     rows fall in, and every row in one leaf (the atomics' worst case)
//     costs what any spread costs.
//   * Past that, fewer private copies: one a warp. The lanes' rows of a
//     step are consecutive rows; lanes holding the same leaf
//     (__match_any_sync) add in lane order, one round a rank, so a copy
//     still takes its rows in row order. Where even one copy a block does
//     not fit, the leaves go in groups of as many as fit, a block a
//     (tile, group), each reading the whole tile.
//   * Folds: a block's copies by halving (copy c += copy c + s, s =
//     copies/2, ..., 1); a cell's tiles by kFoldThreads threads, thread t
//     taking the tiles t, t + kFoldThreads, ... in turn, then the threads
//     by halving.
//
// Fixed order. Every add's place in its sum depends only on the row's
// position within its member's rows and on (per, n_leaves), which fix the
// geometry: not on the grid, on the card, on other members, on the order
// in which blocks run, or on which leaves a group holds. So two launches on
// the same rows give bitwise equal sums, and a member's sums are bitwise
// the same whether it is one member of a packed call, a call of its own
// (the list form) or a process's member; ops/leaf_sums.py's
// fixed_order_sums repeats the adds in PyTorch. The sums are float64
// throughout, the inputs float32 (exact in float64); a non-finite g or h
// reaches only its own leaf's sum.

#include <cuda_runtime.h>

namespace {

constexpr int kMaxThreads = 64;    // threads a sum block at most
constexpr int kWarp = 32;
constexpr int kUnroll = 16;        // rows a thread loads ahead of its adds
constexpr int kFoldThreads = 128;  // threads a fold block

// One block a (tile, member, group of leaves): the tile's partial sums of
// the group's leaves, into partial[p][cell][tile]. Dynamic shared memory:
// [2][leaves_per_group][copies] doubles, copies = 2^copy_bits, a thread
// each (kWarpCopies false) or a warp each (true).
template <bool kWarpCopies>
__global__ void __launch_bounds__(kMaxThreads)
    leaf_tile_kernel(const float* __restrict__ g, const float* __restrict__ h,
                     const int* __restrict__ node_ids, long long per,
                     int n_leaves, int leaves_per_group, int copy_bits,
                     long long tile_rows, long long tiles,
                     double* __restrict__ partial) {
  extern __shared__ double slots[];
  const int threads = blockDim.x, t = threadIdx.x, lane = t & (kWarp - 1);
  const int copies = 1 << copy_bits;
  const int copy = kWarpCopies ? t / kWarp : t;
  const long long tile = blockIdx.x;
  const int m = blockIdx.y;
  const long long base = (long long)m * per;
  const long long lo = tile * tile_rows;
  const long long hi = min(per, lo + tile_rows);
  const long long cells = (long long)gridDim.y * n_leaves;
  const int first = blockIdx.z * leaves_per_group;
  const int span = min(leaves_per_group, n_leaves - first);
  double* sg = slots;
  double* sh = slots + (size_t)leaves_per_group * copies;
  for (int i = t; i < span * copies; i += threads) {
    sg[i] = 0.0;
    sh[i] = 0.0;
  }
  __syncthreads();
  // the bound is the same for every thread: whole warps meet the
  // warp-wide calls
  const long long step = (long long)kUnroll * threads;
  for (long long s0 = lo; s0 < hi; s0 += step) {
    int id[kUnroll];
    float vg[kUnroll], vh[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long r = s0 + (long long)u * threads + t;
      id[u] = -1;
      vg[u] = vh[u] = 0.0f;
      if (r < hi) {
        id[u] = node_ids[base + r];
        vg[u] = g[base + r];
        vh[u] = h[base + r];
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      // ids below `first` or outside [0, n_leaves) wrap to >= span
      const unsigned int k = (unsigned int)id[u] - (unsigned int)first;
      const bool in = k < (unsigned int)span;
      const size_t at = in ? (size_t)k * copies + copy : 0;
      if (!kWarpCopies) {
        if (in) {
          sg[at] += (double)vg[u];
          sh[at] += (double)vh[u];
        }
      } else {
        const unsigned int peers =
            __match_any_sync(0xffffffffu, in ? k : 0xffffffffu);
        const int rank = __popc(peers & ((1u << lane) - 1u));
        const int rounds = (int)__reduce_max_sync(
            0xffffffffu, in ? (unsigned int)rank + 1u : 0u);
        for (int q = 0; q < rounds; ++q) {
          if (in && rank == q) {
            sg[at] += (double)vg[u];
            sh[at] += (double)vh[u];
          }
          __syncwarp();
        }
      }
    }
  }
  __syncthreads();
  for (int b = copy_bits - 1; b >= 0; --b) {
    const int s = 1 << b;
    for (int i = t; i < (span << b); i += threads) {
      const int at = (i >> b) * copies + (i & (s - 1));
      sg[at] += sg[at + s];
      sh[at] += sh[at + s];
    }
    __syncthreads();
  }
  for (int k = t; k < span; k += threads) {
    const long long cell = (long long)m * n_leaves + first + k;
    partial[cell * tiles + tile] = sg[(size_t)k * copies];
    partial[(cells + cell) * tiles + tile] = sh[(size_t)k * copies];
  }
}

// One block a (plane, cell): the sum of its tiles' partials.
__global__ void __launch_bounds__(kFoldThreads)
    leaf_fold_kernel(const double* __restrict__ partial, long long tiles,
                     double* __restrict__ out) {
  __shared__ double red[kFoldThreads];
  const long long cell = blockIdx.x;
  const int t = threadIdx.x;
  double acc = 0.0;
  for (long long k = t; k < tiles; k += kFoldThreads) {
    acc += partial[cell * tiles + k];
  }
  red[t] = acc;
  __syncthreads();
  for (int s = kFoldThreads / 2; s > 0; s >>= 1) {
    if (t < s) red[t] += red[t + s];
    __syncthreads();
  }
  if (t == 0) out[cell] = red[0];
}

}  // namespace

extern "C" {

// Threads a sum block at most and threads a fold block, for the
// wrapper's geometry and its model of the adds.
int mp4j_leaf_max_threads() { return kMaxThreads; }
int mp4j_leaf_fold_threads() { return kFoldThreads; }

// Launches the sum and the fold pass on `stream`; returns
// cudaGetLastError(). g, h: f32 [n_members * per]; node_ids: int32, the
// same; partial: f64 [2 * n_members * n_leaves * tiles] (every entry is
// written); out: f64 [2 * n_members * n_leaves]. A sum block has `threads`
// threads (a power of two, at most kMaxThreads) and 2^copy_bits copies, a
// thread each or (warp_copies) a warp each; leaves_per_group * groups >=
// n_leaves, tiles * tile_rows >= per > 0, n_members and groups <= 65535.
int mp4j_leaf_sums_launch(const void* g, const void* h, const void* node_ids,
                          long long per, int n_members, int n_leaves,
                          int threads, int warp_copies, int copy_bits,
                          int leaves_per_group, int groups,
                          long long tile_rows, long long tiles, void* partial,
                          void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = 2 * sizeof(double) * (size_t)leaves_per_group *
                      ((size_t)1 << copy_bits);
  const void* kernel = warp_copies ? (const void*)leaf_tile_kernel<true>
                                   : (const void*)leaf_tile_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((unsigned int)tiles, n_members, groups);
  if (warp_copies) {
    leaf_tile_kernel<true><<<grid, threads, smem, s>>>(
        (const float*)g, (const float*)h, (const int*)node_ids, per,
        n_leaves, leaves_per_group, copy_bits, tile_rows, tiles,
        (double*)partial);
  } else {
    leaf_tile_kernel<false><<<grid, threads, smem, s>>>(
        (const float*)g, (const float*)h, (const int*)node_ids, per,
        n_leaves, leaves_per_group, copy_bits, tile_rows, tiles,
        (double*)partial);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long cells = 2LL * n_members * n_leaves;
  leaf_fold_kernel<<<(unsigned int)cells, kFoldThreads, 0, s>>>(
      (const double*)partial, tiles, (double*)out);
  return (int)cudaGetLastError();
}

const char* mp4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
