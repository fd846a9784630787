// (node x feature x bin) gradient/hessian histograms for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel ytk_mp4j_tpu/ops/hist_kernel.py:70
// (_hist_kernel) behind pallas_histograms (:106). Same contract:
//
//   hist_g[n, f, b] = sum_i g[i] * [node_ids[i] == n] * [bins[i, f] == b]
//
// and the same for h. Rows whose node id lies outside [0, n_nodes) or
// whose bin lies outside [0, B) add nothing; rows with g = h = 0 leave
// exact zeros. The wrapper (ops/hist_kernel.py) returns zeros without a
// launch when N == 0.
//
// What bounds it on this card: each level reads every row once,
// N * (4F + 12) bytes (int32 bins, f32 g and h, int32 node id) -- about
// 1.36 GB at N = 11M, F = 28, or ~0.41 ms at 3.35 TB/s. The arithmetic
// (two adds per row and feature) is far below the card's rate.
//
// Design. The TPU kernel builds a one-hot of N*F*B lanes because its
// scatter unit is serial; Hopper has shared-memory atomics, so this is a
// scatter-reduction instead:
//   * grid (feature, row range, cell group). blockIdx.x is the feature,
//     so the F blocks of one row range run together and the row range's
//     bytes come from DRAM about once (the strided reads of one feature
//     column hit L2 for the others);
//   * each block keeps a private [cells, 2] histogram in shared memory,
//     where a cell is one (node, bin) pair; the nodes are tiled into cell
//     groups of at most kMaxCells cells, so every n_nodes and B fits
//     (no shape gate: a large level only adds groups);
//   * the block walks its rows, adds each row's g and h at its cell,
//     then folds its partial into a global accumulator.
//
// Determinism. Sums are taken in 64-bit fixed point: integer adds
// commute, so two launches on the same inputs give bitwise equal output
// whatever order the atomics land in. A first pass finds max|g| and
// max|h|; each value v is stored as round(v * 2^e) with e chosen so that
// N * max|v| * 2^e < 2^61, so no partial sum can overflow. The
// quantisation step is 2^-(61 - ceil(log2 N)) of max|v| (about 7e-12 at
// N = 11M), far below f32 rounding. A non-finite g or h cannot be held
// in fixed point: the whole output plane (g or h) is then NaN.

#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned int kNonFinite = 0x7f800000u;  // |v| bits >= it: inf, NaN

// Bits of max|g| and max|h| into flags[0] and flags[1] (zeroed by the
// wrapper). The bits of a non-negative float order as the float does,
// and every NaN's bits order above +inf.
__global__ void absmax_kernel(const float* __restrict__ g,
                              const float* __restrict__ h, long long n,
                              unsigned int* __restrict__ flags) {
  unsigned int mg = 0, mh = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    mg = max(mg, __float_as_uint(g[i]) & 0x7fffffffu);
    mh = max(mh, __float_as_uint(h[i]) & 0x7fffffffu);
  }
  for (int off = 16; off > 0; off >>= 1) {
    mg = max(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    mh = max(mh, __shfl_xor_sync(0xffffffffu, mh, off));
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(&flags[0], mg);
    atomicMax(&flags[1], mh);
  }
}

// The fixed-point exponent e for values bounded by the float with bits
// maxbits, over n rows (log2n = ceil(log2 n)): max * n * 2^e < 2^61.
__device__ __forceinline__ int fixed_exponent(unsigned int maxbits,
                                              int log2n) {
  if (maxbits == 0) return 0;  // all zero: any scale is exact
  int ex;
  frexpf(__uint_as_float(maxbits), &ex);  // max < 2^ex
  return 61 - log2n - ex;
}

__global__ void hist_kernel(const int* __restrict__ bins,
                            const float* __restrict__ g,
                            const float* __restrict__ h,
                            const int* __restrict__ node_ids, long long n,
                            int F, int B, int n_nodes,
                            long long rows_per_block,
                            int cells_per_block,
                            const unsigned int* __restrict__ flags, int log2n,
                            unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned long long smem[];
  unsigned long long* sg = smem;
  unsigned long long* sh = smem + cells_per_block;

  const unsigned int mg = flags[0], mh = flags[1];
  if (mg >= kNonFinite || mh >= kNonFinite) return;  // finalize writes NaN

  const int f = blockIdx.x;
  const long long row0 = (long long)blockIdx.y * rows_per_block;
  const long long row1 = min(n, row0 + rows_per_block);
  const long long cell0 = (long long)blockIdx.z * cells_per_block;
  const long long total_cells = (long long)n_nodes * B;
  const long long ncell = min((long long)cells_per_block, total_cells - cell0);

  for (int c = threadIdx.x; c < 2 * cells_per_block; c += blockDim.x) {
    smem[c] = 0ull;
  }
  __syncthreads();

  const double scale_g = ldexp(1.0, fixed_exponent(mg, log2n));
  const double scale_h = ldexp(1.0, fixed_exponent(mh, log2n));
  for (long long i = row0 + threadIdx.x; i < row1; i += blockDim.x) {
    const int node = node_ids[i];
    const int b = bins[i * F + f];
    if ((unsigned int)node >= (unsigned int)n_nodes ||
        (unsigned int)b >= (unsigned int)B) {
      continue;
    }
    const long long cell = (long long)node * B + b - cell0;
    if (cell < 0 || cell >= ncell) continue;
    const long long qg = __double2ll_rn((double)g[i] * scale_g);
    const long long qh = __double2ll_rn((double)h[i] * scale_h);
    // two's-complement adds: a negative value wraps and unwraps exactly
    if (qg) atomicAdd(&sg[cell], (unsigned long long)qg);
    if (qh) atomicAdd(&sh[cell], (unsigned long long)qh);
  }
  __syncthreads();

  // fold into acc [2, n_nodes, F, B]
  const long long plane = total_cells * F;
  for (long long c = threadIdx.x; c < ncell; c += blockDim.x) {
    const long long cell = cell0 + c;
    const long long node = cell / B;
    const long long b = cell - node * B;
    const long long off = (node * F + f) * B + b;
    if (sg[c]) atomicAdd(&acc[off], sg[c]);
    if (sh[c]) atomicAdd(&acc[plane + off], sh[c]);
  }
}

// acc [2, total] fixed point -> out [2, total] f32.
__global__ void finalize_kernel(const unsigned long long* __restrict__ acc,
                                long long total,
                                const unsigned int* __restrict__ flags,
                                int log2n, float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < 2 * total; i += stride) {
    const unsigned int m = flags[i < total ? 0 : 1];
    if (m >= kNonFinite) {
      out[i] = __int_as_float(0x7fc00000);  // quiet NaN
    } else {
      const double inv = ldexp(1.0, -fixed_exponent(m, log2n));
      out[i] = (float)((double)(long long)acc[i] * inv);
    }
  }
}

int grid_for(long long work) {
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < 4096 ? blocks : 4096);
}

}  // namespace

extern "C" {

// Launches the three passes on `stream`; returns cudaGetLastError().
// flags: uint32 [2] zeroed; acc: uint64 [2 * n_nodes * F * B] zeroed;
// out: f32 [2 * n_nodes * F * B]. Geometry comes from the wrapper:
// grid (F, row_blocks, cell_groups), rows_per_block rows and
// cells_per_block cells (2 * 8 * cells_per_block bytes of shared
// memory) per block.
int mp4j_hist_launch(const void* bins, const void* g, const void* h,
                     const void* node_ids, long long n, int F, int B,
                     int n_nodes, long long rows_per_block, int row_blocks,
                     int cells_per_block, int cell_groups, int log2n,
                     void* flags, void* acc, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int* fl = (unsigned int*)flags;
  absmax_kernel<<<grid_for(n), kThreads, 0, s>>>((const float*)g,
                                                 (const float*)h, n, fl);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = 2 * sizeof(unsigned long long) * (size_t)cells_per_block;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(hist_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  dim3 grid((unsigned int)F, (unsigned int)row_blocks,
            (unsigned int)cell_groups);
  hist_kernel<<<grid, kThreads, smem, s>>>(
      (const int*)bins, (const float*)g, (const float*)h,
      (const int*)node_ids, n, F, B, n_nodes, rows_per_block, cells_per_block,
      fl, log2n, (unsigned long long*)acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long total = (long long)n_nodes * F * B;
  finalize_kernel<<<grid_for(2 * total), kThreads, 0, s>>>(
      (const unsigned long long*)acc, total, fl, log2n, (float*)out);
  return (int)cudaGetLastError();
}

const char* mp4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
