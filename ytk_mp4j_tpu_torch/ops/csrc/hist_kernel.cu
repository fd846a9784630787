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
// launch when N == 0 and hands the kernel a bins pointer on 16 bytes.
//
// What bounds it on this card: the bytes it must read -- every row's node
// id, and the bins, g and h of the rows whose id is in range -- at most
// N * (4F + 12) bytes, about 1.36 GB at N = 11M, F = 28, or ~0.41 ms at
// 3.35 TB/s; half that at the levels where the sibling subtraction gives
// half the rows a sentinel id. The adds (two a row and feature) are
// shared-memory atomics, whose rate is the second limit, and the first
// where most values share a bin: at F = 968 with 81 % of values in bin 0
// (1,183,748 rows, 4 nodes) a root level takes 8.47 ms, 2.98 ms when the
// bin-0 values add nothing and 3.20 ms with bins spread evenly.
//
// Design, and the measurement behind each choice (H100 80GB HBM3 at
// 700 W, N = 11M, F = 28, B = 256; PERF.md, section 6):
//   * Rows, not features: a thread takes one row at a time and reads its
//     bins, 112 contiguous bytes, as 16-byte pieces (element by element
//     where F * 4 is not a multiple of 16). The previous kernel gave each
//     feature its own block and read one int32 a row 112 bytes apart: its
//     loads alone took 2.85 ms of its 3.99 ms.
//   * Each row's node id, g and h are read, and g and h quantised, once
//     (the previous kernel did it once per feature: loads + quantisation
//     3.43 ms against loads 2.85 ms). Rows whose id is out of range, or
//     whose g = h = 0, load no bins and add nothing.
//   * Sums are exact integers held in shared memory as two 32-bit words
//     a cell: a native 32-bit atomicAdd on the low word, whose returned
//     old value shows a carry (or borrow) into the high word. The 64-bit
//     atomicAdd compiles to an ATOMS.CAST.SPIN.64 compare-and-swap loop:
//     313.7 G adds/s against 2912 G/s for the 32-bit add. Low words start
//     at 2^31, so a sum that wanders both ways seldom wraps. (Issuing a
//     row piece's eight adds before any carry check measured slower.)
//   * A block holds the cells of one list of nodes: as many whole nodes'
//     F * B cells as fit the wrapper's 128 KiB (one node of 28 x 256
//     cells is 112 KiB; two, in 224 KiB, left L1 too little room and ran
//     1.5x slower), or, where one node does not fit, the node's cells in
//     several passes. A scatter pass sorts the in-range rows' records
//     (row, node, quantised g and h) into one contiguous run per list, so
//     a block reads only the rows of its list; where one list holds every
//     row (the root) the rows are read in place. A first version had
//     every list's block scan every row and skip those of other nodes:
//     1.04 ms at one node, but 3.09 / 5.17 / 8.51 ms at 4 / 8 / 16; in
//     place with the sibling subtraction's sentinel rows, half of every
//     warp idled (0.81 ms a call at level 1 against 0.63 ms sorted).
//   * The grid is what the card holds at once (occupancy query, in the
//     wrapper), each block a contiguous share of the records, so no level
//     runs a near-empty second wave (the previous kernel's grid of 1064
//     blocks took 3.99 ms at level 0; the same kernel with one wave 2.82
//     ms). Where a block's share crosses from one list to the next, it adds
//     its sums into the global accumulator and starts the next list's
//     afresh.
//   * Wide rows, whose node's F * B cells take several groups and so
//     several passes over the records: a pass loads only the 16-byte
//     pieces of a row that hold its group's features, so a record's bins
//     are loaded about once over all the passes. At F = 968, B = 256 (31
//     groups of 32 features; 1,183,748 rows, 4 to 64 nodes) a level took
//     8.36 ms at the root and 4.65-4.96 ms below it, against 67.8 and
//     35.7-37.2 ms when each pass loaded the whole 3,872-byte row; the
//     sums are the same bits. With one group (F = 28) a pass loads the
//     whole row, as before.
//
// Passes: absmax + rows per list, scan of the lists' counts, scatter of
// the records (it returns at once where one list holds every row: the
// choice is made on the card, from the counts), histogram, finalize.
//
// Determinism and accuracy. The first pass finds max|g| and max|h|; each
// value v is stored as q = round(v * 2^e), with e the largest exponent for
// which |q| <= 2^kQuantBits: |q| fits an int32 and N * |q| fits 63 bits
// for N < 2^31. Every sum is an integer sum, so the order in which the
// atomics land, the scatter places the records, or the blocks add their
// sums cannot change it: two launches on the same inputs give bitwise
// equal output. The rounding of one value is at most 2^-28 of max|v|, far
// below the f32 rounding of the result. A non-finite g or h cannot be
// held in fixed point: the whole output plane (g or h) is then NaN.

#include <cuda_runtime.h>

#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;    // threads a histogram block
constexpr int kPassThreads = 256;  // absmax, scatter, finalize blocks
constexpr int kQuads = 8;         // 16-byte row pieces a thread has in flight
constexpr int kQuantBits = 28;    // |q| <= 2^28
constexpr int kSmemLists = 2048;  // lists counted/ranked in shared memory
constexpr int kScatterRows = 8;   // rows a scatter thread takes a chunk
constexpr unsigned int kNonFinite = 0x7f800000u;  // |v| bits >= it: inf, NaN
constexpr unsigned int kBias = 0x80000000u;       // low words start here

// The fixed-point exponent e for values bounded by the float with bits
// maxbits: max * 2^e <= 2^kQuantBits.
__device__ __forceinline__ int fixed_exponent(unsigned int maxbits) {
  if (maxbits == 0 || maxbits >= kNonFinite) return 0;
  int ex;
  frexpf(__uint_as_float(maxbits), &ex);  // max < 2^ex
  return kQuantBits - ex;
}

__device__ __forceinline__ int quantise(float v, unsigned int maxbits) {
  if (maxbits >= kNonFinite) return 0;  // the plane is NaN: add nothing
  return __double2int_rn((double)v * ldexp(1.0, fixed_exponent(maxbits)));
}

// Bits of max|g| and max|h| into flags[0] and flags[1] (zeroed by the
// wrapper). The bits of a non-negative float order as the float does, and
// every NaN's bits order above +inf. Also the rows of each list (node /
// nodes_per_list for ids in [0, n_nodes)) into counts (zeroed): lists
// below kSmemLists are counted in shared memory, one add per warp and
// list.
__global__ void __launch_bounds__(kPassThreads)
    absmax_kernel(const float* __restrict__ g, const float* __restrict__ h,
                  const int* __restrict__ node_ids, long long n, int n_nodes,
                  int nodes_per_list, int lists,
                  unsigned int* __restrict__ flags,
                  unsigned long long* __restrict__ counts) {
  __shared__ unsigned int red[2][kPassThreads / 32];
  __shared__ unsigned int s_cnt[kSmemLists];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s_lists = min(lists, kSmemLists);
  for (int l = threadIdx.x; l < s_lists; l += blockDim.x) s_cnt[l] = 0;
  __syncthreads();
  unsigned int mg = 0, mh = 0;
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i0 = (long long)blockIdx.x * blockDim.x + warp * 32; i0 < n;
       i0 += stride) {  // warp-uniform: every lane runs every step
    const long long i = i0 + lane;
    int l = -1;
    if (i < n) {
      mg = max(mg, __float_as_uint(g[i]) & 0x7fffffffu);
      mh = max(mh, __float_as_uint(h[i]) & 0x7fffffffu);
      const int node = node_ids[i];
      if (node >= 0 && node < n_nodes) l = node / nodes_per_list;
    }
    const unsigned int peers = __match_any_sync(0xffffffffu, l);
    if (l >= 0 && lane == __ffs(peers) - 1) {
      if (l < kSmemLists) {
        atomicAdd(&s_cnt[l], (unsigned int)__popc(peers));
      } else {
        atomicAdd(&counts[l], (unsigned long long)__popc(peers));
      }
    }
  }
  for (int off = 16; off > 0; off >>= 1) {
    mg = max(mg, __shfl_xor_sync(0xffffffffu, mg, off));
    mh = max(mh, __shfl_xor_sync(0xffffffffu, mh, off));
  }
  if (lane == 0) {
    red[0][warp] = mg;
    red[1][warp] = mh;
  }
  __syncthreads();
  if (warp == 0) {
    mg = lane < blockDim.x / 32 ? red[0][lane] : 0u;
    mh = lane < blockDim.x / 32 ? red[1][lane] : 0u;
    for (int off = 16; off > 0; off >>= 1) {
      mg = max(mg, __shfl_xor_sync(0xffffffffu, mg, off));
      mh = max(mh, __shfl_xor_sync(0xffffffffu, mh, off));
    }
    if (lane == 0) {
      atomicMax(&flags[0], mg);
      atomicMax(&flags[1], mh);
    }
  }
  for (int l = threadIdx.x; l < s_lists; l += blockDim.x) {
    if (s_cnt[l]) atomicAdd(&counts[l], (unsigned long long)s_cnt[l]);
  }
}

// offsets[l] = counts[0] + ... + counts[l - 1], for l in [0, lists]. One
// block: each thread adds a contiguous share, a shuffle scan within each
// warp and then across the warps' totals gives each share its start.
__global__ void __launch_bounds__(kThreads)
    scan_kernel(const unsigned long long* __restrict__ counts, int lists,
                long long* __restrict__ offsets) {
  __shared__ long long warp_sum[kThreads / 32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int per = (lists + kThreads - 1) / kThreads;
  const int l0 = min(lists, threadIdx.x * per);
  const int l1 = min(lists, l0 + per);
  long long s = 0;
  for (int l = l0; l < l1; ++l) s += (long long)counts[l];
  long long x = s;  // inclusive scan of the shares within the warp
  for (int off = 1; off < 32; off <<= 1) {
    const long long y = __shfl_up_sync(0xffffffffu, x, off);
    if (lane >= off) x += y;
  }
  if (lane == 31) warp_sum[warp] = x;
  __syncthreads();
  if (warp == 0) {
    long long w = warp_sum[lane];
    for (int off = 1; off < 32; off <<= 1) {
      const long long y = __shfl_up_sync(0xffffffffu, w, off);
      if (lane >= off) w += y;
    }
    warp_sum[lane] = w;  // inclusive totals of warps 0 .. lane
  }
  __syncthreads();
  long long start = x - s + (warp ? warp_sum[warp - 1] : 0);
  for (int l = l0; l < l1; ++l) {
    offsets[l] = start;
    start += (long long)counts[l];
  }
  if (threadIdx.x == kThreads - 1) offsets[lists] = start;
}

// Each in-range row's record {row, node, q(g), q(h)} into its list's run
// recs[offsets[l] ..). A block takes chunks of kScatterRows rows a thread:
// it ranks each row within its list in shared memory (one add per warp
// and list), then reserves the chunk's slots of each list with one global
// add (cursor, zeroed by the wrapper). Lists from kSmemLists on reserve
// per warp. The order within a run varies from launch to launch; the
// integer sums do not.
__global__ void __launch_bounds__(kPassThreads)
    scatter_kernel(const float* __restrict__ g, const float* __restrict__ h,
                   const int* __restrict__ node_ids, long long n, int n_nodes,
                   int nodes_per_list, int lists,
                   const unsigned int* __restrict__ flags,
                   const long long* __restrict__ offsets,
                   unsigned long long* __restrict__ cursor,
                   int4* __restrict__ recs) {
  __shared__ unsigned int s_cnt[kSmemLists];
  __shared__ unsigned long long s_base[kSmemLists];
  if (lists == 1 && offsets[1] == n) return;  // every row: read in place
  const unsigned int mg = flags[0], mh = flags[1];
  const int lane = threadIdx.x & 31;
  const int s_lists = min(lists, kSmemLists);
  const long long rows = (long long)kPassThreads * kScatterRows;
  for (long long c0 = (long long)blockIdx.x * rows; c0 < n;
       c0 += (long long)gridDim.x * rows) {
    for (int l = threadIdx.x; l < s_lists; l += kPassThreads) s_cnt[l] = 0;
    __syncthreads();
    int node[kScatterRows];
    unsigned long long slot[kScatterRows];
#pragma unroll
    for (int k = 0; k < kScatterRows; ++k) {
      const long long i = c0 + k * kPassThreads + threadIdx.x;
      int l = -1;
      node[k] = -1;
      if (i < n) {
        node[k] = node_ids[i];
        if (node[k] >= 0 && node[k] < n_nodes) l = node[k] / nodes_per_list;
      }
      if (l < 0) node[k] = -1;
      const unsigned int peers = __match_any_sync(0xffffffffu, l);
      const int leader = __ffs(peers) - 1;
      unsigned long long b = 0;
      if (l >= 0 && lane == leader) {
        b = l < kSmemLists
                ? atomicAdd(&s_cnt[l], (unsigned int)__popc(peers))
                : atomicAdd(&cursor[l], (unsigned long long)__popc(peers)) +
                      offsets[l];
      }
      slot[k] = __shfl_sync(0xffffffffu, b, leader) +
                __popc(peers & ((1u << lane) - 1u));
    }
    __syncthreads();
    for (int l = threadIdx.x; l < s_lists; l += kPassThreads) {
      if (s_cnt[l]) s_base[l] = offsets[l] + atomicAdd(&cursor[l], s_cnt[l]);
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kScatterRows; ++k) {
      if (node[k] < 0) continue;
      const long long i = c0 + k * kPassThreads + threadIdx.x;
      const int l = node[k] / nodes_per_list;
      recs[(l < kSmemLists ? s_base[l] : 0ull) + slot[k]] =
          make_int4((int)i, node[k], quantise(g[i], mg), quantise(h[i], mh));
    }
    __syncthreads();  // s_base is read before the next chunk resets s_cnt
  }
}

// Adds q to the cell held as (hi, lo): lo + q in 32 bits, and the carry
// or borrow that the returned old value shows into hi. Exact for any
// order of adds whose true sum fits 64 bits.
__device__ __forceinline__ void add_cell(unsigned int* lo, unsigned int* hi,
                                         int cell, int q) {
  if (q == 0) return;
  const unsigned int uq = (unsigned int)q;
  const unsigned int old = atomicAdd(lo + cell, uq);
  const unsigned int now = old + uq;
  if (q > 0 ? now < old : now > old) {
    atomicAdd(hi + cell, q > 0 ? 1u : 0xffffffffu);
  }
}

// The 16-byte pieces [.x, .y) of a row that group s of a list loads: those
// that hold its cells' features. With one node a list, group s is the
// node's cells [s * cpb, s * cpb + cpb), i.e. features [s * cpb / B,
// ceil((s * cpb + cpb) / B)); a list of several nodes is one group of
// whole rows. The kernel's rule, which mp4j_hist_group_quads hands the
// wrapper for its counter.
__host__ __device__ __forceinline__ int2 group_quad_range(int s, int F, int B,
                                                          int nodes_per_list,
                                                          int cpb) {
  if (nodes_per_list > 1) return make_int2(0, (F + 3) >> 2);
  const long long g0 = (long long)s * cpb, w = 4LL * B;
  const long long fb = (long long)F * B;
  const long long g1 = g0 + cpb < fb ? g0 + cpb : fb;
  return make_int2((int)(g0 / w), (int)((g1 + w - 1) / w));
}

// Elements 4q .. 4q+3 of a row (past F: bin -1, dropped).
__device__ __forceinline__ int4 load_quad(const int* __restrict__ row, int q,
                                          int F) {
  const int f = 4 * q;
  if ((F & 3) == 0) return __ldg(reinterpret_cast<const int4*>(row) + q);
  return make_int4(row[f], f + 1 < F ? row[f + 1] : -1,
                   f + 2 < F ? row[f + 2] : -1, f + 3 < F ? row[f + 3] : -1);
}

// Adds the block's sums of cells [0, ncell) into acc at cell0 and zeroes
// them for the next list.
__device__ void flush(unsigned int* lo_g, unsigned int* lo_h,
                      unsigned int* hi_g, unsigned int* hi_h, int ncell,
                      long long cell0, long long total,
                      unsigned long long* __restrict__ acc) {
  __syncthreads();
  for (int c = threadIdx.x; c < ncell; c += blockDim.x) {
    const long long sg = (long long)(int)hi_g[c] * 4294967296LL +
                         (long long)lo_g[c] - (long long)kBias;
    const long long sh = (long long)(int)hi_h[c] * 4294967296LL +
                         (long long)lo_h[c] - (long long)kBias;
    if (sg) atomicAdd(&acc[cell0 + c], (unsigned long long)sg);
    if (sh) atomicAdd(&acc[total + cell0 + c], (unsigned long long)sh);
    lo_g[c] = lo_h[c] = kBias;
    hi_g[c] = hi_h[c] = 0u;
  }
  __syncthreads();
}

// Record i: recs[i], or, with one list (recs null), built from row i.
__device__ __forceinline__ int4 fetch_record(
    long long i, const int4* __restrict__ recs, const float* __restrict__ g,
    const float* __restrict__ h, const int* __restrict__ node_ids,
    int n_nodes, unsigned int mg, unsigned int mh) {
  if (recs) return recs[i];
  int4 r = make_int4((int)i, node_ids[i], 0, 0);
  if (r.y >= 0 && r.y < n_nodes) {
    r.z = quantise(g[i], mg);
    r.w = quantise(h[i], mh);
  }
  return r;
}

// Block b takes records [R * b / grid, R * (b + 1) / grid) -- R =
// offsets[lists], or R = N and record i = row i where one list holds every
// row (the scatter pass then wrote none) -- once for each of the list's
// cell_groups groups of cells_per_block cells, and adds them into acc
// [2, n_nodes * F * B]. In group s a record loads only the 16-byte pieces
// of its row that group_quad_range gives, those that hold the group's
// features; elements of a boundary piece that lie outside the group fail
// the cell < ncell check. A thread takes one record at a time, the next
// one's already in flight, and loads up to kQuads pieces of its row before
// it adds any; no barrier stands between records, only between lists.
__global__ void __launch_bounds__(kThreads, 1)
    hist_kernel(const int* __restrict__ bins, const float* __restrict__ g,
                const float* __restrict__ h, const int* __restrict__ node_ids,
                long long n, int F, int B, int n_nodes, int nodes_per_list,
                int lists, int cells_per_block, int cell_groups,
                const int4* __restrict__ recs,
                const long long* __restrict__ offsets,
                const unsigned int* __restrict__ flags,
                unsigned long long* __restrict__ acc) {
  extern __shared__ unsigned int smem[];
  const int cpb = cells_per_block;
  unsigned int* lo_g = smem;
  unsigned int* lo_h = smem + cpb;
  unsigned int* hi_g = smem + 2 * cpb;
  unsigned int* hi_h = smem + 3 * cpb;

  const int tid = threadIdx.x;
  const unsigned int mg = flags[0], mh = flags[1];
  const long long FB = (long long)F * B;
  const long long total = n_nodes * FB;
  const long long list_cells = nodes_per_list * FB;
  if (lists == 1 && offsets[1] == n) recs = nullptr;  // rows in place
  const long long R = recs ? offsets[lists] : n;
  const long long begin = R * blockIdx.x / gridDim.x;
  const long long end = R * (blockIdx.x + 1) / gridDim.x;

  for (int c = tid; c < 2 * cpb; c += kThreads) {
    smem[c] = kBias;
    smem[2 * cpb + c] = 0u;
  }
  __syncthreads();
  if (begin >= end) return;

  int first = 0;  // the list of record `begin`: last l with offsets[l] <= it
  if (recs) {
    int lo = 0, hi = lists - 1;
    while (lo < hi) {
      const int mid = (lo + hi + 1) >> 1;
      if (offsets[mid] <= begin) lo = mid; else hi = mid - 1;
    }
    first = lo;
  }
  for (int s = 0; s < cell_groups; ++s) {
    const int2 qr = group_quad_range(s, F, B, nodes_per_list, cpb);
    const int q_lo = qr.x, q_hi = qr.y;
    long long pos = begin;
    int l = first;
    while (pos < end) {
      const long long lend = recs ? min(end, offsets[l + 1]) : end;
      const long long c0 = (long long)l * list_cells + (long long)s * cpb;
      const int ncell = (int)min((long long)cpb, min(total, (l + 1) *
                                                        list_cells) - c0);
      const long long node0 = (long long)l * nodes_per_list;
      long long i = pos + tid;
      int4 nxt = i < lend ? fetch_record(i, recs, g, h, node_ids, n_nodes,
                                         mg, mh)
                          : make_int4(0, -1, 0, 0);
      for (; i < lend; i += kThreads) {
        const int4 r = nxt;
        if (i + kThreads < lend) {
          nxt = fetch_record(i + kThreads, recs, g, h, node_ids, n_nodes, mg,
                             mh);
        }
        // the row's first cell in this group; the row adds nothing unless
        // its node is in range, it has a non-zero q and its cells meet
        // the group's
        const long long fc64 = (r.y - node0) * FB - (long long)s * cpb;
        if (r.y < 0 || r.y >= n_nodes || (r.z | r.w) == 0 || fc64 >= ncell ||
            fc64 + FB <= 0) {
          continue;
        }
        const int fc = (int)fc64;  // > -F * B: every cell below fits an int
        const int* row = bins + (long long)r.x * F;
        for (int q0 = q_lo; q0 < q_hi; q0 += kQuads) {
          int4 v[kQuads];
#pragma unroll
          for (int j = 0; j < kQuads; ++j) {
            if (q0 + j < q_hi) v[j] = load_quad(row, q0 + j, F);
          }
#pragma unroll
          for (int j = 0; j < kQuads; ++j) {
            if (q0 + j >= q_hi) break;
            const int vals[4] = {v[j].x, v[j].y, v[j].z, v[j].w};
#pragma unroll
            for (int k = 0; k < 4; ++k) {
              const int bin = vals[k];
              if ((unsigned int)bin >= (unsigned int)B) continue;
              const int cell = fc + (4 * (q0 + j) + k) * B + bin;
              if ((unsigned int)cell < (unsigned int)ncell) {
                add_cell(lo_g, hi_g, cell, r.z);
                add_cell(lo_h, hi_h, cell, r.w);
              }
            }
          }
        }
      }
      pos = lend;
      flush(lo_g, lo_h, hi_g, hi_h, ncell, c0, total, acc);
      ++l;
    }
  }
}

// acc [2, total] fixed point -> out [2, total] f32.
__global__ void finalize_kernel(const unsigned long long* __restrict__ acc,
                                long long total,
                                const unsigned int* __restrict__ flags,
                                float* __restrict__ out) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < 2 * total; i += stride) {
    const unsigned int m = flags[i < total ? 0 : 1];
    out[i] = m >= kNonFinite
                 ? __int_as_float(0x7fc00000)  // quiet NaN
                 : (float)((double)(long long)acc[i] *
                           ldexp(1.0, -fixed_exponent(m)));
  }
}

size_t smem_bytes(int cells_per_block) {
  return 4 * sizeof(unsigned int) * (size_t)cells_per_block;
}

int grid_for(long long work, int cap) {
  long long blocks = (work + kPassThreads - 1) / kPassThreads;
  if (blocks < 1) blocks = 1;
  return (int)(blocks < cap ? blocks : cap);
}

}  // namespace

extern "C" {

// Threads of a histogram block (also records a chunk) and the
// quantisation width, for the wrapper's geometry.
int mp4j_hist_threads() { return kThreads; }
int mp4j_hist_quant_bits() { return kQuantBits; }

// Largest dynamic shared memory a block of the current device may opt in
// to, into *bytes.
int mp4j_hist_smem_limit(int* bytes) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(
        bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  return (int)err;
}

// Histogram blocks an SM of the current device holds at once with
// cells_per_block cells, into *blocks.
int mp4j_hist_blocks_per_sm(int cells_per_block, int* blocks) {
  const size_t smem = smem_bytes(cells_per_block);
  cudaError_t err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) {
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, hist_kernel,
                                                        kThreads, smem);
  }
  return (int)err;
}

// Launches the passes on `stream`; returns cudaGetLastError(). flags:
// uint32 [2] zeroed; counts, cursor: int64 [lists] zeroed; offsets: int64
// [lists + 1]; recs: int4 [n]; acc: int64 [2 * n_nodes * F * B] zeroed;
// out: f32 [2 * n_nodes * F * B]. bins must start on 16 bytes; n < 2^31.
int mp4j_hist_launch(const void* bins, const void* g, const void* h,
                     const void* node_ids, long long n, int F, int B,
                     int n_nodes, int nodes_per_list, int lists,
                     int cells_per_block, int cell_groups, int blocks,
                     void* flags, void* counts, void* offsets, void* cursor,
                     void* recs, void* acc, void* out, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  unsigned int* fl = (unsigned int*)flags;
  absmax_kernel<<<grid_for(n, 1024), kPassThreads, 0, s>>>(
      (const float*)g, (const float*)h, (const int*)node_ids, n, n_nodes,
      nodes_per_list, lists, fl, (unsigned long long*)counts);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  scan_kernel<<<1, kThreads, 0, s>>>((const unsigned long long*)counts,
                                     lists, (long long*)offsets);
  scatter_kernel<<<grid_for(n / kScatterRows + 1, 2048), kPassThreads, 0,
                   s>>>(
      (const float*)g, (const float*)h, (const int*)node_ids, n, n_nodes,
      nodes_per_list, lists, fl, (const long long*)offsets,
      (unsigned long long*)cursor, (int4*)recs);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const size_t smem = smem_bytes(cells_per_block);
  err = cudaFuncSetAttribute(
      hist_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  hist_kernel<<<blocks, kThreads, smem, s>>>(
      (const int*)bins, (const float*)g, (const float*)h,
      (const int*)node_ids, n, F, B, n_nodes, nodes_per_list, lists,
      cells_per_block, cell_groups, (const int4*)recs,
      (const long long*)offsets, fl, (unsigned long long*)acc);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const long long total = (long long)n_nodes * F * B;
  finalize_kernel<<<grid_for(2 * total, 4096), kPassThreads, 0, s>>>(
      (const unsigned long long*)acc, total, fl, (float*)out);
  return (int)cudaGetLastError();
}

// Into out[2 s], out[2 s + 1], for each of the cell_groups groups: the
// pieces of a row the kernel loads in group s (group_quad_range).
int mp4j_hist_group_quads(int F, int B, int nodes_per_list,
                          int cells_per_block, int cell_groups, int* out) {
  for (int s = 0; s < cell_groups; ++s) {
    const int2 r = group_quad_range(s, F, B, nodes_per_list,
                                    cells_per_block);
    out[2 * s] = r.x;
    out[2 * s + 1] = r.y;
  }
  return 0;
}

const char* mp4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
