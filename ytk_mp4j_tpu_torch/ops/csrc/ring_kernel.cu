// Ring allreduce / reduce-scatter / allgather of n members packed as the
// rows of one tensor on one card, in one launch, for Hopper (sm_90a): the
// packed form's global path (n > 8 members, or a cluster size the card
// refuses; ring_cluster.cu takes n <= 8, ring_member.cu the list form).
//
// Replaces the Pallas TPU kernels ytk_mp4j_tpu/ops/ring_kernel.py:179
// (_ring_kernel, called through _pallas_ring:244) and :276
// (_ring_kernel_bidir, through _pallas_ring_bidir:382), for both direction
// counts: a direction d is a part of the layout the wrapper passes (base,
// vbase, stride; ops/ring_kernel.py _Layout), not a template parameter.
//
// What it computes is the TPU kernels' result, bit for bit: for every
// chunk K of direction d, the fold acc = op(acc, x_m[chunk K]) over the
// members m in exactly the order in which the ring's schedule folds that
// chunk (RingPlan.start / merge in ops/ring_kernel.py). That order is a
// rotation: row (K + order[d][j]) mod n is the j-th of chunk K, and the
// wrapper builds order[][] from RingPlan (fold_rotation) and passes it as a
// device array. What it drops is the TPU's transport: a ring of
// neighbours, receive slots, semaphores and 2(n-1) dependent steps. All n
// rows lie in this card's memory, so each chunk is folded ONCE, straight
// from the rows, and written to every row that receives it.
//
// One plain launch on the caller's stream, grid (cols, jobs), a job one
// (direction, chunk) pair, a column one contiguous stretch of the job:
//   ring_fold  (allreduce, reduce-scatter) job (d, K): fold chunk K over
//              the n rows in the ring's order; a reduce-scatter stores it
//              into row K's output at vbase[d], an allreduce into chunk K
//              of every row (one fold a chunk, no second round);
//   ring_copy  (allgather) job (d, q): row q's part, loaded once and
//              stored at chunk (d, q) of every row.
// No block waits on another: no flag, no slot, no spin, no cooperative
// launch, and nothing needs to be co-resident.
//
// Loads and stores are 16 bytes a thread: the packed layout puts every
// chunk and every row on a 16-byte boundary (ops/ring_kernel.py granule),
// and the entry point refuses a layout that does not. A fold issues the
// loads of up to kBatch rows, U vectors each, before it folds any
// of them, so that they are in flight together; a copy loads kUnroll
// vectors before it stores. Measured on an H100 (PERF.md): two
// vectors a thread and four blocks an SM (ops/ring_kernel.py
// GLOBAL_FOLD_BLOCKS_PER_SM) took the reduce-scatter of 16 x 128M f64
// from 7.53 to 6.42 ms; 1- and 2-byte types keep one vector (their
// 16-lane int8 folds already take 176 registers: two would spill).
//
// Operators match the reference's jnp ops on the operand type, rounding
// at every step: MAX/MIN propagate NaN (fmaxf/fminf do not), narrow
// integers wrap like numpy, bf16 rounds to bf16 after every operation.
//
// What bounds it: bytes. Each input byte is read once and each output
// byte written once -- the bound's own bytes, in all three modes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBatch = 8;          // rows of loads in flight before a fold
constexpr int kUnroll = 4;         // vector loads in flight before a copy
constexpr int kMaxMembers = 2048;  // ops/ring_kernel.py GLOBAL_MAX_MEMBERS:
                                   // a block's row offsets, in shared memory

constexpr int kReduceScatter = 1, kAllgather = 2;  // _MODE_CODES
constexpr int kSum = 0, kProd = 1, kMax = 2, kMin = 3;

struct RingParams {
  const void* x;          // [n, in_row]
  void* out;              // [n, out_row]
  const int* order;       // [ndir][n]: chunk K's j-th row is K + order[d][j]
  long long in_row, out_row;
  long long w;            // elements of one direction's chunk
  long long stride;       // chunk i + 1 starts stride after chunk i
  long long base[2];      // direction d's chunk 0 in the chunk layout
  long long vbase[2];     // direction d's part of a reduce-scatter output
                          // row / an allgather input row
  int n, mode, itemsize;
};

// ---- operators on the operand type ----
template <typename T>
__device__ __forceinline__ T nan_max(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a > b ? a : b;
}
template <typename T>
__device__ __forceinline__ T nan_min(T a, T b) {
  if (a != a) return a;
  if (b != b) return b;
  return a < b ? a : b;
}

template <int OP, typename T>
__device__ __forceinline__ T apply_float(T a, T b) {
  if (OP == kSum) return a + b;
  if (OP == kProd) return a * b;
  if (OP == kMax) return nan_max(a, b);
  return nan_min(a, b);
}

template <int S> struct BitsOf;
template <> struct BitsOf<4> { using type = unsigned int; };
template <> struct BitsOf<8> { using type = unsigned long long; };

// two's-complement wrap: the arithmetic runs unsigned (no overflow UB)
template <int OP, typename T>
__device__ __forceinline__ T apply_int(T a, T b) {
  using W = typename BitsOf<(sizeof(T) > 4 ? 8 : 4)>::type;
  if (OP == kSum) return (T)((W)a + (W)b);
  if (OP == kProd) return (T)((W)a * (W)b);
  if (OP == kMax) return a > b ? a : b;
  return a < b ? a : b;
}

template <int OP, typename T> struct Apply {
  __device__ __forceinline__ static T run(T a, T b) {
    return apply_int<OP>(a, b);
  }
};
template <int OP> struct Apply<OP, float> {
  __device__ __forceinline__ static float run(float a, float b) {
    return apply_float<OP>(a, b);
  }
};
template <int OP> struct Apply<OP, double> {
  __device__ __forceinline__ static double run(double a, double b) {
    return apply_float<OP>(a, b);
  }
};
template <int OP> struct Apply<OP, __nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 run(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    const float fa = __bfloat162float(a), fb = __bfloat162float(b);
    if (OP == kSum) return __float2bfloat16_rn(fa + fb);
    if (OP == kProd) return __float2bfloat16_rn(fa * fb);
    if (OP == kMax) {
      if (fa != fa) return a;
      if (fb != fb) return b;
      return fa > fb ? a : b;
    }
    if (fa != fa) return a;
    if (fb != fb) return b;
    return fa < fb ? a : b;
  }
};

// 16 bytes of T
template <typename T>
struct alignas(16) Vec {
  static constexpr int kLen = 16 / (int)sizeof(T);
  T v[kLen];
};


template <typename T>
__device__ __forceinline__ Vec<T> load16(const T* p) {
  const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
  Vec<T> r;
  memcpy(&r, &u, 16);
  return r;
}

template <typename T>
__device__ __forceinline__ void store16(T* p, const Vec<T>& v) {
  uint4 u;
  memcpy(&u, &v, 16);
  *reinterpret_cast<uint4*>(p) = u;
}

// [lo, hi) of the 16-byte vectors of a job's `count` that this block's
// column covers (ops/ring_kernel.py GlobalPlan.columns)
__device__ __forceinline__ void column(long long count, long long& lo,
                                       long long& hi) {
  const long long per = (count + gridDim.x - 1) / gridDim.x;
  lo = (long long)blockIdx.x * per;
  hi = lo + per < count ? lo + per : count;
}

// job (d, K): chunk K of direction d folded over the rows in the ring's
// order; stored into row K's output (reduce-scatter) or into chunk K of
// every row (allreduce)
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_fold(const __grid_constant__ RingParams p) {
  constexpr int V = Vec<T>::kLen;
  constexpr int U = sizeof(T) >= 4 ? 2 : 1;   // vectors a thread, side by
                                             // side (see the header)
  const int n = p.n;
  const int d = (int)blockIdx.y / n;
  const int K = (int)blockIdx.y % n;
  const long long off = p.base[d] + (long long)K * p.stride;
  const T* x = (const T*)p.x;
  T* out = (T*)p.out;
  extern __shared__ long long src[];   // the j-th row's chunk K, in x
  for (int j = threadIdx.x; j < n; j += kThreads) {
    int r = K + p.order[d * n + j];
    if (r >= n) r -= n;
    src[j] = (long long)r * p.in_row + off;
  }
  __syncthreads();
  const bool rs = p.mode == kReduceScatter;
  T* dst = out + (rs ? (long long)K * p.out_row + p.vbase[d] : off);
  long long lo, hi;
  column(p.w / V, lo, hi);
  // vector v0 + u * kThreads of the column, u < U
  for (long long v0 = lo + threadIdx.x; v0 < hi;
       v0 += (long long)kThreads * U) {
    Vec<T> acc[U];
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      Vec<T> got[kBatch][U];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const long long v = v0 + (long long)u * kThreads;
          if (j0 + b < n && v < hi) {
            got[b][u] = load16(x + src[j0 + b] + v * V);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (j0 + b >= n) break;
#pragma unroll
        for (int u = 0; u < U; ++u) {
          if (j0 + b == 0) {
            acc[u] = got[0][u];
            continue;
          }
#pragma unroll
          for (int i = 0; i < V; ++i) {
            acc[u].v[i] = Apply<OP, T>::run(acc[u].v[i], got[b][u].v[i]);
          }
        }
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const long long e = (v0 + (long long)u * kThreads) * V;
      if (e >= hi * V) break;
      if (rs) {
        store16(dst + e, acc[u]);
        continue;
      }
      for (int r = 0; r < n; ++r) {
        store16(dst + (long long)r * p.out_row + e, acc[u]);
      }
    }
  }
}

// job (d, q): row q's part of direction d, stored at chunk q of every row
__global__ void __launch_bounds__(kThreads)
    ring_copy(const __grid_constant__ RingParams p) {
  const int n = p.n;
  const int d = (int)blockIdx.y / n;
  const int q = (int)blockIdx.y % n;
  const uint4* from = reinterpret_cast<const uint4*>(
      (const unsigned char*)p.x +
      ((long long)q * p.in_row + p.vbase[d]) * p.itemsize);
  unsigned char* to = (unsigned char*)p.out +
                      (p.base[d] + (long long)q * p.stride) * p.itemsize;
  const long long row = p.out_row * p.itemsize;
  long long lo, hi;
  column(p.w * p.itemsize / 16, lo, hi);
  for (long long v0 = lo + threadIdx.x; v0 < hi;
       v0 += (long long)kThreads * kUnroll) {
    uint4 got[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long v = v0 + (long long)u * kThreads;
      if (v < hi) got[u] = __ldg(from + v);
    }
    for (int r = 0; r < n; ++r) {
      uint4* t = reinterpret_cast<uint4*>(to + (long long)r * row);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const long long v = v0 + (long long)u * kThreads;
        if (v < hi) t[v] = got[u];
      }
    }
  }
}

using KernelFn = void (*)(RingParams);

template <typename T>
KernelFn pick(int op) {
  switch (op) {
    case kSum: return ring_fold<T, kSum>;
    case kProd: return ring_fold<T, kProd>;
    case kMax: return ring_fold<T, kMax>;
    case kMin: return ring_fold<T, kMin>;
  }
  return nullptr;
}

// dtype codes: must match ops/ring_kernel.py _DTYPE_CODES
KernelFn kernel_for(int dtype, int op, int mode) {
  if (mode == kAllgather) return ring_copy;
  switch (dtype) {
    case 0: return pick<float>(op);
    case 1: return pick<double>(op);
    case 2: return pick<int32_t>(op);
    case 3: return pick<int64_t>(op);
    case 4: return pick<int16_t>(op);
    case 5: return pick<int8_t>(op);
    case 6: return pick<__nv_bfloat16>(op);
  }
  return nullptr;
}

int item_size(int dtype) {
  static const int sizes[] = {4, 8, 4, 8, 2, 1, 2};
  return dtype >= 0 && dtype < 7 ? sizes[dtype] : 0;
}

bool on16(long long elements, int itemsize) {
  return elements >= 0 && elements * itemsize % 16 == 0;
}

}  // namespace

extern "C" {

// One launch of grid (cols, ndir * n) on `stream`, on the caller's current
// device (the wrapper selects it; this never changes it). order holds
// ndir * n ints on the device (unused by an allgather). Refuses a layout
// whose chunks or rows are not on 16 bytes; returns the CUDA error of the
// launch.
int mp4j_ring_launch(int dtype, int op, int ndir, int mode, int n, int cols,
                     long long w, long long stride, long long base0,
                     long long base1, long long vbase0, long long vbase1,
                     long long in_row, long long out_row, const void* x,
                     void* out, const void* order, void* stream) {
  const int item = item_size(dtype);
  KernelFn k = kernel_for(dtype, op, mode);
  if (!k || item == 0 || n < 1 || n > kMaxMembers || ndir < 1 || ndir > 2 ||
      cols < 1 || (mode != kAllgather && !order) ||
      (uintptr_t)x % 16 || (uintptr_t)out % 16) {
    return (int)cudaErrorInvalidValue;
  }
  const long long at[] = {w, stride, base0, base1, vbase0, vbase1, in_row,
                          out_row};
  for (long long e : at) {
    if (!on16(e, item)) return (int)cudaErrorInvalidValue;
  }
  RingParams p;
  memset(&p, 0, sizeof(p));
  p.x = x;
  p.out = out;
  p.order = (const int*)order;
  p.in_row = in_row;
  p.out_row = out_row;
  p.w = w;
  p.stride = stride;
  p.base[0] = base0;
  p.base[1] = base1;
  p.vbase[0] = vbase0;
  p.vbase[1] = vbase1;
  p.n = n;
  p.mode = mode;
  p.itemsize = item;
  const size_t smem = mode == kAllgather ? 0 : (size_t)n * sizeof(long long);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchKernel((const void*)k, dim3(cols, ndir * n),
                                   dim3(kThreads), args, smem,
                                   (cudaStream_t)stream);
  if (e != cudaSuccess) {
    cudaGetLastError();        // leave no launch error for the next caller
    return (int)e;
  }
  return (int)cudaGetLastError();
}

int mp4j_ring_max_members() { return kMaxMembers; }

int mp4j_ring_threads() { return kThreads; }

const char* mp4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
