// Ring allreduce / reduce-scatter / allgather for Hopper (sm_90a): n ring
// members on one card in one launch (the packed form's global path, for
// n > 8 members; ring_cluster.cu takes n <= 8, ring_member.cu the list
// form, one launch a member).
//
// Replaces the Pallas TPU kernels ytk_mp4j_tpu/ops/ring_kernel.py:179
// (_ring_kernel, called through _pallas_ring:244) and :276
// (_ring_kernel_bidir, through _pallas_ring_bidir:382). One template
// serves both: NDIR = 1 is the unidirectional ring, NDIR = 2 rings two
// halves of the payload in opposite directions. Same contract, step order
// and fold order as the TPU kernels; the schedule is the one that
// ops/ring_kernel.py describes in Python (RingPlan), and every formula
// below is one of its methods:
//
//   direction d has sign s_d (-1: send right, +1: send left); member me
//   sends to me - s_d and takes credits from it, receives from me + s_d.
//   reduce modes (sh = s_d for reduce-scatter, 0 for allreduce):
//     acc = x[chunk(me + sh)];  n-1 steps: acc = op(got, x[chunk(me +
//     s_d (s+1) + sh)]); reduce-scatter stores acc; allreduce stores it
//     at chunk(me - s_d), then n-1 forwarding steps store chunk(me + s_d s)
//   allgather: out[chunk(me)] = x; n-1 steps store chunk(me + s_d (s+1)).
//
// Members. Member me is the row blockIdx.y; column
// blockIdx.x of blocks across the n members is an independent ring over
// one sub-range of every chunk, walked in segments of kSeg elements (the
// global step counter g runs on across segments). No member ever needs a
// grid-wide sync. Every member of a launch spins on its neighbours, so
// all n * cols blocks must be resident at once: the launch is
// cooperative, and the wrapper refuses a grid over the occupancy capacity
// before it launches.
//
// Protocol per direction (ring_kernel.py's PROTOCOL; the TPU kernel's
// _direction:128 without its DMA semaphores -- a store here is the copy):
//   begin(g):  slot = g % 2; from g >= 2 wait credit[me][slot] >= g - 1
//              (the receiver consumed step g - 2); write the value into
//              the receiver's slot; __syncthreads; thread 0 release-stores
//              recv[dst][slot] = g + 1.
//   finish(g): thread 0 acquire-spins recv[me][slot] >= g + 1;
//              __syncthreads; read the slot; __syncthreads; thread 0
//              release-stores credit[up][slot] = g + 1.
//   exit:      wait the last credit of each used slot.
// Flags hold step numbers g + 1 and only grow within a launch; the
// wrapper zeroes them on the launch's stream before every launch, so
// nothing an earlier (or failed) launch left can satisfy a wait.
// Every spin is bounded by spin_ns of %globaltimer; hitting it (or seeing
// another block of the launch hit it) sets the launch's error word and
// returns, and the wrapper raises.
//
// Every flag access is at device scope. The slots are moved by weak .cg
// accesses (L2, never a stale L1 line); what orders them is the flag
// protocol: the sender's threads store into the receiver's slot, bar.sync
// orders those stores before thread 0's fence (__threadfence) and its
// release-store of the receiver's flag; the receiver's thread 0
// acquire-loads the flag, and bar.sync orders that before its threads'
// slot loads.
//
// Operators match the reference's jnp ops on the operand type, rounding
// at every step: MAX/MIN propagate NaN (fmaxf/fminf do not), narrow
// integers wrap like numpy, bf16 rounds to bf16 after every op.
//
// What bounds it: bytes. Each step reads one slot and one input chunk and
// writes one slot; the wrapper's bound counts the inputs read once and the
// outputs written once at 3.35 TB/s. This first version moves scalars
// (16-byte vector loads, TMA and fewer flag round trips come later).

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 8;
constexpr int kSeg = kThreads * kPerThread;   // elements of a slot

constexpr int kAllreduce = 0, kReduceScatter = 1, kAllgather = 2;
constexpr int kSum = 0, kProd = 1, kMax = 2, kMin = 3;

struct RingParams {
  const void* x;                // [n, in_row]
  void* out;                    // [n, out_row]
  void* slots;                  // [ndir][n][cols][2][kSeg]
  unsigned long long* flags;    // [2 (recv, credit)][ndir][n][cols][2]
  long long* err;               // [4]: code, member, step, what
  long long in_row, out_row;
  long long w;                  // elements of one direction's chunk
  long long stride;             // chunk i + 1 starts stride after chunk i
  long long base[2];            // direction d's chunk 0 in the chunk layout
  long long vbase[2];           // direction d's part of a reduce-scatter
                                // output / allgather input row
  long long col_w;              // elements of a chunk one column covers
  long long spin_ns;
  int n, mode, cols, stall_member;
};

// ---- slot loads and stores through L2 (.cg): never a stale L1 line ----
__device__ __forceinline__ unsigned long long ld_cg(const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.global.cg.u64 %0, [%1];" : "=l"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned int ld_cg(const unsigned int* p) {
  unsigned int v;
  asm volatile("ld.global.cg.u32 %0, [%1];" : "=r"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned short ld_cg(const unsigned short* p) {
  unsigned short v;
  asm volatile("ld.global.cg.u16 %0, [%1];" : "=h"(v) : "l"(p));
  return v;
}
__device__ __forceinline__ unsigned char ld_cg(const unsigned char* p) {
  unsigned short v;
  asm volatile("ld.global.cg.u8 %0, [%1];" : "=h"(v) : "l"(p));
  return (unsigned char)v;
}
__device__ __forceinline__ void st_cg(unsigned long long* p, unsigned long long v) {
  asm volatile("st.global.cg.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}
__device__ __forceinline__ void st_cg(unsigned int* p, unsigned int v) {
  asm volatile("st.global.cg.u32 [%0], %1;" ::"l"(p), "r"(v) : "memory");
}
__device__ __forceinline__ void st_cg(unsigned short* p, unsigned short v) {
  asm volatile("st.global.cg.u16 [%0], %1;" ::"l"(p), "h"(v) : "memory");
}
__device__ __forceinline__ void st_cg(unsigned char* p, unsigned char v) {
  unsigned short w = v;
  asm volatile("st.global.cg.u8 [%0], %1;" ::"l"(p), "h"(w) : "memory");
}

template <int S> struct BitsOf;
template <> struct BitsOf<1> { using type = unsigned char; };
template <> struct BitsOf<2> { using type = unsigned short; };
template <> struct BitsOf<4> { using type = unsigned int; };
template <> struct BitsOf<8> { using type = unsigned long long; };

template <typename T>
__device__ __forceinline__ T slot_load(const T* p) {
  using U = typename BitsOf<sizeof(T)>::type;
  U u = ld_cg(reinterpret_cast<const U*>(p));
  T v;
  memcpy(&v, &u, sizeof(T));
  return v;
}

template <typename T>
__device__ __forceinline__ void slot_store(T* p, T v) {
  using U = typename BitsOf<sizeof(T)>::type;
  U u;
  memcpy(&u, &v, sizeof(T));
  st_cg(reinterpret_cast<U*>(p), u);
}

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

// ---- flags ----
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int mod(long long a, int n) {
  long long r = a % n;
  return (int)(r < 0 ? r + n : r);
}

struct Flags {
  unsigned long long* base;               // every member's flags
  int ndir, n, cols;
  __device__ unsigned long long* at(int kind, int d, int m, int col,
                                    int slot) const {
    return base + ((((long long)kind * ndir + d) * n + m) * cols + col) * 2 +
           slot;
  }
};

constexpr int kRecv = 0, kCredit = 1;
constexpr cuda::thread_scope kScope = cuda::thread_scope_device;

__device__ __forceinline__ void release(unsigned long long* f,
                                        unsigned long long v) {
  cuda::atomic_ref<unsigned long long, kScope> a(*f);
  a.store(v, cuda::memory_order_release);
}

// Thread 0 spins until *f >= want (bounded); every thread gets the
// verdict. On a timeout, or when another block already failed, records
// the error (first writer wins) and returns false.
__device__ bool wait_geq(unsigned long long* f, unsigned long long want,
                         const RingParams& p, int me, long long g, int what) {
  __shared__ int ok;
  if (threadIdx.x == 0) {
    cuda::atomic_ref<unsigned long long, kScope> a(*f);
    cuda::atomic_ref<long long, kScope> err(p.err[0]);
    int good = 1;
    if (a.load(cuda::memory_order_acquire) < want) {
      const unsigned long long t0 = now_ns();
      unsigned int polls = 0;
      while (a.load(cuda::memory_order_acquire) < want) {
        if ((++polls & 255u) == 0) {
          if (err.load(cuda::memory_order_relaxed) != 0) {
            good = 0;
            break;
          }
          if ((long long)(now_ns() - t0) > p.spin_ns) {
            long long zero = 0;
            if (err.compare_exchange_strong(zero, 1,
                                            cuda::memory_order_relaxed)) {
              p.err[1] = me;
              p.err[2] = g;
              p.err[3] = what;
            }
            good = 0;
            break;
          }
        }
        __nanosleep(32);
      }
    }
    ok = good;
  }
  __syncthreads();
  const int r = ok;
  __syncthreads();
  return r != 0;
}

template <typename T, int OP, int NDIR>
struct Ring {
  const RingParams& p;
  Flags fl;
  T* slots;
  int me, col;
  long long g;                   // global step

  __device__ static int sign(int d) { return d == 0 ? -1 : 1; }

  __device__ T* slot(int d, int m, int s) const {
    return slots +
           ((((long long)d * p.n + m) * p.cols + col) * 2 + s) * kSeg;
  }

  __device__ bool wait(int kind, int d, int m, int s, long long v,
                       int what) const {
    return wait_geq(fl.at(kind, d, m, col, s), (unsigned long long)v, p, me,
                    g, what);
  }

  // send v right/left in every direction, then receive; v becomes what
  // arrived (all begins before any finish, as the bidirectional TPU
  // kernel's exchange2)
  __device__ bool exchange(T (&v)[NDIR][kPerThread], int len) {
    const int s = (int)(g & 1);
#pragma unroll
    for (int d = 0; d < NDIR; ++d) {
      const int dst = mod(me - sign(d), p.n);
      if (g >= 2 && !wait(kCredit, d, me, s, g - 1, 1)) {
        return false;
      }
      T* dp = slot(d, dst, s);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < len) slot_store(dp + i, v[d][k]);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        __threadfence();
        release(fl.at(kRecv, d, dst, col, s), g + 1);
      }
    }
#pragma unroll
    for (int d = 0; d < NDIR; ++d) {
      if (!wait(kRecv, d, me, s, g + 1, 0)) {
        return false;
      }
      const T* sp = slot(d, me, s);
#pragma unroll
      for (int k = 0; k < kPerThread; ++k) {
        const int i = threadIdx.x + k * kThreads;
        if (i < len) v[d][k] = slot_load(sp + i);
      }
      __syncthreads();
      if (threadIdx.x == 0) {
        release(fl.at(kCredit, d, mod(me + sign(d), p.n), col, s), g + 1);
      }
    }
    ++g;
    return true;
  }

  __device__ long long chunk(int d, long long i) const {
    return p.base[d] + (long long)mod(i, p.n) * p.stride;
  }

  __device__ void load(T (&v)[kPerThread], const T* src, int len) const {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < len) v[k] = src[i];
    }
  }

  __device__ void store(T* dst, const T (&v)[kPerThread], int len) const {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < len) dst[i] = v[k];
    }
  }

  __device__ void merge(T (&v)[kPerThread], const T* src, int len) const {
#pragma unroll
    for (int k = 0; k < kPerThread; ++k) {
      const int i = threadIdx.x + k * kThreads;
      if (i < len) v[k] = Apply<OP, T>::run(v[k], src[i]);
    }
  }

  // one segment [seg0, seg0 + len) of every chunk, all directions
  __device__ bool segment(long long seg0, int len) {
    const T* x = (const T*)p.x + (long long)me * p.in_row;
    T* out = (T*)p.out + (long long)me * p.out_row;
    const int n = p.n;
    T v[NDIR][kPerThread];
    if (p.mode == kAllgather) {
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        load(v[d], x + p.vbase[d] + seg0, len);
        store(out + chunk(d, me) + seg0, v[d], len);
      }
      for (int s = 0; s < n - 1; ++s) {
        if (!exchange(v, len)) return false;
#pragma unroll
        for (int d = 0; d < NDIR; ++d) {
          store(out + chunk(d, me + sign(d) * (s + 1)) + seg0, v[d], len);
        }
      }
      return true;
    }
    const bool rs = p.mode == kReduceScatter;
#pragma unroll
    for (int d = 0; d < NDIR; ++d) {
      const int sh = rs ? sign(d) : 0;
      load(v[d], x + chunk(d, me + sh) + seg0, len);
    }
    for (int s = 0; s < n - 1; ++s) {
      if (!exchange(v, len)) return false;
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        const int sh = rs ? sign(d) : 0;
        merge(v[d], x + chunk(d, me + sign(d) * (s + 1) + sh) + seg0, len);
      }
    }
    if (rs) {
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        store(out + p.vbase[d] + seg0, v[d], len);
      }
      return true;
    }
#pragma unroll
    for (int d = 0; d < NDIR; ++d) {
      store(out + chunk(d, me - sign(d)) + seg0, v[d], len);
    }
    for (int s = 0; s < n - 1; ++s) {
      if (!exchange(v, len)) return false;
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        store(out + chunk(d, me + sign(d) * s) + seg0, v[d], len);
      }
    }
    return true;
  }

  // the last credit of each used slot: the receiver consumed everything
  __device__ void drain() {
    for (int s = 0; s < 2 && s < g; ++s) {
      const long long last = ((g - 1) & 1) == s ? g - 1 : g - 2;
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        if (!wait(kCredit, d, me, s, last + 1, 2)) {
          return;
        }
      }
    }
  }
};

template <typename T, int OP, int NDIR>
__global__ void __launch_bounds__(kThreads)
    ring_kernel(const __grid_constant__ RingParams p) {
  const int me = (int)blockIdx.y;
  if (me == p.stall_member) return;   // test hook: a member that never runs
  Ring<T, OP, NDIR> r{p, Flags{p.flags, NDIR, p.n, p.cols}, (T*)p.slots, me,
                      (int)blockIdx.x, 0};
  const long long lo = (long long)blockIdx.x * p.col_w;
  const long long hi = lo + p.col_w < p.w ? lo + p.col_w : p.w;
  for (long long seg0 = lo; seg0 < hi; seg0 += kSeg) {
    const int len = (int)(hi - seg0 < kSeg ? hi - seg0 : kSeg);
    if (!r.segment(seg0, len)) return;
  }
  r.drain();
}

using KernelFn = void (*)(RingParams);

template <typename T>
KernelFn pick(int op, int ndir) {
  if (ndir == 1) {
    switch (op) {
      case kSum: return ring_kernel<T, kSum, 1>;
      case kProd: return ring_kernel<T, kProd, 1>;
      case kMax: return ring_kernel<T, kMax, 1>;
      case kMin: return ring_kernel<T, kMin, 1>;
    }
  } else if (ndir == 2) {
    switch (op) {
      case kSum: return ring_kernel<T, kSum, 2>;
      case kProd: return ring_kernel<T, kProd, 2>;
      case kMax: return ring_kernel<T, kMax, 2>;
      case kMin: return ring_kernel<T, kMin, 2>;
    }
  }
  return nullptr;
}

// dtype codes: must match ops/ring_kernel.py _DTYPE_CODES
KernelFn kernel_for(int dtype, int op, int ndir) {
  switch (dtype) {
    case 0: return pick<float>(op, ndir);
    case 1: return pick<double>(op, ndir);
    case 2: return pick<int32_t>(op, ndir);
    case 3: return pick<int64_t>(op, ndir);
    case 4: return pick<int16_t>(op, ndir);
    case 5: return pick<int8_t>(op, ndir);
    case 6: return pick<__nv_bfloat16>(op, ndir);
  }
  return nullptr;
}

void fill_params(RingParams& p, int n, int mode, int cols, long long w,
                 long long stride, long long base0, long long base1,
                 long long vbase0, long long vbase1, long long col_w,
                 long long in_row, long long out_row, const void* x,
                 void* out, void* err, long long spin_ns, int stall_member) {
  memset(&p, 0, sizeof(p));
  p.x = x;
  p.out = out;
  p.err = (long long*)err;
  p.in_row = in_row;
  p.out_row = out_row;
  p.w = w;
  p.stride = stride;
  p.base[0] = base0;
  p.base[1] = base1;
  p.vbase[0] = vbase0;
  p.vbase[1] = vbase1;
  p.col_w = col_w;
  p.spin_ns = spin_ns;
  p.n = n;
  p.mode = mode;
  p.cols = cols;
  p.stall_member = stall_member;
}

}  // namespace

extern "C" {

// Both entry points work on the caller's current device (the wrapper
// selects it) and never change it.

// Blocks of the kernel that can be resident at once on the current device.
int mp4j_ring_capacity(int dtype, int op, int ndir, int* blocks) {
  KernelFn k = kernel_for(dtype, op, ndir);
  if (!k) return (int)cudaErrorInvalidValue;
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  int sms = 0, per_sm = 0;
  e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k, kThreads, 0);
  if (e != cudaSuccess) return (int)e;
  *blocks = per_sm * sms;
  return 0;
}

int mp4j_ring_seg() { return kSeg; }

// One cooperative launch of grid (cols, n) on `stream`; returns the CUDA
// error of the launch. flags (2 * ndir * n * cols * 2 uint64) and err
// (4 int64) must be zero on the stream; slots hold ndir * n * cols * 2 *
// kSeg elements.
int mp4j_ring_launch(int dtype, int op, int ndir, int mode, int n, int cols,
                     long long w, long long stride, long long base0,
                     long long base1, long long vbase0, long long vbase1,
                     long long col_w, long long in_row, long long out_row,
                     const void* x, void* out, void* slots, void* flags,
                     void* err, long long spin_ns, int stall_member,
                     void* stream) {
  KernelFn k = kernel_for(dtype, op, ndir);
  if (!k) return (int)cudaErrorInvalidValue;
  RingParams p;
  fill_params(p, n, mode, cols, w, stride, base0, base1, vbase0, vbase1,
              col_w, in_row, out_row, x, out, err, spin_ns, stall_member);
  p.slots = slots;
  p.flags = (unsigned long long*)flags;
  void* args[] = {&p};
  cudaError_t e = cudaLaunchCooperativeKernel((const void*)k, dim3(cols, n),
                                  dim3(kThreads), args, 0,
                                  (cudaStream_t)stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* mp4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
