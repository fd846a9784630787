// Ring allreduce / reduce-scatter / allgather of a list of members, one
// launch a member, each on its member's card, for Hopper (sm_90a).
//
// Replaces, for the list form (ops/ring_kernel.py with n member tensors),
// the Pallas TPU kernels ytk_mp4j_tpu/ops/ring_kernel.py:179
// (_ring_kernel, called through _pallas_ring:244) and :276
// (_ring_kernel_bidir, through _pallas_ring_bidir:382). The packed form
// (n members as the rows of one tensor on one card) stays with
// ring_cluster.cu and ring_kernel.cu.
//
// What it computes is the TPU kernels' result, bit for bit: for every
// chunk K of direction d, the fold acc = op(acc, x_m[chunk K]) over the
// members m in exactly the order in which the ring's schedule folds that
// chunk (RingPlan.start / merge in ops/ring_kernel.py). That order is a
// rotation: member (K + order[d][j]) mod n is the j-th of chunk K, and the
// wrapper builds order[][] from RingPlan and passes it here. What it drops
// is the TPU's transport: a ring of neighbours, receive slots and
// semaphores. On this card every member can read every other member's
// input directly (on one card it is local memory; across the cards of an
// HGX board, peer memory over NVSwitch, all to all), so a member reads
// the chunks it owes straight from every input.
//
// Ordering is by CUDA events, never by flags: before any member launch,
// each member's stream waits on the ready event of every card of the list
// (recorded on the card's current stream, which made the inputs); after
// the last launch, every card's current stream waits on every launch. A
// kernel thus needs no flag, no spin and no co-residency with the other
// members: it cannot hang, and the launches may run in any order. What
// needs the whole group (the allreduce's gather half) is a second launch,
// behind a join event that follows every member's first launch.
//
// Tasks (one a launch; grid (cols, jobs), a job one chunk of one
// direction, a column one contiguous stretch of it):
//   kFoldOwn     reduce-scatter, and round 1 of the allreduce in two:
//                member me folds chunk me of every direction;
//   kFoldAll     the allreduce in one launch: member me folds every chunk
//                itself (n times the reads, no second round);
//   kCopyInputs  allgather: every member's part, from its input;
//   kCopyOwners  round 2 of the allreduce in two: every other chunk, from
//                the output of the member that folded it in round 1.
//
// Loads and stores are 16 bytes a thread (the wrapper puts every chunk on
// a 16-byte boundary of every member's tensor); a fold issues the loads of
// up to kBatch members before it folds any, so that they are in flight
// together. A scalar tail covers a chunk whose bytes are not a multiple
// of 16.
//
// Operators are ring_kernel.cu's Apply<OP, T> (each .cu compiles alone):
// MAX/MIN propagate NaN (fmaxf/fminf do not), narrow integers wrap like
// numpy, bf16 rounds to bf16 after every operation.
//
// What bounds it: bytes. A reduce-scatter reads every input once and
// writes every output once (the bound's own bytes); an allgather reads
// each input once a member; the allreduce in one launch reads every input
// once a member (n times the bound's reads), in two launches every input
// once plus the folded chunks once a member.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxMembers = 64;   // ops/ring_kernel.py MAX_MEMBERS
constexpr int kBatch = 8;         // member loads in flight before a fold

constexpr int kReduceScatter = 1;   // ops/ring_kernel.py _MODE_CODES
constexpr int kSum = 0, kProd = 1, kMax = 2, kMin = 3;
constexpr int kFoldOwn = 0, kFoldAll = 1, kCopyInputs = 2, kCopyOwners = 3;

struct MemberParams {
  const void* x[kMaxMembers];   // member m's input [in_row]
  void* out[kMaxMembers];       // member m's output [out_row]
  long long w;                  // elements of one direction's chunk
  long long stride;             // chunk i + 1 starts stride after chunk i
  long long base[2];            // direction d's chunk 0 in the chunk layout
  long long vbase[2];           // direction d's part of a reduce-scatter
                                // output / allgather input
  int n, me, mode, task, itemsize;
  unsigned char order[2][kMaxMembers];   // chunk K's j-th: K + order[d][j]
};

// ---- operators on the operand type (as ring_kernel.cu) ----
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
// column covers
__device__ __forceinline__ void column(long long count, long long& lo,
                                       long long& hi) {
  const long long per = (count + gridDim.x - 1) / gridDim.x;
  lo = (long long)blockIdx.x * per;
  hi = lo + per < count ? lo + per : count;
}

__device__ __forceinline__ int wrap(int a, int n) { return a >= n ? a - n : a; }

// kFoldOwn / kFoldAll: dst = the fold of chunk K over every member, in
// the ring's order for that chunk
template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
    ring_member_fold(const __grid_constant__ MemberParams p) {
  constexpr int V = Vec<T>::kLen;
  const int n = p.n;
  const int d = p.task == kFoldAll ? (int)blockIdx.y / n : (int)blockIdx.y;
  const int K = p.task == kFoldAll ? (int)blockIdx.y % n : p.me;
  const long long off = p.base[d] + (long long)K * p.stride;
  __shared__ const T* src[kMaxMembers];
  for (int j = threadIdx.x; j < n; j += kThreads) {
    src[j] = (const T*)p.x[wrap(K + p.order[d][j], n)] + off;
  }
  __syncthreads();
  T* dst = (T*)p.out[p.me] + (p.mode == kReduceScatter ? p.vbase[d] : off);
  long long lo, hi;
  column(p.w / V, lo, hi);
  for (long long v = lo + threadIdx.x; v < hi; v += kThreads) {
    const long long e = v * V;
    Vec<T> acc;
    for (int j0 = 0; j0 < n; j0 += kBatch) {
      Vec<T> got[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (j0 + b < n) got[b] = load16(src[j0 + b] + e);
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        if (j0 + b >= n) break;
        if (j0 + b == 0) {
          acc = got[0];
          continue;
        }
#pragma unroll
        for (int i = 0; i < V; ++i) {
          acc.v[i] = Apply<OP, T>::run(acc.v[i], got[b].v[i]);
        }
      }
    }
    store16(dst + e, acc);
  }
  if (blockIdx.x == gridDim.x - 1) {   // the scalar tail
    for (long long e = p.w / V * V + threadIdx.x; e < p.w; e += kThreads) {
      T acc = src[0][e];
      for (int j = 1; j < n; ++j) acc = Apply<OP, T>::run(acc, src[j][e]);
      dst[e] = acc;
    }
  }
}

// kCopyInputs / kCopyOwners: a byte copy of one chunk of one direction
__global__ void __launch_bounds__(kThreads)
    ring_member_copy(const __grid_constant__ MemberParams p) {
  const int n = p.n;
  int d, q;
  const unsigned char* from;
  if (p.task == kCopyInputs) {
    d = (int)blockIdx.y / n;
    q = (int)blockIdx.y % n;
    from = (const unsigned char*)p.x[q] + p.vbase[d] * p.itemsize;
  } else {
    d = (int)blockIdx.y / (n - 1);
    q = wrap(p.me + 1 + (int)blockIdx.y % (n - 1), n);
    from = (const unsigned char*)p.out[q] +
           (p.base[d] + (long long)q * p.stride) * p.itemsize;
  }
  unsigned char* to = (unsigned char*)p.out[p.me] +
                      (p.base[d] + (long long)q * p.stride) * p.itemsize;
  const long long bytes = p.w * p.itemsize;
  long long lo, hi;
  column(bytes / 16, lo, hi);
  for (long long v = lo + threadIdx.x; v < hi; v += kThreads) {
    reinterpret_cast<uint4*>(to)[v] =
        __ldg(reinterpret_cast<const uint4*>(from) + v);
  }
  if (blockIdx.x == gridDim.x - 1) {
    for (long long b = bytes / 16 * 16 + threadIdx.x; b < bytes;
         b += kThreads) {
      to[b] = from[b];
    }
  }
}

using KernelFn = void (*)(MemberParams);

template <typename T>
KernelFn pick(int op) {
  switch (op) {
    case kSum: return ring_member_fold<T, kSum>;
    case kProd: return ring_member_fold<T, kProd>;
    case kMax: return ring_member_fold<T, kMax>;
    case kMin: return ring_member_fold<T, kMin>;
  }
  return nullptr;
}

// dtype codes: must match ops/ring_kernel.py _DTYPE_CODES
KernelFn kernel_for(int dtype, int op, int task) {
  if (task == kCopyInputs || task == kCopyOwners) return ring_member_copy;
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

int jobs_of(int task, int ndir, int n) {
  if (task == kFoldOwn) return ndir;
  if (task == kCopyOwners) return ndir * (n - 1);
  return ndir * n;
}

}  // namespace

extern "C" {

// Creates `count` events (no timing) on the current device into events[].
int mp4j_ring_member_events(int count, void** events) {
  for (int i = 0; i < count; ++i) {
    cudaEvent_t e;
    cudaError_t rc = cudaEventCreateWithFlags(&e, cudaEventDisableTiming);
    if (rc != cudaSuccess) return (int)rc;
    events[i] = e;
  }
  return 0;
}

// One call of the list form: every member's launches and the events that
// order them, in one host call. Member m runs on card devices[m], on
// streams[m] (a stream of that card), reading xs[] and writing outs[m].
// cards[c] are the distinct cards of the list, currents[c] their current
// streams and ready[c] an event of each; done1[m] and done[m] are events of
// member m's card and join one of member 0's. tasks[r] and cols[r] give
// round r (1 or 2 rounds); order is [ndir][n]. Switches the current device
// to launch on each card and restores it. On a failed launch, every card's
// current stream still waits on what was launched, *failed names the
// member, and the CUDA error is returned.
int mp4j_ring_members_launch(
    int dtype, int op, int mode, int ndir, int n, int rounds,
    const int* tasks, const int* cols, long long w, long long stride,
    long long base0, long long base1, long long vbase0, long long vbase1,
    const unsigned char* order, const int* devices, void* const* xs,
    void* const* outs, void* const* streams, int n_cards, const int* cards,
    void* const* currents, void* const* ready, void* const* done1,
    void* const* done, void* join, int* failed) {
  *failed = -1;
  if (n < 1 || n > kMaxMembers || ndir < 1 || ndir > 2 || rounds < 1 ||
      rounds > 2 || item_size(dtype) == 0) {
    return (int)cudaErrorInvalidValue;
  }
  int saved = 0;
  cudaError_t e = cudaGetDevice(&saved);
  if (e != cudaSuccess) return (int)e;
  MemberParams p;
  memset(&p, 0, sizeof(p));
  for (int m = 0; m < n; ++m) {
    p.x[m] = xs[m];
    p.out[m] = outs[m];
  }
  p.w = w;
  p.stride = stride;
  p.base[0] = base0;
  p.base[1] = base1;
  p.vbase[0] = vbase0;
  p.vbase[1] = vbase1;
  p.n = n;
  p.mode = mode;
  p.itemsize = item_size(dtype);
  for (int d = 0; d < ndir; ++d) {
    memcpy(p.order[d], order + d * n, n);
  }
  // what each card's current stream must wait on, also after a failure
  cudaEvent_t launched[2 * kMaxMembers];
  int n_launched = 0;
  auto finish = [&](cudaError_t rc) {
    for (int c = 0; c < n_cards; ++c) {
      cudaError_t s = cudaSetDevice(cards[c]);
      for (int i = 0; s == cudaSuccess && i < n_launched; ++i) {
        s = cudaStreamWaitEvent((cudaStream_t)currents[c], launched[i], 0);
      }
      if (rc == cudaSuccess) rc = s;
    }
    cudaError_t s = cudaSetDevice(saved);
    return (int)(rc == cudaSuccess ? s : rc);
  };
  for (int c = 0; c < n_cards; ++c) {
    e = cudaSetDevice(cards[c]);
    if (e == cudaSuccess) {
      e = cudaEventRecord((cudaEvent_t)ready[c], (cudaStream_t)currents[c]);
    }
    if (e != cudaSuccess) return finish(e);
  }
  for (int r = 0; r < rounds; ++r) {
    const int task = tasks[r];
    KernelFn k = kernel_for(dtype, op, task);
    if (!k || cols[r] < 1) return finish(cudaErrorInvalidValue);
    p.task = task;
    const dim3 grid(cols[r], jobs_of(task, ndir, n));
    for (int m = 0; m < n; ++m) {
      cudaStream_t s = (cudaStream_t)streams[m];
      e = cudaSetDevice(devices[m]);
      if (r == 0) {
        for (int c = 0; e == cudaSuccess && c < n_cards; ++c) {
          e = cudaStreamWaitEvent(s, (cudaEvent_t)ready[c], 0);
        }
      } else if (e == cudaSuccess) {
        e = cudaStreamWaitEvent(s, (cudaEvent_t)join, 0);
      }
      if (e != cudaSuccess) return finish(e);
      p.me = m;
      void* args[] = {&p};
      e = cudaLaunchKernel((const void*)k, grid, dim3(kThreads), args, 0, s);
      if (e == cudaSuccess) e = cudaGetLastError();
      if (e != cudaSuccess) {
        cudaGetLastError();    // leave no launch error for the next caller
        *failed = m;
        return finish(e);
      }
      cudaEvent_t ev = (cudaEvent_t)(r + 1 < rounds ? done1[m] : done[m]);
      e = cudaEventRecord(ev, s);
      if (e != cudaSuccess) return finish(e);
      launched[n_launched++] = ev;
    }
    if (r + 1 < rounds) {
      // join: member 0's stream after every member's first launch
      cudaStream_t s0 = (cudaStream_t)streams[0];
      e = cudaSetDevice(devices[0]);
      for (int m = 1; e == cudaSuccess && m < n; ++m) {
        e = cudaStreamWaitEvent(s0, (cudaEvent_t)done1[m], 0);
      }
      if (e == cudaSuccess) e = cudaEventRecord((cudaEvent_t)join, s0);
      if (e != cudaSuccess) return finish(e);
    }
  }
  // the last launch of each member follows its first: waiting on done[]
  // covers both rounds
  if (rounds == 2) n_launched = 0;
  for (int m = 0; rounds == 2 && m < n; ++m) {
    launched[n_launched++] = (cudaEvent_t)done[m];
  }
  return finish(cudaSuccess);
}

// Lets the current device reach card `peer`'s memory (peer access, once a
// pair; an earlier enable is no error). Refuses a pair the hardware
// cannot join: nothing is staged through the host.
int mp4j_ring_enable_peer(int peer) {
  int device = 0;
  cudaError_t e = cudaGetDevice(&device);
  if (e != cudaSuccess) return (int)e;
  int can = 0;
  e = cudaDeviceCanAccessPeer(&can, device, peer);
  if (e != cudaSuccess) return (int)e;
  if (!can) return (int)cudaErrorPeerAccessUnsupported;
  e = cudaDeviceEnablePeerAccess(peer, 0);
  if (e == cudaErrorPeerAccessAlreadyEnabled) {
    cudaGetLastError();        // clear the sticky-free error state
    return 0;
  }
  return (int)e;
}

int mp4j_ring_member_max() { return kMaxMembers; }

const char* mp4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
