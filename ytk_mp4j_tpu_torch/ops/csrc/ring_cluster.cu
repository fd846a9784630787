// Ring allreduce / reduce-scatter / allgather for Hopper (sm_90a): the n
// ring members of a column are the n blocks of one thread-block cluster,
// and the ring runs over the SM-to-SM network in shared memory.
//
// Replaces the same Pallas TPU kernels as ring_kernel.cu, for n <= 8
// members (the portable cluster size): ytk_mp4j_tpu/ops/ring_kernel.py:244
// (_pallas_ring, body _ring_kernel:179) with NDIR = 1 and :382
// (_pallas_ring_bidir, body _ring_kernel_bidir:276) with NDIR = 2. Same
// contract, schedule and fold order as ring_kernel.cu (ops/ring_kernel.py
// RingPlan); ring_kernel.cu stays the path for larger n.
//
// What bounds it: bytes. The bound reads every input once and writes every
// output once at the card's memory rate. The TPU kernel keeps its send and
// receive slots in VMEM and DMAs straight into the neighbour's VMEM; the
// global-memory kernel has to put its slots in device memory, where every
// step writes a segment and reads it back on top of the input. Here the
// slots are on chip too:
//
//   - the receive slots live in the receiver's shared memory; a send is one
//     bulk asynchronous copy (cp.async.bulk shared::cta -> shared::cluster)
//     that completes the bytes on the receiver's "full" mbarrier;
//   - a credit is a remote mbarrier arrive on the sender's "empty" barrier
//     for that slot (the TPU kernel's credit_sem), released at CTA scope;
//   - the local input chunks are bulk-loaded from device memory kLoads
//     loads ahead, across segments, so the HBM reads overlap the ring;
//   - the fold op(got, local) runs on 16-byte vectors from shared memory,
//     and outputs leave as 16-byte stores.
// Device memory then carries the input, read once, and the output, written
// once: the bound's bytes. What is left is the ring's own per-step
// latency, nearly the same for any slot size: small blocks (128 threads)
// and 12 KiB slots (the wrapper's choice) put three rings on an SM, so
// that one ring's waits overlap the others' copies and folds.
//
// Layout of a block's dynamic shared memory, per direction d (S = kSlots,
// P = kLoads):
//   full[d][k], empty[d][k]: mbarriers of receive slot k < S;
//   loaded[d][j]: mbarriers of input buffer j < P;
//   recv[d][k]: what the upstream sent at a step g with g % S == k;
//   buf[d][k]: what this block sends at step g (g % S == k): a segment's
//              first value, or what step g - 1 folded or forwarded.
//              buf[d][k] and the downstream's recv[d][k] are free again
//              once the downstream's credit for the last send from k has
//              arrived, so one credit wait guards both;
//   in[d][j]: input load m lands in in[d][m % P].
//
// Protocol per direction at global step g (ring_kernel.py protocol(S, 1)),
// k = g % S:
//   begin(g):  wait the credit of the send from slot (g + 1) % S (step
//              g + 1 - S), since step g writes the buffer that step g + 1
//              sends; bulk-copy buf[k] into the downstream's recv[k],
//              completing on its full[k].
//   finish(g): arrive.expect_tx(bytes) on our full[k] and wait its phase;
//              every thread reads recv[k] (and folds / stores / forwards);
//              __syncthreads; thread 0 arrives on the upstream's empty[k].
//   exit:      wait the last credit of every used slot, then a cluster
//              barrier.
// Set-up: every block initialises its mbarriers, fences them for the
// cluster and passes a cluster barrier before any block writes a peer's
// shared memory. Every block, the error path and the stalled test member
// included, passes the exit cluster barrier, so no block leaves while a
// peer may still write its shared memory or arrive on its barriers. A
// block stops issuing copies once it has failed or seen another's failure,
// and its copies already issued are each a few microseconds old at most
// when it reaches that barrier.
//
// Every wait is mbarrier.try_wait.parity in a loop bounded by spin_ns of
// %globaltimer; a timeout (or another block's error) records the error
// word and the block skips to the exit barrier. The launch is a plain one:
// clusters are independent rings, and the hardware makes the blocks of one
// cluster co-resident.
//
// Operators as ring_kernel.cu: MAX/MIN propagate NaN, narrow integers wrap,
// bf16 rounds after every operation; results are bitwise the plain
// version's.

#include <cuda/atomic>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 128;
constexpr int kSlots = 2;               // receive slots (and send buffers)
constexpr int kLoads = 2;               // input loads in flight
constexpr int kMaxSegBytes = 18432;     // largest slot, all directions
constexpr int kBarBytes = 256;          // mbarriers ahead of the slots
constexpr int kMaxCluster = 8;

constexpr int kReduceScatter = 1, kAllgather = 2;   // 0: allreduce
constexpr int kSum = 0, kProd = 1, kMax = 2, kMin = 3;
// what a failed wait waited on: ops/ring_kernel.py _WAITS
constexpr int kWaitRecv = 0, kWaitCredit = 1, kWaitDrain = 2, kWaitLoad = 3;

struct Params {
  const void* x;                // [n, in_row]
  void* out;                    // [n, out_row]
  long long* err;               // [4]: code, member, step, what
  long long in_row, out_row;
  long long w;                  // elements of one direction's chunk
  long long stride;             // chunk i + 1 starts stride after chunk i
  long long base[2];            // direction d's chunk 0 in the chunk layout
  long long vbase[2];           // direction d's part of a reduce-scatter
                                // output / allgather input row
  long long col_w;              // elements of a chunk one cluster covers
  long long spin_ns;
  int n, mode, seg, stall_member;   // seg: elements of one slot
};

size_t smem_bytes(int ndir, size_t seg_bytes) {
  return kBarBytes + (size_t)ndir * (2 * kSlots + kLoads) * seg_bytes;
}

// ---- operators on the operand type (ring_kernel.cu's, on 16 bytes) ----
template <int S> struct BitsOf;
template <> struct BitsOf<4> { using type = unsigned int; };
template <> struct BitsOf<8> { using type = unsigned long long; };

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

template <int OP, typename T> struct Apply {   // integers: wrap unsigned
  __device__ __forceinline__ static T run(T a, T b) {
    using W = typename BitsOf<(sizeof(T) > 4 ? 8 : 4)>::type;
    if (OP == kSum) return (T)((W)a + (W)b);
    if (OP == kProd) return (T)((W)a * (W)b);
    if (OP == kMax) return a > b ? a : b;
    return a < b ? a : b;
  }
};
template <int OP> struct Apply<OP, float> {
  __device__ __forceinline__ static float run(float a, float b) {
    if (OP == kSum) return a + b;
    if (OP == kProd) return a * b;
    if (OP == kMax) return nan_max(a, b);
    return nan_min(a, b);
  }
};
template <int OP> struct Apply<OP, double> {
  __device__ __forceinline__ static double run(double a, double b) {
    if (OP == kSum) return a + b;
    if (OP == kProd) return a * b;
    if (OP == kMax) return nan_max(a, b);
    return nan_min(a, b);
  }
};
template <int OP> struct Apply<OP, __nv_bfloat16> {
  __device__ __forceinline__ static __nv_bfloat16 run(__nv_bfloat16 a,
                                                      __nv_bfloat16 b) {
    const float fa = __bfloat162float(a), fb = __bfloat162float(b);
    if (OP == kSum) return __float2bfloat16_rn(fa + fb);
    if (OP == kProd) return __float2bfloat16_rn(fa * fb);
    if (fa != fa) return a;
    if (fb != fb) return b;
    if (OP == kMax) return fa > fb ? a : b;
    return fa < fb ? a : b;
  }
};

// op(got, local) lane by lane on one 16-byte vector
template <int OP, typename T>
__device__ __forceinline__ uint4 fold(uint4 got, uint4 local) {
  constexpr int K = 16 / sizeof(T);
  T a[K], b[K];
  memcpy(a, &got, 16);
  memcpy(b, &local, 16);
#pragma unroll
  for (int j = 0; j < K; ++j) a[j] = Apply<OP, T>::run(a[j], b[j]);
  memcpy(&got, a, 16);
  return got;
}

// ---- PTX: mbarriers, bulk copies, the cluster ----
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ int cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ int cluster_id() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(r));
  return (int)r;
}
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n"
               "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}
__device__ __forceinline__ uint32_t peer_addr(uint32_t local, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;"
               : "=r"(r) : "r"(local), "r"(rank));
  return r;
}
__device__ __forceinline__ void bar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void expect_bytes(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(bar), "r"(bytes) : "memory");
}
// A credit: the default (CTA-scope) release, as CUTLASS's cluster
// pipelines release a consumed slot. Every read it covers has returned its
// value before the __syncthreads ahead of it; a cluster-scope release would
// first wait for all the block's earlier writes (output stores included) to
// reach the cluster, which cost about a third of each step on the H100.
__device__ __forceinline__ void arrive_remote(uint32_t remote_bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];"
               :: "r"(remote_bar) : "memory");
}
__device__ __forceinline__ bool try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n .reg .pred p;\n"
      " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
      " selp.u32 %0, 1, 0, p;\n}"
      : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  return done != 0;
}
// generic-proxy writes to shared memory before an async-proxy read
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}
__device__ __forceinline__ void copy_to_peer(uint32_t dst, uint32_t src,
                                             uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "r"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ void load_bulk(uint32_t dst, const void* src,
                                          uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}
__device__ __forceinline__ unsigned long long now_ns() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}

__device__ __forceinline__ int mod(long long a, int n) {
  long long r = a % n;
  return (int)(r < 0 ? r + n : r);
}

template <typename T, int OP, int NDIR>
struct Block {
  const Params& p;
  unsigned char* smem;
  int me, col, seg_bytes;
  long long lo = 0, hi = 0;     // this column's part of every chunk
  int per_seg = 1;              // input loads per segment
  long long g = 0;              // global step
  long long mc = 0;             // input loads consumed (every thread)
  long long mi = 0;             // input loads issued (thread 0)

  __device__ static int sign(int d) { return d == 0 ? -1 : 1; }
  __device__ bool lead() const { return threadIdx.x == 0; }

  __device__ uint64_t* bars() const { return (uint64_t*)smem; }
  __device__ uint32_t full(int d, int k) const {
    return smem_addr(bars() + d * kSlots + k);
  }
  __device__ uint32_t empty(int d, int k) const {
    return smem_addr(bars() + (NDIR + d) * kSlots + k);
  }
  __device__ uint32_t loaded(int d, long long m) const {
    return smem_addr(bars() + 2 * NDIR * kSlots + d * kLoads +
                     (int)(m % kLoads));
  }
  __device__ unsigned char* slot(int i) const {
    return smem + kBarBytes + (size_t)i * seg_bytes;
  }
  __device__ unsigned char* recv(int d, int k) const {
    return slot(d * kSlots + k);
  }
  __device__ unsigned char* buf(int d, int k) const {
    return slot((NDIR + d) * kSlots + k);
  }
  __device__ unsigned char* in(int d, long long m) const {
    return slot(2 * NDIR * kSlots + d * kLoads + (int)(m % kLoads));
  }

  __device__ long long chunk(int d, long long i) const {
    return p.base[d] + (long long)mod(i, p.n) * p.stride;
  }

  __device__ void init() {
    if (lead()) {
      for (int i = 0; i < 2 * NDIR * kSlots + NDIR * kLoads; ++i) {
        bar_init(smem_addr(bars() + i), 1);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    lo = (long long)col * p.col_w;
    hi = lo + p.col_w < p.w ? lo + p.col_w : p.w;
    per_seg = p.mode == kAllgather || p.n == 1 ? 1 : p.n;
  }

  // records the first failure of the launch
  __device__ void fail(int what) const {
    cuda::atomic_ref<long long, cuda::thread_scope_device> err(p.err[0]);
    long long zero = 0;
    if (err.compare_exchange_strong(zero, 1, cuda::memory_order_relaxed)) {
      p.err[1] = me;
      p.err[2] = g;
      p.err[3] = what;
    }
  }

  // thread 0: wait until the phase of parity `parity` of `bar` completed
  __device__ bool wait(uint32_t bar, uint32_t parity, int what) const {
    if (try_wait(bar, parity)) return true;
    cuda::atomic_ref<long long, cuda::thread_scope_device> err(p.err[0]);
    const unsigned long long t0 = now_ns();
    for (unsigned int polls = 1;; ++polls) {
      if (try_wait(bar, parity)) return true;
      if ((polls & 15u) == 0) {
        if (err.load(cuda::memory_order_relaxed) != 0) return false;
        if ((long long)(now_ns() - t0) > p.spin_ns) {
          fail(what);
          return false;
        }
      }
    }
  }

  // every thread: the phase is known complete; take its acquire
  __device__ static void acquire(uint32_t bar, uint32_t parity) {
    while (!try_wait(bar, parity)) {
    }
  }

  __device__ static uint32_t load_parity(long long m) {
    return (uint32_t)((m / kLoads) & 1);
  }

  // thread 0, before writing buf[d][h % S]: the credit for the previous
  // send from that slot (step h - S) has come back
  __device__ bool reclaim(int d, long long h) const {
    if (h < kSlots) return true;
    return wait(empty(d, (int)(h % kSlots)),
                (uint32_t)((h / kSlots - 1) & 1), kWaitCredit);
  }

  // Input load m of this column: segment m / per_seg, and in it the first
  // value (index 0) or the local chunk of reduce step index - 1. False
  // past the column's last segment.
  __device__ bool load_src(int d, long long m, long long* off,
                           uint32_t* bytes) const {
    const long long seg0 = lo + (m / per_seg) * p.seg;
    if (seg0 >= hi) return false;
    const long long len = hi - seg0 < p.seg ? hi - seg0 : p.seg;
    *bytes = (uint32_t)(len * sizeof(T));
    if (p.mode == kAllgather) {
      *off = p.vbase[d] + seg0;
    } else {
      const int sh = p.mode == kReduceScatter ? sign(d) : 0;
      *off = chunk(d, me + sign(d) * (m % per_seg) + sh) + seg0;
    }
    return true;
  }

  // thread 0: keep kLoads input loads in flight, across segments
  __device__ void top_up() {
    for (; mi < mc + kLoads; ++mi) {
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        long long off;
        uint32_t bytes;
        if (!load_src(d, mi, &off, &bytes)) return;
        const T* x = (const T*)p.x + (long long)me * p.in_row + off;
        expect_bytes(loaded(d, mi), bytes);
        load_bulk(smem_addr(in(d, mi)), x, bytes, loaded(d, mi));
      }
    }
  }

  // thread 0, on every path out: no load may still land in our memory
  __device__ void settle() const {
    if (!lead()) return;
    for (long long m = mc; m < mi; ++m) {
#pragma unroll
      for (int d = 0; d < NDIR; ++d) acquire(loaded(d, m), load_parity(m));
    }
  }

  // every thread takes thread 0's verdict (a __syncthreads)
  __device__ bool verdict(bool good) const {
    return __syncthreads_and(lead() ? good : true) != 0;
  }

  __device__ void store_out(long long off, int i, uint4 v) const {
    T* out = (T*)p.out + (long long)me * p.out_row + off;
    reinterpret_cast<uint4*>(out)[i] = v;
  }

  // A segment's first value (input load mc): into buf[g % S] for the first
  // send (to_buf), and into the output at dst (to_out: allgather, n = 1).
  __device__ bool first(const long long (&dst)[NDIR], bool to_out,
                        bool to_buf, int nvec) {
    bool good = true;
    if (lead()) {
      top_up();
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        if (to_buf) good = good && reclaim(d, g);
        good = good && wait(loaded(d, mc), load_parity(mc), kWaitLoad);
      }
    }
    if (!verdict(good)) return false;
    const int k = (int)(g % kSlots);
#pragma unroll
    for (int d = 0; d < NDIR; ++d) {
      acquire(loaded(d, mc), load_parity(mc));
      const uint4* src = reinterpret_cast<const uint4*>(in(d, mc));
      uint4* b = reinterpret_cast<uint4*>(buf(d, k));
#pragma unroll 4
      for (int i = threadIdx.x; i < nvec; i += kThreads) {
        const uint4 v = src[i];
        if (to_buf) b[i] = v;
        if (to_out) store_out(dst[d], i, v);
      }
    }
    ++mc;
    fence_async_shared();     // our reads and writes before later copies
    __syncthreads();
    return true;
  }

  // One ring step in every direction: send buf[g % S]; receive recv[g % S]
  // as v; with `reduce`, v = op(v, input load mc); `keep`: v goes to
  // buf[(g + 1) % S] for the next send; out_off >= 0: v goes to the output.
  __device__ bool exchange(bool reduce, const long long (&out_off)[NDIR],
                           bool keep, int len) {
    const int k = (int)(g % kSlots), k1 = (int)((g + 1) % kSlots);
    const uint32_t bytes = (uint32_t)len * sizeof(T);
    const uint32_t par = (uint32_t)((g / kSlots) & 1);
    bool good = true;
    if (lead()) {
      top_up();
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {        // begin, every direction
        const int dst = mod(me - sign(d), p.n);
        if (keep) good = good && reclaim(d, g + 1);
        if (good) {
          fence_async_shared();
          copy_to_peer(peer_addr(smem_addr(recv(d, k)), dst),
                       smem_addr(buf(d, k)), bytes,
                       peer_addr(full(d, k), dst));
        }
      }
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {        // then every finish
        if (good) {
          expect_bytes(full(d, k), bytes);
          good = wait(full(d, k), par, kWaitRecv);
        }
        if (good && reduce) {
          good = wait(loaded(d, mc), load_parity(mc), kWaitLoad);
        }
      }
    }
    if (!verdict(good)) return false;
    const int nvec = (int)(bytes / 16);
#pragma unroll
    for (int d = 0; d < NDIR; ++d) {
      acquire(full(d, k), par);
      if (reduce) acquire(loaded(d, mc), load_parity(mc));
      const uint4* r = reinterpret_cast<const uint4*>(recv(d, k));
      const uint4* l = reinterpret_cast<const uint4*>(in(d, mc));
      uint4* b = reinterpret_cast<uint4*>(buf(d, k1));
#pragma unroll 4
      for (int i = threadIdx.x; i < nvec; i += kThreads) {
        uint4 v = r[i];
        if (reduce) v = fold<OP, T>(v, l[i]);
        if (keep) b[i] = v;
        if (out_off[d] >= 0) store_out(out_off[d], i, v);
      }
    }
    if (reduce) ++mc;
    fence_async_shared();     // our reads and writes before later copies
    __syncthreads();
    if (lead()) {
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {        // credit to the upstream
        arrive_remote(peer_addr(empty(d, k), mod(me + sign(d), p.n)));
      }
    }
    ++g;
    return true;
  }

  // one segment [seg0, seg0 + len) of every chunk, all directions
  __device__ bool segment(long long seg0, int len) {
    const int n = p.n;
    const bool ag = p.mode == kAllgather, rs = p.mode == kReduceScatter;
    long long off[NDIR];
#pragma unroll
    for (int d = 0; d < NDIR; ++d) {
      off[d] = (ag ? chunk(d, me)
                   : rs ? p.vbase[d] : chunk(d, me - sign(d))) + seg0;
    }
    if (!first(off, ag || n == 1, n > 1, (int)(len * sizeof(T) / 16))) {
      return false;
    }
    if (ag) {
      for (int s = 0; s < n - 1; ++s) {
#pragma unroll
        for (int d = 0; d < NDIR; ++d) {
          off[d] = chunk(d, me + sign(d) * (s + 1)) + seg0;
        }
        if (!exchange(false, off, s < n - 2, len)) return false;
      }
      return true;
    }
    for (int s = 0; s < n - 1; ++s) {
      const bool last = s == n - 2;
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        off[d] = !last ? -1
                 : (rs ? p.vbase[d] : chunk(d, me - sign(d))) + seg0;
      }
      if (!exchange(true, off, !last || !rs, len)) return false;
    }
    if (rs) return true;
    for (int s = 0; s < n - 1; ++s) {
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        off[d] = chunk(d, me + sign(d) * s) + seg0;
      }
      if (!exchange(false, off, s < n - 2, len)) return false;
    }
    return true;
  }

  // thread 0: the last credit of every used slot
  __device__ void drain() const {
    if (!lead()) return;
    for (int k = 0; k < kSlots && k < g; ++k) {
      const long long h = g - 1 - (g - 1 - k) % kSlots;   // last send from k
#pragma unroll
      for (int d = 0; d < NDIR; ++d) {
        if (!wait(empty(d, k), (uint32_t)((h / kSlots) & 1), kWaitDrain)) {
          return;
        }
      }
    }
  }

  __device__ void run() {
    bool good = true;
    for (long long seg0 = lo; good && seg0 < hi; seg0 += p.seg) {
      good = segment(seg0, (int)(hi - seg0 < p.seg ? hi - seg0 : p.seg));
    }
    if (good) drain();
    settle();
  }
};

template <typename T, int OP, int NDIR>
__global__ void __launch_bounds__(kThreads, 1)
    ring_cluster(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  Block<T, OP, NDIR> b{p, smem, cluster_rank(), cluster_id(),
                       p.seg * (int)sizeof(T)};
  b.init();
  __syncthreads();
  cluster_sync();            // every barrier of the cluster is initialised
  if (b.me != p.stall_member) b.run();   // test hook: a member that idles
  cluster_sync();            // no peer writes or arrives here any more
}

using KernelFn = void (*)(Params);

template <typename T>
KernelFn pick(int op, int ndir) {
  if (ndir == 1) {
    switch (op) {
      case kSum: return ring_cluster<T, kSum, 1>;
      case kProd: return ring_cluster<T, kProd, 1>;
      case kMax: return ring_cluster<T, kMax, 1>;
      case kMin: return ring_cluster<T, kMin, 1>;
    }
  } else if (ndir == 2) {
    switch (op) {
      case kSum: return ring_cluster<T, kSum, 2>;
      case kProd: return ring_cluster<T, kProd, 2>;
      case kMax: return ring_cluster<T, kMax, 2>;
      case kMin: return ring_cluster<T, kMin, 2>;
    }
  }
  return nullptr;
}

// dtype codes: must match ops/ring_kernel.py _DTYPE_CODES
constexpr int kDtypes = 7;
constexpr int kItemSize[kDtypes] = {4, 8, 4, 8, 2, 1, 2};

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

// Lets the kernel take its largest shared memory on the current device.
cudaError_t prepare(KernelFn k, int ndir) {
  return cudaFuncSetAttribute((const void*)k,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem_bytes(ndir, kMaxSegBytes / ndir));
}

void cluster_config(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr,
                    int n, int cols, size_t smem, cudaStream_t stream) {
  memset(cfg, 0, sizeof(*cfg));
  memset(attr, 0, sizeof(*attr));
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = n;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->gridDim = dim3(n * cols);
  cfg->blockDim = dim3(kThreads);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
}

}  // namespace

extern "C" {

// Both entry points work on the caller's current device (the wrapper
// selects it) and never change it.

// Clusters of n blocks of this kernel that can be resident at once on the
// current device with slots of slot_bytes per direction (0: the card
// refuses the size). Also lets the kernel take its largest shared memory
// on the device: query once per (dtype, op, ndir) and device before the
// first launch there.
int mp4j_ring_cluster_max_clusters(int dtype, int op, int ndir, int n,
                                   int slot_bytes, int* clusters) {
  KernelFn k = kernel_for(dtype, op, ndir);
  if (!k || n < 1 || n > kMaxCluster || slot_bytes < 16 ||
      slot_bytes > kMaxSegBytes / ndir) {
    return (int)cudaErrorInvalidValue;
  }
  cudaError_t e = prepare(k, ndir);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, n, 1, smem_bytes(ndir, slot_bytes), 0);
  *clusters = 0;
  return (int)cudaOccupancyMaxActiveClusters(clusters, (const void*)k, &cfg);
}

// One launch of `cols` clusters of n blocks on `stream`; returns the CUDA
// error of the launch. seg: elements of one slot (a multiple of 16 bytes,
// at most 18 KiB over all directions); every column and segment
// boundary a multiple of 16 bytes; x and out 16-byte aligned; err (4
// int64) zero on the stream.
int mp4j_ring_cluster_launch(int dtype, int op, int ndir, int mode, int n,
                             int cols, int seg, long long w,
                             long long stride, long long base0,
                             long long base1, long long vbase0,
                             long long vbase1, long long col_w,
                             long long in_row, long long out_row,
                             const void* x, void* out, void* err,
                             long long spin_ns, int stall_member,
                             void* stream) {
  KernelFn k = kernel_for(dtype, op, ndir);
  if (!k || n < 1 || n > kMaxCluster || cols < 1 || seg < 1 ||
      (long long)seg * kItemSize[dtype] > kMaxSegBytes / ndir ||
      ((long long)seg * kItemSize[dtype]) % 16) {
    return (int)cudaErrorInvalidValue;
  }
  Params p;
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
  p.seg = seg;
  p.stall_member = stall_member;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cluster_config(&cfg, &attr, n, cols,
                 smem_bytes(ndir, (size_t)seg * kItemSize[dtype]),
                 (cudaStream_t)stream);
  void* args[] = {&p};
  cudaError_t e = cudaLaunchKernelExC(&cfg, (const void*)k, args);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

const char* mp4j_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
