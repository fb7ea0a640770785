// The pairs gate scan (sm_90a, CUDA cores): the K Givens-bank gates of a
// UCC circuit on the (nd + 1,) padded determinant amplitudes of each
// state, forward and reversible backward, one launch a direction.
//
// Replaces esoo_tpu/sim/sector.py:141 _apply_rev (a jax.custom_vjp over
// :129 _apply_gates_tabled, a lax.scan) and its reversible backward
// _apply_rev_bwd (:161), which XLA compiles into one device loop a
// direction.  The port's plain version, esoo_torch/sim/sector.py::
// _ApplyRev, issues a gather, a product and an addcmul a gate forward,
// two gathers, four addcmuls and a dot backward.
//
// Per gate k, with c = cos th_k and s = sin th_k computed by the caller,
// P = PARTNER[k] (an involution; identity where the gate does not act and
// at the pad) and S = SFIELD[k] (0 or +-1; |S| even and S odd under P):
//   ce = 1 + (c - 1) |S|,  sf = S s
//   forward:   v'[i] = ce v[i] + sf v[P[i]]
//   backward, gates in reverse, from the forward's output v_K and the
//   cotangent w:
//     v_{k-1}[i]       = ce v_k[i] - sf v_k[P[i]]      (inverse rotation)
//     v_{k-1}[P[i]]    = ce v_k[P[i]] + sf v_k[i]
//     dth_k            = sum_i w[i] (-s |S| v_{k-1}[i] + S c v_{k-1}[P[i]])
//     w[i]            <- ce w[i] - sf w[P[i]]
//
// What bounds it on an H100: not bytes and not operations but the K-step
// serial dependence.  A direction must read the pair records once (8
// bytes a pair), the offsets, c and s, and the states in and out (~20 KB
// at the H8 -> 12 path's K = 92, 2,164 pairs, nd + 1 = 226 in float32,
// 6 ns at 3.35 TB/s) and needs 3 (forward) or 10 (backward)
// floating-point operations a gate and touched amplitude.  But gate k + 1
// reads what gate k wrote, at permuted places, so the scan is K rounds of
// (gather, update, barrier) in which one state's amplitudes give the card
// little to do in parallel.  The design keeps each round to the work the
// gate does:
//
//   * Touched pairs only.  About a fifth of the amplitudes are touched by
//     a gate (H8 -> 12: 15 to 60 pairs of the 226 amplitudes; H8 -> 16:
//     400 to 1,400 of 4,901).  ops/pair_scan.py derives each gate's pairs
//     from PARTNER and SFIELD once per tables dict (i < P[i], S[i] != 0)
//     and packs them, in gate order and ascending i, into one stream of
//     8-byte records (lo = i, hi = P[i] with the sign bit set when S[lo] =
//     -1) with the (K + 1,) gate offsets.  On the pair, S = sigma at lo
//     and -sigma at hi, so the update keeps the plain version's expression
//     (and rounding) with |S| = 1: ce v + (sigma s) v[partner], sigma s a
//     flip of s's sign bit.  A thread loads two pairs at a time.
//     Untouched amplitudes are never read or written.
//   * In place.  P is an involution and a gate's pairs are disjoint, so
//     one thread owns a pair and rotates both ends: the forward holds one
//     state buffer (v) and the backward two (v, w).  One block a state,
//     one barrier a gate; thread t takes the pairs p = t, t + T, ... of the
//     gate, T from the largest gate (its pair count rounded up to a warp,
//     at most kMaxThreads; one warp, and __syncwarp() for the barrier,
//     when no gate has more than kOneWarpPairs pairs).  The state stays
//     in shared memory when its buffers fit beside the ring (smem route:
//     to n = 9 at (4, 4), nd + 1 = 15,877, at float32 both ways and at
//     float64 forward); else the forward works in place in the output
//     tensor and the backward keeps v in a (B, nd + 1) scratch and w in
//     place in w0, L2-resident (global route).  ops/pair_scan.py::_plan
//     mirrors smem_bytes and block_threads and picks the route and ring.
//   * The stream off the critical path: a ring of `stages` chunks of
//     2^log_chunk records in shared memory (stages a power of two), each
//     chunk filled by one bulk asynchronous copy (cp.async.bulk, the 1-D
//     TMA form) that completes on its stage's mbarrier.  A gate may span
//     chunks and a chunk gates; the plan makes the ring hold at least the
//     widest gate's span.  When the whole stream fits, every chunk is
//     issued at the start (H8 -> 12); else thread 0, after the barrier
//     that ends a gate, refills every stage whose chunk lies wholly
//     before the next gate's first record, so the next gates' records
//     land while this gate runs.  Every thread waits on each chunk's
//     mbarrier, in order, before the first gate that reads it.  The
//     backward takes the chunks in reverse.
//   * c and s come from the caller (torch.cos/torch.sin of theta, as the
//     plain version takes them) and are staged in shared memory with the
//     gate offsets at the start (a load of either from device memory a
//     gate ahead paced the H8 -> 12 scan: its gates are shorter than the
//     load).  ce = 1 + (c - 1), as the plain version forms it.  A gate at
//     th = 0 (c = 1, s = 0) leaves every finite amplitude exactly as it
//     was.
//   * dth without atomics: each thread sums its pairs' terms in pair
//     order (lo's, then hi's: the order of the string gate scan), each warp
//     reduces by __shfl_down_sync (offsets 16 .. 1), and after the gate's
//     barrier warp 0 reduces the warp sums the same way and writes dth[b,
//     k]; the caller sums the (B, K) partials.  Two calls on the same
//     inputs agree bit for bit.
//   * FFMA on the CUDA cores in the element type (float or double).
//
// C interface (ctypes): launches on the given stream, allocates nothing,
// returns cudaGetLastError() (or cudaErrorInvalidValue for arguments the
// kernel does not take).

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxWarps = kMaxThreads / 32;
constexpr size_t kMaxSmem = 232448;          // 227 KB a block may use
constexpr int kFwdBuffers = 1;               // v, in place
constexpr int kBwdBuffers = 2;               // v and w, in place
constexpr int kMaxStages = 32;               // ring stages, at most
constexpr int kMinLogChunk = 9;              // a chunk: 2^9 .. 2^12 records
constexpr int kMaxLogChunk = 12;
constexpr int kOneWarpPairs = 64;            // one warp up to this gate size
constexpr unsigned kSign = 0x80000000u;      // a float's sign bit

// The stream: record p = (lo, hi | sign bit) of pair p, gate k's records
// at [off[k], off[k + 1]), chunks << log_chunk records in all (zero past
// off[K]).
template <typename T>
struct Scan {
  const int2* rec;     // the pair records
  const int* off;      // (K + 1,) gate offsets
  const T* c;          // (K,) cos th
  const T* s;          // (K,) sin th
  int K, n, log_chunk, chunks, stages;
};

__host__ __device__ inline int block_threads(int max_pairs) {
  if (max_pairs <= kOneWarpPairs) return 32;
  const int t = (max_pairs + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// the gate table: c and s (K values each) and the offsets (K + 1 int),
// rounded up to 16 bytes
__host__ __device__ inline size_t gate_bytes(int K, int itemsize) {
  return (static_cast<size_t>(K) * (2 * itemsize + sizeof(int)) +
          sizeof(int) + 15) / 16 * 16;
}

// the ring (`stages` chunks of 2^log_chunk 8-byte records), its mbarriers
// (kMaxStages x 8 bytes), the gate table of K gates, the dth warp sums
// (2 x kMaxWarps values), then `bufs` state buffers of n values (0 on
// the global route)
__host__ inline size_t smem_bytes(int n, int itemsize, int bufs,
                                  int log_chunk, int stages, int K) {
  return (static_cast<size_t>(stages) << log_chunk) * sizeof(int2) +
         sizeof(unsigned long long) * kMaxStages + gate_bytes(K, itemsize) +
         static_cast<size_t>(itemsize) *
             (2 * kMaxWarps + static_cast<size_t>(bufs) * n);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void bar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(1) : "memory");
}

__device__ __forceinline__ void bar_wait(unsigned long long* bar,
                                         unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// one bulk copy of `bytes` (a multiple of 16, both addresses 16-byte
// aligned) that completes on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// the block's barrier: one warp syncs alone
__device__ __forceinline__ void block_sync(int nt) {
  if (nt == 32)
    __syncwarp();
  else
    __syncthreads();
}

// The ring of record chunks at the start of the block's shared memory.
// Chunks are taken in sequence q = 0, 1, ... (chunk q forward, chunk
// chunks - 1 - q backward); chunk q lives in stage q % stages and is the
// (q / stages)-th completion of that stage's mbarrier.  Then the
// mbarriers, the dth warp sums and, on the smem route, the state buffers
// (smem_bytes).
template <typename T>
struct Ring {
  int2* ring;
  unsigned long long* bars;
  const int2* rec;
  int log_chunk, chunks, stages;
  bool reverse;
  __device__ Ring(unsigned char* smem, const Scan<T>& sc, bool reverse_)
      : ring(reinterpret_cast<int2*>(smem)), rec(sc.rec),
        log_chunk(sc.log_chunk), chunks(sc.chunks), stages(sc.stages),
        reverse(reverse_) {
    bars = reinterpret_cast<unsigned long long*>(
        ring + (static_cast<size_t>(stages) << log_chunk));
  }
  // the shared memory after the mbarriers
  __device__ unsigned char* end() const {
    return reinterpret_cast<unsigned char*>(bars + kMaxStages);
  }
  // the sequence number of the chunk that holds record `pos`
  __device__ __forceinline__ int seq(int pos) const {
    const int c = pos >> log_chunk;
    return reverse ? chunks - 1 - c : c;
  }
  __device__ __forceinline__ void issue(int q) const {
    const int st = q & (stages - 1);
    const int c = reverse ? chunks - 1 - q : q;
    bulk_load(ring + (static_cast<size_t>(st) << log_chunk),
              rec + (static_cast<size_t>(c) << log_chunk),
              static_cast<unsigned>(sizeof(int2)) << log_chunk, bars + st);
  }
  // thread 0: the mbarriers, then the first `stages` chunks in flight;
  // returns the next sequence number to issue
  __device__ int start() const {
    const int first = stages < chunks ? stages : chunks;
    if (threadIdx.x == 0) {
      for (int st = 0; st < stages; ++st) bar_init(bars + st);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int q = 0; q < first; ++q) issue(q);
    }
    return first;
  }
  // every thread: wait for the chunks after `ready` up to `last`;
  // returns the last chunk waited for
  __device__ __forceinline__ int await(int ready, int last) const {
    for (int q = ready + 1; q <= last; ++q)
      bar_wait(bars + (q & (stages - 1)), (q & stages) ? 1u : 0u);
    return last > ready ? last : ready;
  }
  // record `pos`, resident
  __device__ __forceinline__ int2 at(int pos) const {
    const int st = seq(pos) & (stages - 1);
    return ring[(static_cast<size_t>(st) << log_chunk) |
                (pos & ((1 << log_chunk) - 1))];
  }
  // thread 0, after the barrier that ends a gate: every chunk before
  // `need` (the sequence number of the next record to be read, or
  // `chunks` when none is) is free; keep `stages` chunks from `need` in
  // flight
  __device__ __forceinline__ int refill(int issued, int need) const {
    const int stop = need + stages < chunks ? need + stages : chunks;
    for (; issued < stop; ++issued) issue(issued);
    return issued;
  }
};

// The gate table after the ring's mbarriers: each gate's c, s and first
// record, staged once by the block's own loads (the per-call c and s are
// no 16-byte multiple), so a gate reads them from shared memory, not
// from device memory a gate ahead.
template <typename T>
struct Gates {
  T* c;
  T* s;
  int* off;
  unsigned char* end;            // the dth warp sums start here
  __device__ Gates(unsigned char* base, int K) {
    c = reinterpret_cast<T*>(base);
    s = c + K;
    off = reinterpret_cast<int*>(s + K);
    end = base + gate_bytes(K, sizeof(T));
  }
  __device__ void stage(const Scan<T>& sc, int tid, int nt) const {
    for (int i = tid; i < sc.K; i += nt) {
      c[i] = sc.c[i];
      s[i] = sc.s[i];
    }
    for (int i = tid; i <= sc.K; i += nt) off[i] = sc.off[i];
  }
};

// a record: the pair's ends and m, the sign bit of sigma = S[lo]
struct Pair {
  int lo, hi;
  unsigned m;
  __device__ explicit Pair(int2 r)
      : lo(r.x), hi(r.y & 0x7fffffff),
        m(static_cast<unsigned>(r.y) & kSign) {}
};

// v (-1)^(m >> 31), m = 0 or kSign: a flip of the sign bit
__device__ __forceinline__ float flip(float v, unsigned m) {
  return __uint_as_float(__float_as_uint(v) ^ m);
}
__device__ __forceinline__ double flip(double v, unsigned m) {
  return __longlong_as_double(__double_as_longlong(v) ^
                              (static_cast<long long>(m) << 32));
}

// The gate on one pair, forward: ce v + (S s) v[partner], S = sigma at
// lo and -sigma at hi
template <typename T>
__device__ __forceinline__ void fwd_pair(T* V, const Pair& q, T ce, T s,
                                         T vl, T vh) {
  const T sf = flip(s, q.m);
  V[q.lo] = ce * vl + sf * vh;
  V[q.hi] = ce * vh - sf * vl;
}

// The gate on one pair, backward: v_{k-1} by the inverse rotation, dth's
// two terms into acc (lo's, then hi's), and w <- ce w - (S s) w[partner]
template <typename T>
__device__ __forceinline__ void bwd_pair(T* V, T* W, const Pair& q, T ce,
                                         T c, T s, T vl, T vh, T wl, T wh,
                                         T& acc) {
  const T sf = flip(s, q.m), cf = flip(c, q.m);
  const T pl = ce * vl - sf * vh;
  const T ph = ce * vh + sf * vl;
  acc += wl * (-s * pl + cf * ph);
  acc += wh * (-s * ph - cf * pl);
  V[q.lo] = pl;
  V[q.hi] = ph;
  W[q.lo] = ce * wl - sf * wh;
  W[q.hi] = ce * wh + sf * wl;
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
pair_scan_fwd(Scan<T> sc, const T* __restrict__ v0, T* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = sc.n, K = sc.K, tid = threadIdx.x, nt = blockDim.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const Ring<T> ring(smem, sc, false);
  const Gates<T> g(ring.end(), K);
  T* V = SMEM ? reinterpret_cast<T*>(g.end) + 2 * kMaxWarps : out + off;

  // a stream that fits is issued whole at the start, never refilled
  const bool refills = sc.chunks > sc.stages;
  int issued = ring.start(), ready = -1;
  g.stage(sc, tid, nt);
  for (int i = tid; i < n; i += nt) V[i] = v0[off + i];
  block_sync(nt);
  const int total = g.off[K];

  for (int k = 0; k < K; ++k) {
    const T c = g.c[k], s = g.s[k], ce = T(1) + (c - T(1));
    const int a = g.off[k], b = g.off[k + 1];
    if (b > a) ready = ring.await(ready, ring.seq(b - 1));
    // two pairs at a time, their four loads issued together
    for (int p = a + tid; p < b; p += 2 * nt) {
      const Pair x(ring.at(p));
      const T xl = V[x.lo], xh = V[x.hi];
      if (p + nt < b) {
        const Pair y(ring.at(p + nt));
        const T yl = V[y.lo], yh = V[y.hi];
        fwd_pair(V, x, ce, s, xl, xh);
        fwd_pair(V, y, ce, s, yl, yh);
      } else {
        fwd_pair(V, x, ce, s, xl, xh);
      }
    }
    block_sync(nt);
    if (refills && tid == 0)
      issued = ring.refill(issued, b < total ? ring.seq(b) : sc.chunks);
  }

  ring.await(ready, sc.chunks - 1);     // no copy in flight at the exit
  if (SMEM)
    for (int i = tid; i < n; i += nt) out[off + i] = V[i];
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
pair_scan_bwd(Scan<T> sc, const T* __restrict__ v, const T* __restrict__ ct,
              T* w0, T* dth, T* scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int n = sc.n, K = sc.K, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;
  const Ring<T> ring(smem, sc, true);
  const Gates<T> g(ring.end(), K);
  T* part = reinterpret_cast<T*>(g.end);
  T* V = SMEM ? part + 2 * kMaxWarps : scratch + off;
  T* W = SMEM ? V + n : w0 + off;

  const bool refills = sc.chunks > sc.stages;
  int issued = ring.start(), ready = -1;
  g.stage(sc, tid, nt);
  for (int i = tid; i < n; i += nt) {
    V[i] = v[off + i];
    W[i] = ct[off + i];
  }
  block_sync(nt);

  for (int step = 0; step < K; ++step) {
    const int k = K - 1 - step;
    const T c = g.c[k], s = g.s[k], ce = T(1) + (c - T(1));
    const int a = g.off[k], b = g.off[k + 1];
    if (b > a) ready = ring.await(ready, ring.seq(a));
    T acc = T(0);
    // two pairs at a time, their eight loads issued together
    for (int p = a + tid; p < b; p += 2 * nt) {
      const Pair x(ring.at(p));
      const T xvl = V[x.lo], xvh = V[x.hi], xwl = W[x.lo], xwh = W[x.hi];
      if (p + nt < b) {
        const Pair y(ring.at(p + nt));
        const T yvl = V[y.lo], yvh = V[y.hi], ywl = W[y.lo], ywh = W[y.hi];
        bwd_pair(V, W, x, ce, c, s, xvl, xvh, xwl, xwh, acc);
        bwd_pair(V, W, y, ce, c, s, yvl, yvh, ywl, ywh, acc);
      } else {
        bwd_pair(V, W, x, ce, c, s, xvl, xvh, xwl, xwh, acc);
      }
    }
    acc = warp_sum(acc);
    const size_t at = static_cast<size_t>(blockIdx.x) * K + k;
    if (nt == 32) {
      __syncwarp();
      if (refills && tid == 0)
        issued = ring.refill(issued, a > 0 ? ring.seq(a - 1) : sc.chunks);
      if (tid == 0) dth[at] = acc;
      continue;
    }
    const int half = step & 1;
    if (lane == 0) part[half * kMaxWarps + warp] = acc;
    __syncthreads();
    if (refills && tid == 0)
      issued = ring.refill(issued, a > 0 ? ring.seq(a - 1) : sc.chunks);
    // gate k's warp sums; gate k - 1 writes the other half of `part`, and
    // gate k - 2 this half only after the next barrier
    if (warp == 0) {
      T x = lane < nwarps ? part[half * kMaxWarps + lane] : T(0);
      x = warp_sum(x);
      if (lane == 0) dth[at] = x;
    }
  }

  ring.await(ready, sc.chunks - 1);
  if (SMEM)
    for (int i = tid; i < n; i += nt) w0[off + i] = W[i];
}

template <typename F>
int set_smem(F kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// route 0: state in shared memory; 1: in place in the output (forward),
// v in `scratch` (B, n) and w in w0 (backward).  The plan's ring holds
// the widest gate's chunks (not checked here: the offsets are on the
// device).
template <typename T>
int check(const Scan<T>& sc, int B, int route, int bufs, int threads,
          size_t* smem) {
  if (B < 1 || sc.K < 1 || sc.n < 1 || (route != 0 && route != 1) ||
      threads < 32 || threads > kMaxThreads || threads % 32 != 0 ||
      sc.log_chunk < kMinLogChunk || sc.log_chunk > kMaxLogChunk ||
      sc.chunks < 1 || sc.stages < 1 || sc.stages > kMaxStages ||
      (sc.stages & (sc.stages - 1)) != 0 ||
      (static_cast<long long>(sc.chunks) << sc.log_chunk) >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(sc.n) * bufs >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(sc.n, sizeof(T), route == 0 ? bufs : 0, sc.log_chunk,
                     sc.stages, sc.K);
  if (*smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int scan_fwd(const Scan<T>& sc, const T* v0, T* out, int B, int route,
             int threads, cudaStream_t stream) {
  size_t smem = 0;
  int rc = check(sc, B, route, kFwdBuffers, threads, &smem);
  if (rc != 0) return rc;
  auto kernel = route == 0 ? pair_scan_fwd<T, true> : pair_scan_fwd<T, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, threads, smem, stream>>>(sc, v0, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scan_bwd(const Scan<T>& sc, const T* v, const T* ct, T* w0, T* dth,
             T* scratch, int B, int route, int threads, cudaStream_t stream) {
  size_t smem = 0;
  int rc = check(sc, B, route, kBwdBuffers, threads, &smem);
  if (rc != 0) return rc;
  if (route == 1 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = route == 0 ? pair_scan_bwd<T, true> : pair_scan_bwd<T, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, threads, smem, stream>>>(sc, v, ct, w0, dth, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Scan<T> scan(const void* rec, const void* off, const void* c, const void* s,
             int K, int n, int log_chunk, int chunks, int stages) {
  return {static_cast<const int2*>(rec), static_cast<const int*>(off),
          static_cast<const T*>(c), static_cast<const T*>(s), K, n,
          log_chunk, chunks, stages};
}

}  // namespace

#define ESOO_SCAN_ARGS const void *rec, const void *off, const void *c, \
                       const void *s
#define ESOO_SCAN_INTS int B, int K, int n, int log_chunk, int chunks, \
                       int stages, int route, int threads, void *stream

#define ESOO_PAIR_SCAN(TAG, T)                                               \
  extern "C" int esoo_pair_scan_fwd_##TAG(ESOO_SCAN_ARGS, const void* v0,    \
                                          void* out, ESOO_SCAN_INTS) {       \
    return scan_fwd<T>(scan<T>(rec, off, c, s, K, n, log_chunk, chunks,      \
                               stages),                                      \
                       static_cast<const T*>(v0), static_cast<T*>(out), B,   \
                       route, threads, static_cast<cudaStream_t>(stream));   \
  }                                                                          \
  extern "C" int esoo_pair_scan_bwd_##TAG(                                   \
      ESOO_SCAN_ARGS, const void* v, const void* ct, void* w0, void* dth,    \
      void* scratch, ESOO_SCAN_INTS) {                                       \
    return scan_bwd<T>(scan<T>(rec, off, c, s, K, n, log_chunk, chunks,      \
                               stages),                                      \
                       static_cast<const T*>(v), static_cast<const T*>(ct),  \
                       static_cast<T*>(w0), static_cast<T*>(dth),            \
                       static_cast<T*>(scratch), B, route, threads,          \
                       static_cast<cudaStream_t>(stream));                   \
  }

ESOO_PAIR_SCAN(f32, float)
ESOO_PAIR_SCAN(f64, double)

// The kernel's own shared-memory bytes and block size, for the host
// mirror's test (ops/pair_scan.py::_plan)
extern "C" long long esoo_pair_scan_smem_bytes(int n, int itemsize, int bufs,
                                               int log_chunk, int stages,
                                               int K) {
  return static_cast<long long>(
      smem_bytes(n, itemsize, bufs, log_chunk, stages, K));
}

extern "C" int esoo_pair_scan_threads(int max_pairs) {
  return block_threads(max_pairs);
}
