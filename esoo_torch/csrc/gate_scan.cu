// The string gate scan K3 (sm_90a, CUDA cores): the K factorized Givens
// banks of a UCC circuit on the (nB, nA) string matrix of each state,
// forward and reversible backward, one launch a direction.
//
// Replaces esoo_tpu/sim/strings.py:303 _apply_rev_str (a jax.custom_vjp
// over lax.scan) and its reversible backward _apply_rev_str_bwd (:324),
// which XLA compiles into one device loop a direction.  The port's plain
// version, esoo_torch/sim/strings.py::_ApplyRevStr, issues one gather and
// about five elementwise launches a gate forward, fifteen backward.
//
// Per gate k, with c = cos th_k and s = sin th_k computed by the caller:
//   M = bD aD^T + bR aR^T   (touched mask, 0/1)
//   S = vR uR^T - vD uD^T   (sign field, 0/+-1)
//   G = V[pB][:, pA]        (the partner permutation)
//   forward:   V' = V + (c - 1) M.V + s S.G
//   backward, gates in reverse, from the forward's output V_K and the
//   cotangent W:
//     V_{k-1}       = V_k + (c - 1) M.V_k - s S.G_k     (inverse rotation)
//     perm(V_{k-1}) = G_k + (c - 1) M.G_k + s S.V_k     (perm is an
//                     involution mapping dom <-> ran; M is even, S odd)
//     dth_k         = sum W.(-s M.V_{k-1} + c S.perm(V_{k-1}))
//     W            <- W + (c - 1) M.W - s S.W[pB][:, pA]
//
// What bounds it on an H100: not bytes and not operations but the K-step
// serial dependence.  A direction must read the factored tables once,
// K (nA + nB) (4 + 4 itemsize) bytes (two int32 partner maps, eight 0/+-1
// factors), and the states in and out: ~1.05 MB at the H8 -> 16 demo's
// K = 360, nA = nB = 70 in float32, 0.31 us at 3.35 TB/s, and ~12 (forward)
// or ~31 (backward) operations an element and gate, 26 and 55 MFLOP there.
// But gate k + 1 reads what gate k wrote, at permuted places, so the
// scan is K rounds of (gather, update, barrier) in which one state's nd
// amplitudes give the card little to do in parallel.  The design keeps
// each round to the work the gate does:
//
//   * Touched pairs only.  A UCC gate touches its domain DA x DB (a
//     product set; sim/strings.py::build_string_tables checks it) and
//     its range, the partners, and dom and ran are disjoint: at H8 -> 16
//     (nA = nB = 70) a double touches 400 or 420 pairs of the 4,900
//     elements, a single 1,400.  sim/strings.py::gate_lists compresses
//     each gate's domain into lists (its alpha and beta strings, their
//     sign factors fA, fB and partners pa, pb), and ops/gate_scan.py
//     packs them into one int32 record a gate.  Pair p of the gate is
//     d = (DB[p / |DA|], DA[p % |DA|]) and r = (pb, pa) of it; on the pair
//     M = 1 and S = -fA fB at d, +fA fB at r, so the update keeps the
//     plain version's expression (and rounding) with m = 1:
//     v + (c - 1) v + s (sigma g), sigma g a flip of g's sign bit.  A
//     thread loads two pairs at a time.  Untouched elements are never read
//     or written.
//   * In place.  Each element belongs to one pair, so no thread reads an
//     amplitude another rotates in the same gate: the forward holds one
//     state buffer (V) and the backward two (V, W).  One block a state
//     (V0 (..., nB, nA) flattened to B states), one __syncthreads() a
//     gate; thread t takes the pairs p = t, t + T, ... (T a multiple of
//     32, at most kMaxThreads).  The state stays in shared memory when its
//     buffers fit the 227 KB a block may use beside the ring (smem route:
//     to n = 9 at (4, 4), nd = 15,876, at float32 both ways); else the
//     forward works in place in the output tensor and the backward keeps
//     V in a (B, nd) scratch and W in place in w0, L2-resident (global
//     route).  ops/gate_scan.py::_plan mirrors smem_bytes and
//     block_threads and picks the route and the ring's depth.
//   * The records off the critical path: a ring of `stages` records in
//     shared memory (all K when they fit, as at H4's 26 gates), each stage
//     filled by one bulk asynchronous copy (cp.async.bulk, the 1-D TMA
//     form) that completes on the stage's mbarrier.  Thread 0 issues gate
//     k + stages into gate k's stage right after the barrier that ends
//     gate k, so the barrier never waits on a record's global latency;
//     every thread waits on the stage's mbarrier before gate k.
//   * c and s come from the caller (torch.cos/torch.sin of theta, as the
//     plain version takes them), loaded a gate ahead.  A gate at th = 0
//     (c = 1, s = 0) leaves every finite amplitude exactly as it was.
//   * dth without atomics: each thread sums its pairs' terms in pair
//     order (d, then r), each warp reduces by __shfl_down_sync (offsets
//     16 .. 1), and after the gate's barrier warp 0 reduces the warp sums
//     the same way and writes dth[b, k]; the caller sums the (B, K)
//     partials.  Two calls on the same inputs agree bit for bit.
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
constexpr int kFwdBuffers = 1;               // V, in place
constexpr int kBwdBuffers = 2;               // V and W, in place
constexpr int kMaxStages = 32;               // records in flight, at most
constexpr int kMinStages = 4;                // or all K gates when fewer
constexpr int kHeader = 8;                   // a record's header words
constexpr unsigned kSign = 0x80000000u;      // a float's sign bit

// A gate record (int32 words, `words` of them, a multiple of 4):
//   [nda, ndb, LA, LB, 1 / nda (float bits), 0, 0, 0 | DA (LA) | QA (LA) |
//    SA (LA) | DB (LB) | QB (LB) | SB (LB) | 0 ...]
// DA the domain's alpha strings (nda of them), QA = pa(DA) their
// partners, SA their sign factors fA(DA) as sign bits (0 for +1,
// kSign for -1); the same for beta.
template <typename T>
struct Scan {
  const int* rec;      // (K, words) gate records
  const T* c;          // (K,) cos th
  const T* s;          // (K,) sin th
  int K, nA, nB, words, stages;
};

__host__ __device__ inline int block_threads(int nd) {
  const int t = (nd + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// the ring (`stages` records of `words` int32), its mbarriers
// (kMaxStages x 8 bytes), the dth warp sums (2 x kMaxWarps values), then
// `bufs` state buffers of nd values (0 on the global route)
__host__ inline size_t smem_bytes(int nd, int itemsize, int bufs, int words,
                                  int stages) {
  return sizeof(int) * static_cast<size_t>(words) * stages +
         sizeof(unsigned long long) * kMaxStages +
         static_cast<size_t>(itemsize) *
             (2 * kMaxWarps + static_cast<size_t>(bufs) * nd);
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

// The ring of gate records at the start of the block's shared memory:
// step i (gate i forward, K - 1 - i backward) lives in stage i % stages
// and waits for the (i / stages)-th completion of that stage's mbarrier
// (the scan keeps the stage and its parity as it goes: no division a
// gate).  Then the mbarriers, the dth warp sums and, on the smem route,
// the state buffers (smem_bytes).
struct Ring {
  int* ring;
  unsigned long long* bars;
  const int* rec;
  int K, words, stages;
  bool reverse;
  __device__ Ring(unsigned char* smem, const int* rec_, int K_, int words_,
                  int stages_, bool reverse_)
      : ring(reinterpret_cast<int*>(smem)), rec(rec_), K(K_), words(words_),
        stages(stages_), reverse(reverse_) {
    bars = reinterpret_cast<unsigned long long*>(
        ring + static_cast<size_t>(words) * stages);
  }
  // the shared memory after the mbarriers
  __device__ unsigned char* end() const {
    return reinterpret_cast<unsigned char*>(bars + kMaxStages);
  }
  // step i's record into stage st
  __device__ void issue(int st, int i) const {
    const int k = reverse ? K - 1 - i : i;
    bulk_load(ring + static_cast<size_t>(st) * words,
              rec + static_cast<size_t>(k) * words,
              4u * static_cast<unsigned>(words), bars + st);
  }
  // thread 0: the mbarriers, then the first `stages` records in flight
  __device__ void start() const {
    if (threadIdx.x == 0) {
      for (int st = 0; st < stages; ++st) bar_init(bars + st);
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      for (int i = 0; i < stages; ++i) issue(i, i);
    }
  }
  // the record in stage st, once its mbarrier completes phase `parity`
  __device__ const int* wait(int st, unsigned parity) const {
    bar_wait(bars + st, parity);
    return ring + static_cast<size_t>(st) * words;
  }
  // thread 0, after the barrier that ends step i (in stage st): step
  // i + stages into the stage that step i freed
  __device__ void refill(int st, int i) const {
    if (threadIdx.x == 0 && i + stages < K) issue(st, i + stages);
  }
  // the next step's stage and parity
  __device__ void advance(int& st, unsigned& parity) const {
    if (++st == stages) {
      st = 0;
      parity ^= 1u;
    }
  }
};

// v (-1)^(m >> 31), m = 0 or kSign: a flip of the sign bit
__device__ __forceinline__ float flip(float v, unsigned m) {
  return __uint_as_float(__float_as_uint(v) ^ m);
}
__device__ __forceinline__ double flip(double v, unsigned m) {
  return __longlong_as_double(__double_as_longlong(v) ^
                              (static_cast<long long>(m) << 32));
}

// a record's lists
struct Lists {
  int nda, ndb;
  float rinv;
  const int *da, *qa, *sa, *db, *qb, *sb;
  __device__ explicit Lists(const int* r) {
    nda = r[0];
    ndb = r[1];
    rinv = __int_as_float(r[4]);
    const int la = r[2], lb = r[3];
    da = r + kHeader;
    qa = da + la;
    sa = qa + la;
    db = sa + la;
    qb = db + lb;
    sb = qb + lb;
  }
};

// A thread's walk over a gate's pairs p = t, t + T, ..., p = j nda + i:
// j and i from the record's float 1 / nda (exact: floor((p + 1/2) / nda)
// is at least 1 / (2 nda) from the next integer, and p < 2^22), then
// stepped without a division.
struct Walk {
  int i, j, si, sj;
  __device__ Walk(const Lists& g, int t, int nt) {
    j = __float2int_rz((static_cast<float>(t) + 0.5f) * g.rinv);
    i = t - j * g.nda;
    sj = __float2int_rz((static_cast<float>(nt) + 0.5f) * g.rinv);
    si = nt - sj * g.nda;
  }
  __device__ void next(int nda) {
    i += si;
    j += sj;
    if (i >= nda) {
      i -= nda;
      ++j;
    }
  }
};

// the walk's pair: d = (DB[j], DA[i]) and r = (QB[j], QA[i]) as flat
// indices, and m, the sign bit of fA fB (sigma at r; sigma at d is its
// negative)
struct Pair {
  int d, r;
  unsigned m;
  __device__ Pair(const Lists& g, const Walk& w, int nA)
      : d(g.db[w.j] * nA + g.da[w.i]), r(g.qb[w.j] * nA + g.qa[w.i]),
        m(static_cast<unsigned>(g.sa[w.i] ^ g.sb[w.j])) {}
};

// The gate on one pair, forward:  v + (c - 1) v + s (sigma g)
template <typename T>
__device__ __forceinline__ void fwd_pair(T* V, const Pair& q, T cm1, T s,
                                         T vd, T vr) {
  V[q.d] = vd + cm1 * vd + s * flip(vr, q.m ^ kSign);
  V[q.r] = vr + cm1 * vr + s * flip(vd, q.m);
}

// The gate on one pair, backward: V_{k-1} by the inverse rotation (at d,
// perm(V_{k-1}) is V_{k-1} at r), dth's two terms into acc (d's, then
// r's), and W <- W + (c - 1) W - s S W[partner]
template <typename T>
__device__ __forceinline__ void bwd_pair(T* V, T* W, const Pair& q, T c,
                                         T cm1, T s, T vd, T vr, T wd, T wr,
                                         T& acc) {
  const unsigned md = q.m ^ kSign;
  const T pd = vd + cm1 * vd - s * flip(vr, md);
  const T pr = vr + cm1 * vr - s * flip(vd, q.m);
  acc += wd * (-s * pd + c * flip(pr, md));
  acc += wr * (-s * pr + c * flip(pd, q.m));
  V[q.d] = pd;
  V[q.r] = pr;
  W[q.d] = wd + cm1 * wd - s * flip(wr, md);
  W[q.r] = wr + cm1 * wr - s * flip(wd, q.m);
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
gate_scan_fwd(Scan<T> sc, const T* __restrict__ v0, T* out) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nA = sc.nA, nd = nA * sc.nB, K = sc.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t off = static_cast<size_t>(blockIdx.x) * nd;
  const Ring ring(smem, sc.rec, K, sc.words, sc.stages, false);
  T* part = reinterpret_cast<T*>(ring.end());
  T* V = SMEM ? part + 2 * kMaxWarps : out + off;

  ring.start();
  for (int e = tid; e < nd; e += nt) V[e] = v0[off + e];
  T cn = __ldg(sc.c), sn = __ldg(sc.s);
  int st = 0;
  unsigned parity = 0;
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const T c = cn, s = sn, cm1 = c - T(1);
    if (k + 1 < K) {
      cn = __ldg(sc.c + k + 1);
      sn = __ldg(sc.s + k + 1);
    }
    const Lists g(ring.wait(st, parity));
    const int np = g.nda * g.ndb;
    Walk w(g, tid, nt);
    // two pairs at a time, their four loads issued together
    for (int p = tid; p < np; p += 2 * nt) {
      const Pair a(g, w, nA);
      w.next(g.nda);
      const T ad = V[a.d], ar = V[a.r];
      if (p + nt < np) {
        const Pair b(g, w, nA);
        w.next(g.nda);
        const T bd = V[b.d], br = V[b.r];
        fwd_pair(V, a, cm1, s, ad, ar);
        fwd_pair(V, b, cm1, s, bd, br);
      } else {
        fwd_pair(V, a, cm1, s, ad, ar);
      }
    }
    __syncthreads();
    ring.refill(st, k);
    ring.advance(st, parity);
  }

  if (SMEM)
    for (int e = tid; e < nd; e += nt) out[off + e] = V[e];
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
gate_scan_bwd(Scan<T> sc, const T* __restrict__ v, const T* __restrict__ ct,
              T* w0, T* dth, T* scratch) {
  extern __shared__ __align__(128) unsigned char smem[];
  const int nA = sc.nA, nd = nA * sc.nB, K = sc.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const size_t off = static_cast<size_t>(blockIdx.x) * nd;
  const Ring ring(smem, sc.rec, K, sc.words, sc.stages, true);
  T* part = reinterpret_cast<T*>(ring.end());
  T* V = SMEM ? part + 2 * kMaxWarps : scratch + off;
  T* W = SMEM ? V + nd : w0 + off;

  ring.start();
  for (int e = tid; e < nd; e += nt) {
    V[e] = v[off + e];
    W[e] = ct[off + e];
  }
  T cn = __ldg(sc.c + K - 1), sn = __ldg(sc.s + K - 1);
  int st = 0;
  unsigned parity = 0;
  __syncthreads();

  for (int step = 0; step < K; ++step) {
    const int k = K - 1 - step;
    const T c = cn, s = sn, cm1 = c - T(1);
    if (k > 0) {
      cn = __ldg(sc.c + k - 1);
      sn = __ldg(sc.s + k - 1);
    }
    const Lists g(ring.wait(st, parity));
    const int np = g.nda * g.ndb;
    Walk w(g, tid, nt);
    T acc = T(0);
    // two pairs at a time, their eight loads issued together
    for (int p = tid; p < np; p += 2 * nt) {
      const Pair a(g, w, nA);
      w.next(g.nda);
      const T avd = V[a.d], avr = V[a.r], awd = W[a.d], awr = W[a.r];
      if (p + nt < np) {
        const Pair b(g, w, nA);
        w.next(g.nda);
        const T bvd = V[b.d], bvr = V[b.r], bwd = W[b.d], bwr = W[b.r];
        bwd_pair(V, W, a, c, cm1, s, avd, avr, awd, awr, acc);
        bwd_pair(V, W, b, c, cm1, s, bvd, bvr, bwd, bwr, acc);
      } else {
        bwd_pair(V, W, a, c, cm1, s, avd, avr, awd, awr, acc);
      }
    }
    acc = warp_sum(acc);
    const int half = step & 1;
    if (lane == 0) part[half * kMaxWarps + warp] = acc;
    __syncthreads();
    ring.refill(st, step);
    ring.advance(st, parity);
    // gate k's warp sums; gate k - 1 writes the other half of `part`, and
    // gate k - 2 this half only after the next barrier
    if (warp == 0) {
      T x = lane < nwarps ? part[half * kMaxWarps + lane] : T(0);
      x = warp_sum(x);
      if (lane == 0) dth[static_cast<size_t>(blockIdx.x) * K + k] = x;
    }
  }

  if (SMEM)
    for (int e = tid; e < nd; e += nt) w0[off + e] = W[e];
}

template <typename F>
int set_smem(F kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// route 0: state in shared memory; 1: in place in the output (forward),
// V in `scratch` (B, nd) and W in w0 (backward)
template <typename T>
int check(const Scan<T>& sc, int B, int route, int bufs, size_t* smem) {
  const int least = sc.K < kMinStages ? sc.K : kMinStages;
  if (B < 1 || sc.K < 1 || sc.nA < 1 || sc.nB < 1 ||
      (route != 0 && route != 1) || sc.words < kHeader ||
      sc.words % 4 != 0 || sc.stages < least || sc.stages > kMaxStages ||
      sc.stages > sc.K)
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(sc.nA) * sc.nB * (bufs > 1 ? bufs : 1) >=
      (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(sc.nA * sc.nB, sizeof(T), route == 0 ? bufs : 0,
                     sc.words, sc.stages);
  if (*smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int scan_fwd(const Scan<T>& sc, const T* v0, T* out, int B, int route,
             cudaStream_t stream) {
  size_t smem = 0;
  int rc = check(sc, B, route, kFwdBuffers, &smem);
  if (rc != 0) return rc;
  auto kernel = route == 0 ? gate_scan_fwd<T, true> : gate_scan_fwd<T, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(sc.nA * sc.nB), smem, stream>>>(sc, v0, out);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scan_bwd(const Scan<T>& sc, const T* v, const T* ct, T* w0, T* dth,
             T* scratch, int B, int route, cudaStream_t stream) {
  size_t smem = 0;
  int rc = check(sc, B, route, kBwdBuffers, &smem);
  if (rc != 0) return rc;
  if (route == 1 && scratch == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = route == 0 ? gate_scan_bwd<T, true> : gate_scan_bwd<T, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(sc.nA * sc.nB), smem, stream>>>(sc, v, ct, w0,
                                                            dth, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Scan<T> scan(const void* rec, const void* c, const void* s, int K, int nA,
             int nB, int words, int stages) {
  return {static_cast<const int*>(rec), static_cast<const T*>(c),
          static_cast<const T*>(s), K, nA, nB, words, stages};
}

}  // namespace

#define ESOO_SCAN_ARGS const void *rec, const void *c, const void *s
#define ESOO_SCAN_INTS int B, int K, int nA, int nB, int words, int stages, \
                       int route, void *stream

#define ESOO_GATE_SCAN(TAG, T)                                               \
  extern "C" int esoo_gate_scan_fwd_##TAG(ESOO_SCAN_ARGS, const void* v0,    \
                                          void* out, ESOO_SCAN_INTS) {       \
    return scan_fwd<T>(scan<T>(rec, c, s, K, nA, nB, words, stages),         \
                       static_cast<const T*>(v0), static_cast<T*>(out), B,   \
                       route, static_cast<cudaStream_t>(stream));            \
  }                                                                          \
  extern "C" int esoo_gate_scan_bwd_##TAG(                                   \
      ESOO_SCAN_ARGS, const void* v, const void* ct, void* w0, void* dth,    \
      void* scratch, ESOO_SCAN_INTS) {                                       \
    return scan_bwd<T>(scan<T>(rec, c, s, K, nA, nB, words, stages),         \
                       static_cast<const T*>(v), static_cast<const T*>(ct),  \
                       static_cast<T*>(w0), static_cast<T*>(dth),            \
                       static_cast<T*>(scratch), B, route,                   \
                       static_cast<cudaStream_t>(stream));                   \
  }

ESOO_GATE_SCAN(f32, float)
ESOO_GATE_SCAN(f64, double)

// The kernel's own shared-memory bytes and block size, for the host
// mirror's test (ops/gate_scan.py::_plan)
extern "C" long long esoo_gate_scan_smem_bytes(int nd, int itemsize,
                                               int bufs, int words,
                                               int stages) {
  return static_cast<long long>(
      smem_bytes(nd, itemsize, bufs, words, stages));
}

extern "C" int esoo_gate_scan_threads(int nd) { return block_threads(nd); }
