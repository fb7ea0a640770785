// The full-space Pauli-rotation scan K8 (sm_90a, CUDA cores): a run of K
// Pauli rotations on the 2^N amplitudes of each state, forward and
// reverse mode, one launch a direction.
//
// Replaces esoo_tpu/sim/statevector.py:287 _apply_prot_scan (a lax.scan
// over :256 _scan_gates, in sqrt(K) jax.checkpoint chunks past
// _REMAT_RESIDUAL_BUDGET elements), which XLA compiles into one device
// loop a direction.  The port's plain version,
// esoo_torch/sim/statevector.py::_ProtScan, issues a flip, a product and
// an addcmul a rotation forward, more backward, and reads a (K, 2^N)
// sign table.
//
// Per rotation k, with c = cos(a_k / 2) and s = sin(a_k / 2) computed by
// the caller, x = x_k, z = z_k the rotation's bit masks and f = f_k its
// factor (+-1 on a real state, the UCC case with an odd Y count;
// -i * i^y_k, one of +-1, +-i, on a complex one):
//   FS(e)  = f * (-1)^popcount((e ^ x) & z)
//   s'[e]  = c s[e] + s FS(e) s[e ^ x]
// and in reverse mode, from gate k's input state s_k and the cotangent W
// of its output:
//   dang_k = (c Re<W, FS . P s_k> - s Re<W, s_k>) / 2
//   W[e]  <- c W[e] + s conj(FS(e ^ x)) W[e ^ x]
// (P the permutation e -> e ^ x, FS(e ^ x) = f (-1)^popcount(e & z)).
//
// What bounds it on an H100: not bytes and not operations but the serial
// dependence.  A direction must read the K masks, factors, c and s and
// the states in and out: ~51 KB at the H8 -> 12 path's K = 640, 4,096
// amplitudes in float32, 15 ns at 3.35 TB/s.  It needs 3 (forward) or 7
// (backward) floating-point operations an amplitude and rotation on a
// real state (6 and 14 complex; an FMA counts two, the factor's and the
// sign's products are sign flips and swaps, and s f, c and the 1/2 of
// dang apply once a rotation), 7.9 and 18.4 MFLOP there: 0.12 and 0.27 us
// at 67 TFLOP/s.  But a rotation reads what the one before wrote, at
// permuted places, so the scan is rounds of (gather, update, barrier) in
// which one state's 2^N amplitudes give the card little to do in
// parallel.  The design cuts the rounds:
//
//   * Groups.  Under Jordan-Wigner the 2 or 8 Pauli strings of one UCC
//     excitation share their X mask, and come one after the other.  The
//     host (ops/prot_scan.py::group_offsets) cuts the run into groups:
//     maximal runs of consecutive rotations with equal x, at most
//     kMaxGroup long, never reordered (92 groups for the 640 rotations at
//     H8 -> 12, 360 for 2,688 at H8 -> 16; random strings give groups of
//     one).  Within a group the pair {e, e ^ x} is closed, so a thread
//     that owns it loads both amplitudes once, applies the group's
//     rotations in order in registers (the arithmetic and order of one
//     rotation at a time) and stores both once: one barrier a group, not
//     a rotation.  Thread t takes the pairs q = t, t + T, ... of the
//     2^(N-1), e being q with a 0 inserted at x's highest set bit (x = 0,
//     a diagonal rotation, pairs e with e ^ 1 and rotates each alone).
//   * In place, one buffer.  No other thread touches a pair during its
//     group, so the state is one buffer: in shared memory while it fits
//     the 227 KB a block may use (smem route: real float32 to N = 15,
//     float64 and complex64 to N = 14, complex128 to N = 13), else the
//     output tensor itself, L2-resident (global route: 256 KB a state at
//     N = 16 in float32, read and written once a group).  The block copies
//     the input in first (and the result out last on the smem route), so
//     every group reads and writes through one pointer of one address
//     space.
//   * The rotations staged once, as the pair update uses them: up to
//     `window` rotations are copied into shared memory by the block at
//     the start (again, at a group boundary, only when the run is longer
//     than the window), each as its z mask, c, s and the factors of the
//     pair's two amplitudes with s folded in (Window below), so a
//     rotation costs a thread one popcount and two FMAs a real pair.  A
//     group's end and mask are loaded while the group before it runs, and
//     nothing on a group's path divides.  One block a state (B blocks); T
//     a multiple of 32, at most kMaxThreads; a thread rotates up to
//     kPassPairs pairs at a time, as many as it owns, their dependence
//     chains interleaved.
//   * Reverse mode keeps the JAX package's residuals: the forward, when a
//     gradient is needed, writes the input state of every `stride`-th
//     group to `ckpt` (B, ceil(G / stride), 2^N): every group while G
//     times the states' size is within _REMAT_RESIDUAL_BUDGET, else
//     isqrt(G).  The backward takes the chunks of `stride` groups last to
//     first: it re-runs a chunk's groups from its checkpoint into `rec`
//     (B, stride - 1, 2^N), then, group by group in reverse, each thread
//     rebuilds each rotation's input pair in registers by re-applying the
//     group's rotations to the group's input pair (the forward's bits; no
//     inverse rotation), and runs the adjoint through the group's
//     rotations in reverse on its (W_e, W_{e^x}) pair, W in place (shared
//     memory or the w0 tensor, the forward's route), kAdjointPairs pairs
//     at a time; the next group's first input pair is loaded while a
//     group runs.
//   * dang without atomics, as (c S1 - s S2) / 2 of the two inner
//     products S1 = Re<W, FS . P s_k>, S2 = Re<W, s_k>: each thread sums,
//     for each rotation of the group, its pairs' terms in pair order
//     (amplitude e, then its mate); each warp reduces each by
//     __shfl_down_sync (offsets 16 .. 1), and after the group's barrier
//     warp r reduces rotation r's warp sums the same way and writes
//     dang[b, k] (the caller sums the (B, K) partials).  Two calls on the
//     same inputs agree bit for bit.
//   * A rotation at a = 0 (c = 1, s = 0) leaves every finite amplitude
//     exactly as it was.
//   * FFMA on the CUDA cores in the real type (float or double); a
//     complex amplitude is a (re, im) pair, and its factor's products are
//     exact (f is +-1 or +-i).
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
constexpr int kBuffers = 1;                  // the state or W, in place
constexpr int kMaxGroup = 8;                 // rotations a group, at most
constexpr int kSmemPairs = 4;                // pairs a thread holds at once
constexpr int kGlobalPairs = 8;              // ... on the global route
constexpr int kMaxDim = 1 << 30;             // 32-bit amplitude indices

template <typename R>
struct alignas(2 * sizeof(R)) Cx {
  R re, im;
};

// pairs a thread runs through a group's adjoint at a time: two at
// float32, else one (a pair holds 2 x kMaxGroup amplitudes and the group's
// 2 x kMaxGroup sums in registers; more spill past the 128 registers a
// thread of 512 may use)
template <typename A>
constexpr int kAdjointPairs = sizeof(A) == 4 ? 2 : 1;

// pairs a thread holds at once in a group's forward pass: kSmemPairs on
// the smem route, kGlobalPairs (more loads in flight) on the global
// route, half that for complex128
template <typename A, bool SMEM>
constexpr int kPassPairs =
    SMEM ? kSmemPairs : (sizeof(A) <= 8 ? kGlobalPairs : kGlobalPairs / 2);

// the element operations, real and complex

// v (-1)^(m >> 31), m = 0 or 0x80000000: a flip of the sign bit(s)
__device__ __forceinline__ float flip(float v, unsigned m) {
  return __uint_as_float(__float_as_uint(v) ^ m);
}
__device__ __forceinline__ double flip(double v, unsigned m) {
  return __longlong_as_double(__double_as_longlong(v) ^
                              (static_cast<long long>(m) << 32));
}
template <typename R>
__device__ __forceinline__ Cx<R> flip(Cx<R> v, unsigned m) {
  return {flip(v.re, m), flip(v.im, m)};
}

// k u (k = +-1 or +-i, times s or not)
template <typename R>
__device__ __forceinline__ R kmul(R k, R u) { return k * u; }
template <typename R>
__device__ __forceinline__ Cx<R> kmul(Cx<R> k, Cx<R> u) {
  return {k.re * u.re - k.im * u.im, k.re * u.im + k.im * u.re};
}

// s u, s real (exact on +-1, +-i)
template <typename R>
__device__ __forceinline__ Cx<R> kmul(R s, Cx<R> u) {
  return {s * u.re, s * u.im};
}

// c v + k u
template <typename R>
__device__ __forceinline__ R upd(R c, R v, R k, R u) { return c * v + k * u; }
template <typename R>
__device__ __forceinline__ Cx<R> upd(R c, Cx<R> v, Cx<R> k, Cx<R> u) {
  return {c * v.re + k.re * u.re - k.im * u.im,
          c * v.im + k.re * u.im + k.im * u.re};
}

// c v + conj(k) u
template <typename R>
__device__ __forceinline__ R cupd(R c, R v, R k, R u) { return c * v + k * u; }
template <typename R>
__device__ __forceinline__ Cx<R> cupd(R c, Cx<R> v, Cx<R> k, Cx<R> u) {
  return {c * v.re + k.re * u.re + k.im * u.im,
          c * v.im + k.re * u.im - k.im * u.re};
}

// Re(conj(w) u)
template <typename R>
__device__ __forceinline__ R redot(R w, R u) { return w * u; }
template <typename R>
__device__ __forceinline__ R redot(Cx<R> w, Cx<R> u) {
  return w.re * u.re + w.im * u.im;
}

template <typename R>
__device__ __forceinline__ R load(const R* p) { return __ldg(p); }
template <typename R>
__device__ __forceinline__ Cx<R> load(const Cx<R>* p) {
  return {__ldg(&p->re), __ldg(&p->im)};
}

// The run's per-rotation data: (K,) int64 masks, (K,) factor (the
// amplitude type), (K,) c, s (the real type), and the (G + 1,) int32
// offsets of its groups.
template <typename A, typename R>
struct Gates {
  const long long* x;
  const long long* z;
  const A* f;
  const R* c;
  const R* s;
  const int* off;
  int K, G;
};

template <typename R>
__device__ __forceinline__ R warp_sum(R x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// One halving exchange of the warp's sums: at offset O the lane keeps the
// half of its first 2 M values that its bit O selects and adds its
// partner's copy of that half.
template <int O, int M, typename R>
__device__ __forceinline__ void halve(R (&v)[2 * kMaxGroup], int lane) {
  const bool up = lane & O;
#pragma unroll
  for (int i = 0; i < M; ++i) {
    const R keep = up ? v[i + M] : v[i];
    const R send = up ? v[i] : v[i + M];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

// The warp's sums of the 2 kMaxGroup values v[j] = (s1[j / 2], s2[j / 2])
// at once, by halving exchanges at offsets 16, 8, 4 and 2, then 1 (16
// shuffles, not 16 x 5): afterwards lanes 2j and 2j + 1 hold the sum of
// v[j] over the warp's 32 lanes, in a fixed order.
template <typename R>
__device__ __forceinline__ R warp_sums(const R (&s1)[kMaxGroup],
                                       const R (&s2)[kMaxGroup], int lane) {
  static_assert(kMaxGroup == 8, "the exchanges halve 16 values to one");
  R v[2 * kMaxGroup];
#pragma unroll
  for (int r = 0; r < kMaxGroup; ++r) {
    v[2 * r] = s1[r];
    v[2 * r + 1] = s2[r];
  }
  halve<16, 8>(v, lane);
  halve<8, 4>(v, lane);
  halve<4, 2>(v, lane);
  halve<2, 1>(v, lane);
  return v[0] + __shfl_xor_sync(0xffffffffu, v[0], 1);
}

// one thread a pair of amplitudes, as a multiple of a warp
__host__ __device__ inline int block_threads(int dim) {
  const int half = dim / 2;
  const int t = (half + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// the dang warp sums: 2 (group parity) x kMaxGroup x 2 (the two inner
// products) x kMaxWarps slots of 8 bytes
constexpr int kPartSlots = 2 * kMaxGroup * 2 * kMaxWarps;

__host__ __device__ constexpr size_t round16(size_t n) {
  return (n + 15) / 16 * 16;
}

// One staged rotation as the pair update reads it, in one or two 16-byte
// loads.  With sigma = (-1)^popcount(e & z) of the pair's first amplitude
// e, and p its mate (e ^ x, or e ^ 1 when x = 0):
//   FS(e) = sigma fa,  FS(p) = sigma fb,
// fa = f (-1)^popcount(x & z) and fb = f when x != 0 (e ^ x = p);
// fa = f and fb = f (-1)^(z & 1) when x = 0 (each amplitude rotates
// alone), so a rotation is  a' = c a + sigma ka u_a,  b' = c b +
// sigma kb u_b,  ka = s fa, kb = s fb (exact: f is +-1 or +-i).
template <typename A, typename R>
struct alignas(16) Rot {
  A ka, kb;
  R c;
  unsigned z;
};

// what the backward adds: the factors of the inner product Re<W, FS P s>
template <typename A>
struct Fac {
  A fa, fb;
};

static_assert(sizeof(Rot<float, float>) == round16(2 * 4 + 4 + 4), "");
static_assert(sizeof(Rot<double, double>) == round16(2 * 8 + 8 + 4), "");
static_assert(sizeof(Rot<Cx<float>, float>) == round16(2 * 8 + 4 + 4), "");
static_assert(sizeof(Rot<Cx<double>, double>) == round16(2 * 16 + 8 + 4),
              "");

// `bufs` state buffers of dim amplitudes (0 on the global route; rounded
// up to 16 bytes), the staged rotations (window x (Rot, Fac, s)), then the
// dang warp sums
__host__ inline size_t smem_bytes(int dim, int itemsize, int realsize,
                                  int bufs, int window) {
  const size_t rot = round16(2 * itemsize + realsize + 4);
  return round16(static_cast<size_t>(itemsize) * bufs * dim) +
         static_cast<size_t>(window) * (rot + 2 * itemsize + realsize) +
         kPartSlots * sizeof(double);
}

// Rotations [k0, k1) of the run staged in shared memory (Rot, Fac and s
// each), reloaded at a group boundary when a group is not resident.
template <typename A, typename R>
struct Window {
  Rot<A, R>* rot;
  Fac<A>* fac;
  double* part;
  R* s;
  int cap, k0, k1;
  __device__ Window(unsigned char* base, int window)
      : cap(window), k0(0), k1(0) {
    rot = reinterpret_cast<Rot<A, R>*>(base);
    fac = reinterpret_cast<Fac<A>*>(rot + window);
    part = reinterpret_cast<double*>(fac + window);
    s = reinterpret_cast<R*>(part + kPartSlots);
  }
  // Make rotations [a, b) resident, from a (forward) or ending at b
  // (backward), reloading the window when they are not; uniform over the
  // block.  A reload first waits for every thread to finish with the
  // window.
  __device__ void need(const Gates<A, R>& g, int a, int b, bool backward) {
    if (a >= k0 && b <= k1) return;
    __syncthreads();
    k0 = backward ? (b - cap > 0 ? b - cap : 0) : a;
    k1 = k0 + cap < g.K ? k0 + cap : g.K;
    for (int i = threadIdx.x; i < k1 - k0; i += blockDim.x) {
      const int k = k0 + i;
      const unsigned x = static_cast<unsigned>(__ldg(g.x + k));
      const unsigned zk = static_cast<unsigned>(__ldg(g.z + k));
      const A f = load(g.f + k);
      const R sk = __ldg(g.s + k);
      const A fa = x ? flip(f, __popc(x & zk) << 31) : f;
      const A fb = x ? f : flip(f, zk << 31);
      rot[i] = Rot<A, R>{kmul(sk, fa), kmul(sk, fb), __ldg(g.c + k), zk};
      fac[i] = Fac<A>{fa, fb};
      s[i] = sk;
    }
    __syncthreads();
  }
};

// the pair of q: q with a 0 inserted at bit h
__device__ __forceinline__ unsigned expand(unsigned q, int h) {
  const unsigned low = (1u << h) - 1u;
  return ((q & ~low) << 1) | (q & low);
}

// A group's pairs: e (q with a 0 inserted at x's highest set bit, bit 0
// for x = 0) and its mate e ^ pm (pm = x, or 1 for x = 0).
struct Pairs {
  int h;
  unsigned pm;
  __device__ explicit Pairs(unsigned x) {
    h = x == 0 ? 0 : 31 - __clz(x);
    pm = x == 0 ? 1u : x;
  }
};

// a staged rotation on the pair (a at e, b at its mate), in place
template <bool DIAG, typename A, typename R>
__device__ __forceinline__ void rotate_pair(const Rot<A, R>& r, unsigned e,
                                            A& a, A& b) {
  const unsigned m = __popc(e & r.z) << 31;
  const A na = upd(r.c, a, flip(r.ka, m), DIAG ? a : b);
  const A nb = upd(r.c, b, flip(r.kb, m), DIAG ? b : a);
  a = na;
  b = nb;
}

// Window rotations [i0, i1) (one group) on every pair, P pairs a thread
// at a time: each pair read from src once (and written to ck, the
// group's checkpoint, when given) and written to dst once.  The P pairs
// are rotated without a guard (a slot past the last pair holds zeros and
// is not stored), so their P dependence chains interleave.
template <bool DIAG, int P, typename A, typename R>
__device__ __forceinline__ void group_pass(const Window<A, R>& W, int i0,
                                           int i1, const Pairs& pr,
                                           unsigned half, const A* src,
                                           A* dst, A* ck) {
  const unsigned nt = blockDim.x;
  for (unsigned q0 = threadIdx.x; q0 < half; q0 += nt * P) {
    A a[P], b[P];
    unsigned e[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const unsigned q = q0 + j * nt;
      e[j] = expand(q, pr.h);
      a[j] = q < half ? src[e[j]] : A{};
      b[j] = q < half ? src[e[j] ^ pr.pm] : A{};
    }
    if (ck != nullptr) {
#pragma unroll
      for (int j = 0; j < P; ++j)
        if (q0 + j * nt < half) {
          ck[e[j]] = a[j];
          ck[e[j] ^ pr.pm] = b[j];
        }
    }
    for (int i = i0; i < i1; ++i) {
      const Rot<A, R> r = W.rot[i];
#pragma unroll
      for (int j = 0; j < P; ++j) rotate_pair<DIAG>(r, e[j], a[j], b[j]);
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (q0 + j * nt < half) {
        dst[e[j]] = a[j];
        dst[e[j] ^ pr.pm] = b[j];
      }
  }
}

template <int P, typename A, typename R>
__device__ __forceinline__ void group_pass(const Window<A, R>& W, int i0,
                                           int i1, const Pairs& pr,
                                           bool diag, unsigned half,
                                           const A* src, A* dst, A* ck) {
  if (diag)
    group_pass<true, P>(W, i0, i1, pr, half, src, dst, ck);
  else
    group_pass<false, P>(W, i0, i1, pr, half, src, dst, ck);
}

// The group's pass with as many pairs a thread at a time as the thread
// has (`per`, the block's pairs a thread: PMAX, 2 or 1), so no slot
// computes a pair it does not own (a group of one at 10 qubits: one pair
// a thread).
template <int PMAX, typename A, typename R>
__device__ __forceinline__ void group_pass(const Window<A, R>& W, int i0,
                                           int i1, unsigned x, unsigned per,
                                           unsigned half, const A* src,
                                           A* dst, A* ck) {
  const Pairs pr(x);
  if (per >= PMAX)
    group_pass<PMAX>(W, i0, i1, pr, x == 0, half, src, dst, ck);
  else if (per >= 2)
    group_pass<2>(W, i0, i1, pr, x == 0, half, src, dst, ck);
  else
    group_pass<1>(W, i0, i1, pr, x == 0, half, src, dst, ck);
}

// copy n amplitudes (block-wide, coalesced)
template <typename A>
__device__ __forceinline__ void copy(A* dst, const A* src, int n) {
  for (int e = threadIdx.x; e < n; e += blockDim.x) dst[e] = src[e];
}

template <typename A, typename R, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
prot_scan_fwd(Gates<A, R> gs, const A* s0, A* out, A* ckpt, int dim,
              int stride, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPassPairs<A, SMEM>;
  const int G = gs.G, K = gs.K;
  const unsigned half = static_cast<unsigned>(dim) / 2;
  const size_t off = static_cast<size_t>(blockIdx.x) * dim;
  // the state: in shared memory, or in place in the output row
  A* state = SMEM ? reinterpret_cast<A*>(smem) : out + off;
  Window<A, R> W(smem + (SMEM ? round16(sizeof(A) * dim) : 0), window);
  const int nc = (G + stride - 1) / stride;
  A* ck_b = ckpt == nullptr
                ? nullptr
                : ckpt + static_cast<size_t>(blockIdx.x) * nc * dim;

  copy(state, s0 + off, dim);
  const unsigned per = (half + blockDim.x - 1) / blockDim.x;
  int k0 = 0, k1 = __ldg(gs.off + 1);
  unsigned x = static_cast<unsigned>(__ldg(gs.x));
  // the next checkpoint row and the groups until it (no division a group)
  A* ck_next = ck_b;
  int ck_in = 0;
  for (int g = 0; g < G; ++g) {
    // the next group's end and mask, in flight while this one runs
    const int k2 = g + 2 <= G ? __ldg(gs.off + g + 2) : K;
    const unsigned xn = k1 < K ? static_cast<unsigned>(__ldg(gs.x + k1)) : 0u;
    W.need(gs, k0, k1, false);     // its barrier publishes the state too
    A* ck = nullptr;
    if (ck_next != nullptr && ck_in == 0) {
      ck = ck_next;
      ck_next += dim;
      ck_in = stride;
    }
    --ck_in;
    group_pass<P>(W, k0 - W.k0, k1 - W.k0, x, per, half, state, state, ck);
    __syncthreads();
    k0 = k1;
    k1 = k2;
    x = xn;
  }
  if (SMEM) copy(out + off, state, dim);
}

// The adjoint through one group (window rotations [i0, i0 + n)), P pairs
// a thread at a time: each rotation's input pairs rebuilt in registers
// from the group's input sk, then W's pairs run back through the
// rotations, W in place; the
// two inner products of each rotation summed per thread into s1, s2,
// pair by pair in order (a slot past the last pair holds zeros and adds
// nothing).
template <bool DIAG, int P, typename A, typename R>
__device__ __forceinline__ void group_adjoint(const Window<A, R>& W, int i0,
                                              int n, const Pairs& pr,
                                              unsigned half, const A* sk,
                                              A* Wst,
                                              R (&s1)[kMaxGroup],
                                              R (&s2)[kMaxGroup]) {
  const unsigned nt = blockDim.x;
  for (unsigned q0 = threadIdx.x; q0 < half; q0 += nt * P) {
    A sa[kMaxGroup][P], sb[kMaxGroup][P], wa[P], wb[P];
    unsigned e[P];
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const unsigned q = q0 + j * nt;
      e[j] = expand(q, pr.h);
      sa[0][j] = q < half ? sk[e[j]] : A{};
      sb[0][j] = q < half ? sk[e[j] ^ pr.pm] : A{};
      wa[j] = q < half ? Wst[e[j]] : A{};
      wb[j] = q < half ? Wst[e[j] ^ pr.pm] : A{};
    }
#pragma unroll
    for (int r = 1; r < kMaxGroup; ++r) {
      if (r < n) {
        const Rot<A, R> rr = W.rot[i0 + r - 1];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          sa[r][j] = sa[r - 1][j];
          sb[r][j] = sb[r - 1][j];
          rotate_pair<DIAG>(rr, e[j], sa[r][j], sb[r][j]);
        }
      }
    }
#pragma unroll
    for (int r = kMaxGroup - 1; r >= 0; --r) {
      if (r < n) {
        const Rot<A, R> rr = W.rot[i0 + r];
        const Fac<A> ff = W.fac[i0 + r];
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const unsigned m = __popc(e[j] & rr.z) << 31;
          const A a = sa[r][j], b = sb[r][j];
          // Re<W, FS . P s_k> and Re<W, s_k> on the pair
          s1[r] += redot(wa[j], kmul(flip(ff.fa, m), DIAG ? a : b));
          s1[r] += redot(wb[j], kmul(flip(ff.fb, m), DIAG ? b : a));
          s2[r] += redot(wa[j], a);
          s2[r] += redot(wb[j], b);
          // W[e] <- c W[e] + s conj(FS(e ^ x)) W[e ^ x]
          const A ka = flip(rr.ka, m), kb = flip(rr.kb, m);
          const A va = cupd(rr.c, wa[j], DIAG ? ka : kb, DIAG ? wa[j] : wb[j]);
          const A vb = cupd(rr.c, wb[j], DIAG ? kb : ka, DIAG ? wb[j] : wa[j]);
          wa[j] = va;
          wb[j] = vb;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (q0 + j * nt < half) {
        Wst[e[j]] = wa[j];
        Wst[e[j] ^ pr.pm] = wb[j];
      }
  }
}

template <typename A, typename R, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
prot_scan_bwd(Gates<A, R> gs, const A* ckpt, const A* ct, A* w0, R* dang,
              A* rec, int dim, int stride, int window) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr int P = kPassPairs<A, SMEM>;
  const int G = gs.G, K = gs.K, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const unsigned half = static_cast<unsigned>(dim) / 2;
  const size_t off = static_cast<size_t>(blockIdx.x) * dim;
  // W: in shared memory, or in place in the w0 row
  A* Wst = SMEM ? reinterpret_cast<A*>(smem) : w0 + off;
  Window<A, R> W(smem + (SMEM ? round16(sizeof(A) * dim) : 0), window);
  const int nc = (G + stride - 1) / stride;
  const A* ck_b = ckpt + static_cast<size_t>(blockIdx.x) * nc * dim;
  A* rec_b = rec == nullptr
                 ? nullptr
                 : rec + static_cast<size_t>(blockIdx.x) * (stride - 1) * dim;

  copy(Wst, ct + off, dim);
  const unsigned per = (half + nt - 1) / nt;
  __syncthreads();
  for (int j = nc - 1; j >= 0; --j) {
    const int g0 = j * stride;
    const int g1 = g0 + stride < G ? g0 + stride : G;
    // the input state of group g of the chunk: its checkpoint, then the
    // recomputed rows
    auto row = [&](int g) -> const A* {
      return g == g0 ? ck_b + static_cast<size_t>(j) * dim
                     : rec_b + static_cast<size_t>(g - g0 - 1) * dim;
    };
    for (int g = g0; g + 1 < g1; ++g) {
      const int k0 = __ldg(gs.off + g), k1 = __ldg(gs.off + g + 1);
      const unsigned x = static_cast<unsigned>(__ldg(gs.x + k0));
      W.need(gs, k0, k1, false);
      group_pass<P>(W, k0 - W.k0, k1 - W.k0, x, per, half, row(g),
                    rec_b + static_cast<size_t>(g - g0) * dim,
                    static_cast<A*>(nullptr));
      __syncthreads();
    }
    int k1 = __ldg(gs.off + g1), k0 = __ldg(gs.off + g1 - 1);
    int kp = g1 - 2 >= g0 ? __ldg(gs.off + g1 - 2) : 0;
    unsigned x = static_cast<unsigned>(__ldg(gs.x + k0));
    for (int g = g1 - 1; g >= g0; --g) {
      // the next groups' starts and the next group's mask, in flight while
      // this one runs (the mask's address loaded a group earlier)
      const int kpp = g - 2 >= g0 ? __ldg(gs.off + g - 2) : 0;
      const unsigned xp = g > g0 ? static_cast<unsigned>(__ldg(gs.x + kp))
                                 : 0u;
      W.need(gs, k0, k1, true);
      const int i0 = k0 - W.k0, n = k1 - k0;
      R s1[kMaxGroup], s2[kMaxGroup];
#pragma unroll
      for (int r = 0; r < kMaxGroup; ++r) s1[r] = s2[r] = R(0);
      // kAdjointPairs pairs a thread at a time while a thread has as many
      const Pairs pr(x);
      bool two = false;
      if constexpr (kAdjointPairs<A> == 2) two = per >= 2;
      if (two) {
        if (x == 0)
          group_adjoint<true, kAdjointPairs<A>>(W, i0, n, pr, half, row(g),
                                                Wst, s1, s2);
        else
          group_adjoint<false, kAdjointPairs<A>>(W, i0, n, pr, half, row(g),
                                                 Wst, s1, s2);
      } else if (x == 0) {
        group_adjoint<true, 1>(W, i0, n, pr, half, row(g), Wst, s1, s2);
      } else {
        group_adjoint<false, 1>(W, i0, n, pr, half, row(g), Wst, s1, s2);
      }
      // the group's warp sums; group g - 1 writes the other half of
      // `part`, and group g - 2 this half only after the next barrier
      double* part = W.part + (g & 1) * kMaxGroup * 2 * kMaxWarps;
      const R v = warp_sums(s1, s2, lane);
      if ((lane & 1) == 0 && (lane >> 2) < n)
        part[(lane >> 1) * kMaxWarps + warp] = static_cast<double>(v);
      __syncthreads();
      // warp r finishes rotation r: dang = (c S1 - s S2) / 2
      for (int r = warp; r < n; r += nwarps) {
        R v1 = lane < nwarps
                   ? static_cast<R>(part[(2 * r) * kMaxWarps + lane])
                   : R(0);
        R v2 = lane < nwarps
                   ? static_cast<R>(part[(2 * r + 1) * kMaxWarps + lane])
                   : R(0);
        v1 = warp_sum(v1);
        v2 = warp_sum(v2);
        if (lane == 0)
          dang[static_cast<size_t>(blockIdx.x) * K + k0 + r] =
              R(0.5) * (W.rot[i0 + r].c * v1 - W.s[i0 + r] * v2);
      }
      k1 = k0;
      k0 = kp;
      kp = kpp;
      x = xp;
    }
  }
  if (SMEM) copy(w0 + off, Wst, dim);
}

template <typename F>
int set_smem(F kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// route 0: the state (or W) in shared memory; 1: in place in the output
template <typename A, typename R>
int check(int B, int K, int G, int dim, int stride, int window, int route,
          size_t* smem) {
  if (B < 1 || K < 1 || G < 1 || G > K || dim < 2 || dim > kMaxDim ||
      (dim & (dim - 1)) != 0 || stride < 1 || window < 1 ||
      window % 4 != 0 || (window < kMaxGroup && window < K) ||
      (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(dim, sizeof(A), sizeof(R), route == 0 ? kBuffers : 0,
                     window);
  if (*smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename A, typename R>
int scan_fwd(const Gates<A, R>& gs, const A* s0, A* out, A* ckpt, int B,
             int dim, int stride, int window, int route,
             cudaStream_t stream) {
  size_t smem = 0;
  int rc = check<A, R>(B, gs.K, gs.G, dim, stride, window, route, &smem);
  if (rc != 0) return rc;
  auto kernel = route == 0 ? prot_scan_fwd<A, R, true>
                           : prot_scan_fwd<A, R, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(dim), smem, stream>>>(gs, s0, out, ckpt, dim,
                                                  stride, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename R>
int scan_bwd(const Gates<A, R>& gs, const A* ckpt, const A* ct, A* w0,
             R* dang, A* rec, int B, int dim, int stride, int window,
             int route, cudaStream_t stream) {
  size_t smem = 0;
  int rc = check<A, R>(B, gs.K, gs.G, dim, stride, window, route, &smem);
  if (rc != 0) return rc;
  if (ckpt == nullptr || (stride > 1 && rec == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = route == 0 ? prot_scan_bwd<A, R, true>
                           : prot_scan_bwd<A, R, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(dim), smem, stream>>>(gs, ckpt, ct, w0, dang, rec,
                                                  dim, stride, window);
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename R>
Gates<A, R> gates(const void* x, const void* z, const void* f, const void* c,
                  const void* s, const void* off, int K, int G) {
  return {static_cast<const long long*>(x), static_cast<const long long*>(z),
          static_cast<const A*>(f),         static_cast<const R*>(c),
          static_cast<const R*>(s),         static_cast<const int*>(off),
          K,                                G};
}

}  // namespace

#define ESOO_GATE_ARGS                                                      \
  const void *x, const void *z, const void *f, const void *c, const void *s, \
      const void *off

#define ESOO_PROT_SCAN(TAG, A, R)                                           \
  extern "C" int esoo_prot_scan_fwd_##TAG(                                  \
      ESOO_GATE_ARGS, const void* s0, void* out, void* ckpt, int B, int K,  \
      int G, int dim, int stride, int window, int route, void* stream) {    \
    return scan_fwd<A, R>(gates<A, R>(x, z, f, c, s, off, K, G),            \
                          static_cast<const A*>(s0), static_cast<A*>(out),  \
                          static_cast<A*>(ckpt), B, dim, stride, window,    \
                          route, static_cast<cudaStream_t>(stream));        \
  }                                                                         \
  extern "C" int esoo_prot_scan_bwd_##TAG(                                  \
      ESOO_GATE_ARGS, const void* ckpt, const void* ct, void* w0,           \
      void* dang, void* rec, int B, int K, int G, int dim, int stride,      \
      int window, int route, void* stream) {                                \
    return scan_bwd<A, R>(gates<A, R>(x, z, f, c, s, off, K, G),            \
                          static_cast<const A*>(ckpt),                      \
                          static_cast<const A*>(ct), static_cast<A*>(w0),   \
                          static_cast<R*>(dang), static_cast<A*>(rec), B,   \
                          dim, stride, window, route,                       \
                          static_cast<cudaStream_t>(stream));               \
  }

ESOO_PROT_SCAN(f32, float, float)
ESOO_PROT_SCAN(f64, double, double)
ESOO_PROT_SCAN(c64, Cx<float>, float)
ESOO_PROT_SCAN(c128, Cx<double>, double)

// The kernel's own shared-memory bytes and block size, for the host
// mirror's test (ops/prot_scan.py::_plan)
extern "C" long long esoo_prot_scan_smem_bytes(int dim, int itemsize,
                                               int realsize, int bufs,
                                               int window) {
  return static_cast<long long>(
      smem_bytes(dim, itemsize, realsize, bufs, window));
}

extern "C" int esoo_prot_scan_threads(int dim) { return block_threads(dim); }
