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
// serial dependence.  A direction must read the (K, nd + 1) tables
// (int32 partners and the sign field) once and the states in and out:
// ~0.17 MB at the H8 -> 12 path's K = 92, nd + 1 = 226 in float32, 50 ns
// at 3.35 TB/s.  It needs 3 (forward) or 10 (backward) floating-point
// operations a gate and amplitude the gate touches (|S| = 1; an FMA
// counts two, ce is 1 or c and S a sign, s and c of dth apply once a
// gate), and none where it does not.  But gate k + 1 reads what gate k
// wrote, at permuted places, so the scan is K rounds of (gather, update,
// barrier) in which one state's amplitudes give the card little to do in
// parallel.  The design:
//
//   * One block a state.  The (B, nd + 1) states are B blocks; block b
//     runs all K gates of state b, with one __syncthreads() a gate; its
//     threads (a multiple of 32, at most kMaxThreads) take the amplitudes
//     i = tid, tid + T, ...
//   * Ping-pong buffers, not an in-place update: a gate reads buffer
//     `cur` (its amplitude and its partner) and writes `nxt`, so no thread
//     reads an amplitude that another has already rotated.  Forward two
//     buffers (v), backward four (v and w).
//   * The state stays in shared memory when its buffers fit the 227 KB a
//     block may use (smem route: 153 KB at nd + 1 = 4,901, float64,
//     backward); else the same kernel keeps them in a global scratch of
//     (B, buffers, nd + 1), which stays L2-resident (global route: the
//     sectors where 'auto' falls back to the pairs kernel can be large,
//     H8 -> 20 has nd = 44,100).  ops/pair_scan.py::_plan mirrors
//     smem_bytes and block_threads and picks the route.
//   * The tables are read straight from device memory, each element of
//     gate k's row once: int32 partners (cached once per tables dict by
//     the wrapper) and SFIELD in the element type.
//   * c and s come from the caller (torch.cos/torch.sin of theta, as the
//     plain version takes them), and ce is formed as the plain version
//     forms it, so only the update's rounding differs from the plain
//     version.  A gate at th = 0 (c = 1, s = 0) leaves every finite
//     amplitude exactly as it was.
//   * dth without atomics: each thread sums its amplitudes' terms in
//     amplitude order, each warp reduces by __shfl_down_sync (offsets
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
constexpr int kFwdBuffers = 2;               // v ping-pong
constexpr int kBwdBuffers = 4;               // v and w ping-pong

template <typename T>
struct Tables {
  const int* partner;  // (K, n) int32
  const T* sfield;     // (K, n)
  const T* c;          // (K,) cos th
  const T* s;          // (K,) sin th
  int K, n;            // n = nd + 1
};

__host__ __device__ inline int block_threads(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// `bufs` state buffers of n values (0 on the global route), then the dth
// warp sums (2 x kMaxWarps values)
__host__ inline size_t smem_bytes(int n, int itemsize, int bufs) {
  return static_cast<size_t>(itemsize) *
         (static_cast<size_t>(bufs) * n + 2 * kMaxWarps);
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// The block's state buffers, in shared memory (SMEM) or at block b's
// stretch of scratch, and its warp sums.
template <typename T, bool SMEM>
struct Layout {
  T* state;
  T* part;
  __device__ Layout(unsigned char* smem, T* scratch, int n, int bufs) {
    T* sm = reinterpret_cast<T*>(smem);
    if (SMEM) {
      state = sm;
      sm += static_cast<size_t>(bufs) * n;
    } else {
      state = scratch + static_cast<size_t>(blockIdx.x) * bufs * n;
    }
    part = sm;
  }
};

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
pair_scan_fwd(Tables<T> tb, const T* __restrict__ v0, T* __restrict__ out,
              T* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = tb.n, K = tb.K, tid = threadIdx.x, nt = blockDim.x;
  const Layout<T, SMEM> L(smem, scratch, n, kFwdBuffers);
  T* cur = L.state;
  T* nxt = L.state + n;
  const size_t off = static_cast<size_t>(blockIdx.x) * n;

  for (int i = tid; i < n; i += nt) cur[i] = v0[off + i];
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const int* pk = tb.partner + static_cast<size_t>(k) * n;
    const T* sk = tb.sfield + static_cast<size_t>(k) * n;
    const T c = __ldg(tb.c + k), s = __ldg(tb.s + k);
    const T cm1 = c - T(1);
    for (int i = tid; i < n; i += nt) {
      const T sg = __ldg(sk + i);
      const int p = __ldg(pk + i);
      const T ce = T(1) + cm1 * fabs(sg);
      nxt[i] = ce * cur[i] + (sg * s) * cur[p];
    }
    __syncthreads();
    T* t = cur; cur = nxt; nxt = t;
  }

  for (int i = tid; i < n; i += nt) out[off + i] = cur[i];
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
pair_scan_bwd(Tables<T> tb, const T* __restrict__ v, const T* __restrict__ ct,
              T* __restrict__ w0, T* __restrict__ dth, T* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = tb.n, K = tb.K, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const Layout<T, SMEM> L(smem, scratch, n, kBwdBuffers);
  T* vc = L.state;
  T* vn = L.state + n;
  T* wc = L.state + 2 * static_cast<size_t>(n);
  T* wn = L.state + 3 * static_cast<size_t>(n);
  const size_t off = static_cast<size_t>(blockIdx.x) * n;

  for (int i = tid; i < n; i += nt) {
    vc[i] = v[off + i];
    wc[i] = ct[off + i];
  }
  __syncthreads();

  for (int k = K - 1; k >= 0; --k) {
    const int* pk = tb.partner + static_cast<size_t>(k) * n;
    const T* sk = tb.sfield + static_cast<size_t>(k) * n;
    const T c = __ldg(tb.c + k), s = __ldg(tb.s + k);
    const T cm1 = c - T(1);
    T acc = T(0);
    for (int i = tid; i < n; i += nt) {
      const T sg = __ldg(sk + i);
      const int p = __ldg(pk + i);
      const T touched = fabs(sg);
      const T ce = T(1) + cm1 * touched;
      const T sf = sg * s;
      const T vk = vc[i], pvk = vc[p], w = wc[i], pw = wc[p];
      const T vprev = ce * vk - sf * pvk;
      const T pvprev = ce * pvk + sf * vk;
      acc += w * ((-s * touched) * vprev + (sg * c) * pvprev);
      vn[i] = vprev;
      wn[i] = ce * w - sf * pw;
    }
    acc = warp_sum(acc);
    const int st = k & 1;
    if (lane == 0) L.part[st * kMaxWarps + warp] = acc;
    __syncthreads();
    // gate k's warp sums; gate k - 1 writes the other half of `part`, and
    // gate k - 2 this half only after the next barrier
    if (warp == 0) {
      T x = lane < nwarps ? L.part[st * kMaxWarps + lane] : T(0);
      x = warp_sum(x);
      if (lane == 0) dth[static_cast<size_t>(blockIdx.x) * K + k] = x;
    }
    T* t = vc; vc = vn; vn = t;
    t = wc; wc = wn; wn = t;
  }

  for (int i = tid; i < n; i += nt) w0[off + i] = wc[i];
}

template <typename F>
int set_smem(F kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// route 0: state in shared memory; 1: state in `scratch`, (B, bufs, n)
template <typename T>
int check(const Tables<T>& tb, int B, int route, int bufs, const T* scratch,
          size_t* smem) {
  if (B < 1 || tb.K < 1 || tb.n < 1 || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(tb.n) * bufs >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(tb.n, sizeof(T), route == 0 ? bufs : 0);
  if (*smem > kMaxSmem || (route == 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename T>
int scan_fwd(const Tables<T>& tb, const T* v0, T* out, T* scratch, int B,
             int route, cudaStream_t stream) {
  size_t smem = 0;
  int rc = check(tb, B, route, kFwdBuffers, scratch, &smem);
  if (rc != 0) return rc;
  auto kernel = route == 0 ? pair_scan_fwd<T, true> : pair_scan_fwd<T, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(tb.n), smem, stream>>>(tb, v0, out, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scan_bwd(const Tables<T>& tb, const T* v, const T* ct, T* w0, T* dth,
             T* scratch, int B, int route, cudaStream_t stream) {
  size_t smem = 0;
  int rc = check(tb, B, route, kBwdBuffers, scratch, &smem);
  if (rc != 0) return rc;
  auto kernel = route == 0 ? pair_scan_bwd<T, true> : pair_scan_bwd<T, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(tb.n), smem, stream>>>(tb, v, ct, w0, dth,
                                                   scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Tables<T> tables(const void* partner, const void* sfield, const void* c,
                 const void* s, int K, int n) {
  return {static_cast<const int*>(partner), static_cast<const T*>(sfield),
          static_cast<const T*>(c), static_cast<const T*>(s), K, n};
}

}  // namespace

#define ESOO_PAIR_SCAN(TAG, T)                                              \
  extern "C" int esoo_pair_scan_fwd_##TAG(                                  \
      const void* partner, const void* sfield, const void* c,               \
      const void* s, const void* v0, void* out, void* scratch, int B,       \
      int K, int n, int route, void* stream) {                              \
    return scan_fwd<T>(tables<T>(partner, sfield, c, s, K, n),              \
                       static_cast<const T*>(v0), static_cast<T*>(out),     \
                       static_cast<T*>(scratch), B, route,                  \
                       static_cast<cudaStream_t>(stream));                  \
  }                                                                         \
  extern "C" int esoo_pair_scan_bwd_##TAG(                                  \
      const void* partner, const void* sfield, const void* c,               \
      const void* s, const void* v, const void* ct, void* w0, void* dth,    \
      void* scratch, int B, int K, int n, int route, void* stream) {        \
    return scan_bwd<T>(tables<T>(partner, sfield, c, s, K, n),              \
                       static_cast<const T*>(v), static_cast<const T*>(ct), \
                       static_cast<T*>(w0), static_cast<T*>(dth),           \
                       static_cast<T*>(scratch), B, route,                  \
                       static_cast<cudaStream_t>(stream));                  \
  }

ESOO_PAIR_SCAN(f32, float)
ESOO_PAIR_SCAN(f64, double)

// The kernel's own shared-memory bytes and block size, for the host
// mirror's test (ops/pair_scan.py::_plan)
extern "C" long long esoo_pair_scan_smem_bytes(int n, int itemsize,
                                               int bufs) {
  return static_cast<long long>(smem_bytes(n, itemsize, bufs));
}

extern "C" int esoo_pair_scan_threads(int n) { return block_threads(n); }
