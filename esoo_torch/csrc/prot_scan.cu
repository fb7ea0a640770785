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
// What bounds it on an H100: not bytes and not operations but the K-step
// serial dependence.  A direction must read the K masks, factors, c and s
// and the states in and out: ~51 KB at the H8 -> 12 path's K = 640,
// 4,096 amplitudes in float32, 15 ns at 3.35 TB/s.  It needs 3 (forward)
// or 7 (backward) floating-point operations an amplitude and rotation on
// a real state (6 and 14 complex; an FMA counts two, the factor's and the
// sign's products are sign flips and swaps, and s f, c and the 1/2 of
// dang apply once a rotation), 7.9 and 18.4 MFLOP there: 0.12 and
// 0.27 us at 67 TFLOP/s.  But rotation k + 1 reads what rotation k
// wrote, at permuted places, so the scan is K rounds of (gather, update,
// barrier) in which one state's 2^N amplitudes give the card little to
// do in parallel.
// The design:
//
//   * One block a state.  The (B, 2^N) states are B blocks; block b runs
//     all K rotations of state b with one __syncthreads() a rotation; its
//     threads (a multiple of 32, at most kMaxThreads) take the amplitudes
//     e = tid, tid + T, ...
//   * No (K, 2^N) sign table: the sign is popcount((e ^ x) & z) & 1 in
//     registers, from the (K,) int64 masks (indices below 2^30, so 32-bit
//     integer work).  The next rotation's masks, factor, c and s are
//     loaded while the current one runs.
//   * Ping-pong buffers: a rotation reads buffer `cur` (its amplitude and
//     its partner e ^ x) and writes `nxt`.  They stay in shared memory
//     while two fit the 227 KB a block may use (smem route: real float32
//     to N = 14, complex128 to N = 12); else the same kernel keeps them in
//     a global scratch of (B, 2, 2^N), which stays L2-resident (global
//     route: 256 KB a state at N = 16, float32).
//   * Reverse mode keeps the plain version's numerics, the JAX package's
//     residuals: each rotation's input state is rebuilt from checkpoints,
//     not by the inverse rotation.  The forward, when a gradient is
//     needed, writes the input state of every `stride`-th rotation to
//     `ckpt` (B, ceil(K / stride), 2^N): stride 1 (every state) while K
//     times the states' size is within _REMAT_RESIDUAL_BUDGET, else
//     isqrt(K), the chunks of _ProtScan.forward.  The backward takes the
//     chunks last to first: it re-runs a chunk's rotations from its
//     checkpoint into `rec` (B, stride - 1, 2^N), then runs the adjoint
//     through the chunk, W in the ping-pong buffers (shared memory or
//     the scratch, as forward; s_k is read from the checkpoint or `rec`,
//     so the backward holds the same two buffers and takes the same
//     route).
//   * dang without atomics: each thread sums its amplitudes' terms in
//     amplitude order, each warp reduces by __shfl_down_sync (offsets
//     16 .. 1), and after the rotation's barrier warp 0 reduces the warp
//     sums the same way and writes dang[b, k] (the caller sums the (B, K)
//     partials).  Two calls on the same inputs agree bit for bit.
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
constexpr int kBuffers = 2;                  // state (forward) or W ping-pong
constexpr int kMaxDim = 1 << 30;             // 32-bit amplitude indices

template <typename R>
struct alignas(2 * sizeof(R)) Cx {
  R re, im;
};

// the element operations, real and complex

template <typename R>
__device__ __forceinline__ R negate_if(R a, bool n) { return n ? -a : a; }
template <typename R>
__device__ __forceinline__ Cx<R> negate_if(Cx<R> a, bool n) {
  return n ? Cx<R>{-a.re, -a.im} : a;
}

// f u (f +-1, or +-1 / +-i: exact products)
template <typename R>
__device__ __forceinline__ R fmul(R f, R u) { return f * u; }
template <typename R>
__device__ __forceinline__ Cx<R> fmul(Cx<R> f, Cx<R> u) {
  return {f.re * u.re - f.im * u.im, f.re * u.im + f.im * u.re};
}

// conj(f) u
template <typename R>
__device__ __forceinline__ R cfmul(R f, R u) { return f * u; }
template <typename R>
__device__ __forceinline__ Cx<R> cfmul(Cx<R> f, Cx<R> u) {
  return {f.re * u.re + f.im * u.im, f.re * u.im - f.im * u.re};
}

// c v + s u
template <typename R>
__device__ __forceinline__ R rot(R c, R v, R s, R u) { return c * v + s * u; }
template <typename R>
__device__ __forceinline__ Cx<R> rot(R c, Cx<R> v, R s, Cx<R> u) {
  return {c * v.re + s * u.re, c * v.im + s * u.im};
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
// amplitude type) and (K,) c, s (the real type).
template <typename A, typename R>
struct Gates {
  const long long* x;
  const long long* z;
  const A* f;
  const R* c;
  const R* s;
  int K;
};

template <typename A, typename R>
struct Gate {
  unsigned x, z;
  A f;
  R c, s;
};

template <typename A, typename R>
__device__ __forceinline__ Gate<A, R> load_gate(const Gates<A, R>& g, int k) {
  return {static_cast<unsigned>(__ldg(g.x + k)),
          static_cast<unsigned>(__ldg(g.z + k)), load(g.f + k),
          __ldg(g.c + k), __ldg(g.s + k)};
}

// one rotation of amplitude e: c v + s FS(e) u, u = the state at e ^ x
template <typename A, typename R>
__device__ __forceinline__ A rotate(const Gate<A, R>& g, unsigned e, A v,
                                    A u) {
  const bool neg = __popc((e ^ g.x) & g.z) & 1;
  return rot(g.c, v, g.s, fmul(negate_if(g.f, neg), u));
}

template <typename R>
__device__ __forceinline__ R warp_sum(R x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

__host__ __device__ inline int block_threads(int dim) {
  const int t = (dim + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// `bufs` state buffers of dim amplitudes (0 on the global route), then the
// dang warp sums (2 x kMaxWarps slots of 8 bytes)
__host__ inline size_t smem_bytes(int dim, int itemsize, int bufs) {
  return static_cast<size_t>(itemsize) * bufs * static_cast<size_t>(dim) +
         2 * kMaxWarps * sizeof(double);
}

// The block's two state buffers, in shared memory (SMEM) or at block b's
// stretch of scratch, and its warp sums.
template <typename A, typename R, bool SMEM>
struct Layout {
  A* buf;
  R* part;
  __device__ Layout(unsigned char* smem, A* scratch, int dim) {
    A* sm = reinterpret_cast<A*>(smem);
    if (SMEM) {
      buf = sm;
      sm += static_cast<size_t>(kBuffers) * dim;
    } else {
      buf = scratch + static_cast<size_t>(blockIdx.x) * kBuffers * dim;
    }
    part = reinterpret_cast<R*>(sm);
  }
};

template <typename A, typename R, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
prot_scan_fwd(Gates<A, R> gs, const A* __restrict__ s0, A* __restrict__ out,
              A* __restrict__ ckpt, A* scratch, int dim, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = gs.K, tid = threadIdx.x, nt = blockDim.x;
  const Layout<A, R, SMEM> L(smem, scratch, dim);
  A* cur = L.buf;
  A* nxt = L.buf + dim;
  const size_t off = static_cast<size_t>(blockIdx.x) * dim;
  const int nc = (K + stride - 1) / stride;
  A* ck_b = ckpt == nullptr
                ? nullptr
                : ckpt + static_cast<size_t>(blockIdx.x) * nc * dim;

  for (int e = tid; e < dim; e += nt) cur[e] = s0[off + e];
  Gate<A, R> next = load_gate(gs, 0);
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const Gate<A, R> g = next;
    if (k + 1 < K) next = load_gate(gs, k + 1);
    A* ck = (ck_b != nullptr && k % stride == 0)
                ? ck_b + static_cast<size_t>(k / stride) * dim
                : nullptr;
    for (int e = tid; e < dim; e += nt) {
      const A v = cur[e];
      const A u = cur[e ^ g.x];
      if (ck != nullptr) ck[e] = v;
      nxt[e] = rotate(g, static_cast<unsigned>(e), v, u);
    }
    __syncthreads();
    A* t = cur; cur = nxt; nxt = t;
  }

  for (int e = tid; e < dim; e += nt) out[off + e] = cur[e];
}

template <typename A, typename R, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
prot_scan_bwd(Gates<A, R> gs, const A* __restrict__ ckpt,
              const A* __restrict__ ct, A* __restrict__ w0,
              R* __restrict__ dang, A* rec, A* scratch, int dim, int stride) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int K = gs.K, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const Layout<A, R, SMEM> L(smem, scratch, dim);
  A* wc = L.buf;
  A* wn = L.buf + dim;
  const size_t off = static_cast<size_t>(blockIdx.x) * dim;
  const int nc = (K + stride - 1) / stride;
  const A* ck_b = ckpt + static_cast<size_t>(blockIdx.x) * nc * dim;
  A* rec_b = rec == nullptr
                 ? nullptr
                 : rec + static_cast<size_t>(blockIdx.x) * (stride - 1) * dim;

  for (int e = tid; e < dim; e += nt) wc[e] = ct[off + e];
  __syncthreads();

  for (int j = nc - 1; j >= 0; --j) {
    const int k0 = j * stride;
    const int k1 = k0 + stride < K ? k0 + stride : K;
    // s_k of the chunk: its checkpoint, then the recomputed rows
    auto row = [&](int k) -> const A* {
      return k == k0 ? ck_b + static_cast<size_t>(j) * dim
                     : rec_b + static_cast<size_t>(k - k0 - 1) * dim;
    };
    for (int k = k0; k + 1 < k1; ++k) {
      const Gate<A, R> g = load_gate(gs, k);
      const A* src = row(k);
      A* dst = rec_b + static_cast<size_t>(k - k0) * dim;
      for (int e = tid; e < dim; e += nt)
        dst[e] = rotate(g, static_cast<unsigned>(e), src[e], src[e ^ g.x]);
      __syncthreads();
    }
    Gate<A, R> next = load_gate(gs, k1 - 1);
    for (int k = k1 - 1; k >= k0; --k) {
      const Gate<A, R> g = next;
      if (k > k0) next = load_gate(gs, k - 1);
      const A* sk = row(k);
      R acc = R(0);
      for (int e = tid; e < dim; e += nt) {
        const unsigned p = static_cast<unsigned>(e) ^ g.x;
        const A w = wc[e], wp = wc[p], sv = sk[e], sp = sk[p];
        const A fs_e = negate_if(g.f, __popc(p & g.z) & 1);
        const A fs_p = negate_if(g.f, __popc(e & g.z) & 1);
        acc += g.c * redot(w, fmul(fs_e, sp)) - g.s * redot(w, sv);
        wn[e] = rot(g.c, w, g.s, cfmul(fs_p, wp));
      }
      acc = warp_sum(acc);
      const int st = k & 1;
      if (lane == 0) L.part[st * kMaxWarps + warp] = acc;
      __syncthreads();
      // rotation k's warp sums; rotation k - 1 writes the other half of
      // `part`, and rotation k - 2 this half only after the next barrier
      if (warp == 0) {
        R x = lane < nwarps ? L.part[st * kMaxWarps + lane] : R(0);
        x = warp_sum(x);
        if (lane == 0)
          dang[static_cast<size_t>(blockIdx.x) * K + k] = R(0.5) * x;
      }
      A* t = wc; wc = wn; wn = t;
    }
  }

  for (int e = tid; e < dim; e += nt) w0[off + e] = wc[e];
}

template <typename F>
int set_smem(F kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// route 0: the buffers in shared memory; 1: in `scratch`, (B, 2, dim)
template <typename A>
int check(int B, int K, int dim, int stride, int route, const A* scratch,
          size_t* smem) {
  if (B < 1 || K < 1 || dim < 2 || dim > kMaxDim || (dim & (dim - 1)) != 0 ||
      stride < 1 || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(dim, sizeof(A), route == 0 ? kBuffers : 0);
  if (*smem > kMaxSmem || (route == 1 && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  return 0;
}

template <typename A, typename R>
int scan_fwd(const Gates<A, R>& gs, const A* s0, A* out, A* ckpt, A* scratch,
             int B, int dim, int stride, int route, cudaStream_t stream) {
  size_t smem = 0;
  int rc = check(B, gs.K, dim, stride, route, scratch, &smem);
  if (rc != 0) return rc;
  auto kernel = route == 0 ? prot_scan_fwd<A, R, true>
                           : prot_scan_fwd<A, R, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(dim), smem, stream>>>(gs, s0, out, ckpt, scratch,
                                                  dim, stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename R>
int scan_bwd(const Gates<A, R>& gs, const A* ckpt, const A* ct, A* w0,
             R* dang, A* rec, A* scratch, int B, int dim, int stride,
             int route, cudaStream_t stream) {
  size_t smem = 0;
  int rc = check(B, gs.K, dim, stride, route, scratch, &smem);
  if (rc != 0) return rc;
  if (ckpt == nullptr || (stride > 1 && rec == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  auto kernel = route == 0 ? prot_scan_bwd<A, R, true>
                           : prot_scan_bwd<A, R, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(dim), smem, stream>>>(gs, ckpt, ct, w0, dang, rec,
                                                  scratch, dim, stride);
  return static_cast<int>(cudaGetLastError());
}

template <typename A, typename R>
Gates<A, R> gates(const void* x, const void* z, const void* f, const void* c,
                  const void* s, int K) {
  return {static_cast<const long long*>(x), static_cast<const long long*>(z),
          static_cast<const A*>(f), static_cast<const R*>(c),
          static_cast<const R*>(s), K};
}

template <typename A, typename R>
int fwd(const void* x, const void* z, const void* f, const void* c,
        const void* s, const void* s0, void* out, void* ckpt, void* scratch,
        int B, int K, int dim, int stride, int route, void* stream) {
  return scan_fwd<A, R>(gates<A, R>(x, z, f, c, s, K),
                        static_cast<const A*>(s0), static_cast<A*>(out),
                        static_cast<A*>(ckpt), static_cast<A*>(scratch), B,
                        dim, stride, route,
                        static_cast<cudaStream_t>(stream));
}

template <typename A, typename R>
int bwd(const void* x, const void* z, const void* f, const void* c,
        const void* s, const void* ckpt, const void* ct, void* w0, void* dang,
        void* rec, void* scratch, int B, int K, int dim, int stride,
        int route, void* stream) {
  return scan_bwd<A, R>(gates<A, R>(x, z, f, c, s, K),
                        static_cast<const A*>(ckpt),
                        static_cast<const A*>(ct), static_cast<A*>(w0),
                        static_cast<R*>(dang), static_cast<A*>(rec),
                        static_cast<A*>(scratch), B, dim, stride, route,
                        static_cast<cudaStream_t>(stream));
}

}  // namespace

#define ESOO_GATE_ARGS                                                      \
  const void *x, const void *z, const void *f, const void *c, const void *s

#define ESOO_PROT_SCAN(TAG, A, R)                                           \
  extern "C" int esoo_prot_scan_fwd_##TAG(                                  \
      ESOO_GATE_ARGS, const void* s0, void* out, void* ckpt, void* scratch, \
      int B, int K, int dim, int stride, int route, void* stream) {         \
    return fwd<A, R>(x, z, f, c, s, s0, out, ckpt, scratch, B, K, dim,      \
                     stride, route, stream);                                \
  }                                                                         \
  extern "C" int esoo_prot_scan_bwd_##TAG(                                  \
      ESOO_GATE_ARGS, const void* ckpt, const void* ct, void* w0,           \
      void* dang, void* rec, void* scratch, int B, int K, int dim,          \
      int stride, int route, void* stream) {                                \
    return bwd<A, R>(x, z, f, c, s, ckpt, ct, w0, dang, rec, scratch, B, K, \
                     dim, stride, route, stream);                           \
  }

ESOO_PROT_SCAN(f32, float, float)
ESOO_PROT_SCAN(f64, double, double)
ESOO_PROT_SCAN(c64, Cx<float>, float)
ESOO_PROT_SCAN(c128, Cx<double>, double)

// The kernel's own shared-memory bytes and block size, for the host
// mirror's test (ops/prot_scan.py::_plan)
extern "C" long long esoo_prot_scan_smem_bytes(int dim, int itemsize,
                                               int bufs) {
  return static_cast<long long>(smem_bytes(dim, itemsize, bufs));
}

extern "C" int esoo_prot_scan_threads(int dim) { return block_threads(dim); }
