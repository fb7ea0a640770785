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
// amplitudes give the card little to do in parallel.  The design:
//
//   * One block a state.  V0 (..., nB, nA) is flattened to B states and
//     block b runs all K gates of state b, with one __syncthreads() a gate;
//     its threads (a multiple of 32, at most kMaxThreads) take the
//     elements e = tid, tid + T, ... of the row-major string matrix.
//   * Ping-pong buffers, not an in-place update: a gate reads buffer
//     `cur` (its element and its partner) and writes `nxt`, so no thread
//     can read an amplitude that another has already rotated, whatever
//     the partner maps are.  Forward two buffers (V), backward four (V, W).
//   * The state stays in shared memory when its buffers fit the 227 KB a
//     block may use (smem route: 153 KB at nd = 4,900, float64,
//     backward); else the same kernel keeps them in a global scratch of
//     (B, buffers, nd), which stays L2-resident (global route; n = 9 at
//     (4, 4), nd = 15,876).  ops/gate_scan.py::_plan mirrors
//     smem_bytes and block_threads and picks the route.
//   * The factored tables, not the (K, nd) fields M, S and the flat
//     partner index: gate k + 1's PA, PB (int32) and AD AR UD UR BD BR VD
//     VR are copied (cp.async) into a two-stage ring while gate k runs, so
//     the barrier that ends gate k also publishes them.  M, S and the
//     partner's address are formed from them per element.
//   * c and s come from the caller (torch.cos/torch.sin of theta, as the
//     plain version takes them), so only the update's rounding differs
//     from the plain version.  A gate at th = 0 (c = 1, s = 0) leaves
//     every finite amplitude exactly as it was.
//   * dth without atomics: each thread sums its elements' terms in element
//     order, each warp reduces by __shfl_down_sync (offsets 16 .. 1), and
//     after the gate's barrier warp 0 reduces the warp sums the same way
//     and writes dth[b, k]; the caller sums the (B, K) partials.  Two calls
//     on the same inputs agree bit for bit.
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
constexpr int kFwdBuffers = 2;               // V ping-pong
constexpr int kBwdBuffers = 4;               // V and W ping-pong

template <typename T>
struct Tables {
  const int* pa;       // (K, nA) alpha partner permutation, int32
  const int* pb;       // (K, nB) beta partner permutation, int32
  const T* a[4];       // AD, AR, UD, UR: (K, nA)
  const T* b[4];       // BD, BR, VD, VR: (K, nB)
  const T* c;          // (K,) cos th
  const T* s;          // (K,) sin th
  int K, nA, nB;
};

__host__ __device__ inline int block_threads(int nd) {
  const int t = (nd + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// `bufs` state buffers of nd values (0 on the global route), the table
// ring (2 stages of 4 (nA + nB) values), the dth warp sums (2 x
// kMaxWarps values), then the ring's partner maps (2 stages of nA + nB
// int32)
__host__ inline size_t smem_bytes(int nA, int nB, int itemsize, int bufs) {
  const size_t ns = static_cast<size_t>(nA) + nB;
  return static_cast<size_t>(itemsize) *
             (static_cast<size_t>(bufs) * nA * nB + 8 * ns + 2 * kMaxWarps) +
         sizeof(int) * 2 * ns;
}

template <int BYTES>
__device__ __forceinline__ void cp_async(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(d), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// p[a] without indexing the kernel parameter dynamically (which copies
// the parameter block to local memory)
template <typename T>
__device__ __forceinline__ const T* pick(const T* const (&p)[4], int a) {
  return a == 0 ? p[0] : a == 1 ? p[1] : a == 2 ? p[2] : p[3];
}

// Copy gate k's tables into one ring stage: values [AD AR UD UR | BD BR
// VD VR], partner maps [PA | PB].
template <typename T>
__device__ __forceinline__ void stage_gate(const Tables<T>& tb, int k,
                                           T* ring_t, int* ring_i) {
  const int nA = tb.nA, nB = tb.nB;
  const int nf = 4 * (nA + nB);
  const int total = nf + nA + nB;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    if (i < 4 * nA) {
      const int a = i / nA, j = i - a * nA;
      cp_async<sizeof(T)>(ring_t + i,
                          pick(tb.a, a) + static_cast<size_t>(k) * nA + j);
    } else if (i < nf) {
      const int r = i - 4 * nA;
      const int a = r / nB, j = r - a * nB;
      cp_async<sizeof(T)>(ring_t + i,
                          pick(tb.b, a) + static_cast<size_t>(k) * nB + j);
    } else if (i < nf + nA) {
      const int j = i - nf;
      cp_async<4>(ring_i + j, tb.pa + static_cast<size_t>(k) * nA + j);
    } else {
      const int j = i - nf - nA;
      cp_async<4>(ring_i + nA + j, tb.pb + static_cast<size_t>(k) * nB + j);
    }
  }
  cp_async_commit();
}

template <typename T>
__device__ __forceinline__ T warp_sum(T x) {
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_down_sync(0xffffffffu, x, off);
  return x;
}

// The block's shared memory carved as smem_bytes lays it out; the state
// buffers are in shared memory (SMEM) or at block b's stretch of scratch.
template <typename T, bool SMEM>
struct Layout {
  T* state;
  T* ring_t;
  T* part;
  int* ring_i;
  __device__ Layout(unsigned char* smem, T* scratch, int nd, int ns,
                    int bufs) {
    T* sm = reinterpret_cast<T*>(smem);
    if (SMEM) {
      state = sm;
      sm += static_cast<size_t>(bufs) * nd;
    } else {
      state = scratch + static_cast<size_t>(blockIdx.x) * bufs * nd;
    }
    ring_t = sm;
    part = sm + 8 * ns;
    ring_i = reinterpret_cast<int*>(part + 2 * kMaxWarps);
  }
};

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
gate_scan_fwd(Tables<T> tb, const T* __restrict__ v0, T* __restrict__ out,
              T* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nA = tb.nA, nB = tb.nB, nd = nA * nB, ns = nA + nB, K = tb.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const Layout<T, SMEM> L(smem, scratch, nd, ns, kFwdBuffers);
  T* cur = L.state;
  T* nxt = L.state + nd;
  // this thread's first element and the (row, column) step between its
  // elements
  const int ib0 = tid / nA, ia0 = tid - ib0 * nA;
  const int step_b = nt / nA, step_a = nt - step_b * nA;

  const T* src = v0 + static_cast<size_t>(blockIdx.x) * nd;
  for (int e = tid; e < nd; e += nt) cur[e] = src[e];
  stage_gate(tb, 0, L.ring_t, L.ring_i);
  cp_async_wait_all();
  __syncthreads();

  for (int k = 0; k < K; ++k) {
    const int st = k & 1;
    if (k + 1 < K)
      stage_gate(tb, k + 1, L.ring_t + (st ^ 1) * 4 * ns,
                 L.ring_i + (st ^ 1) * ns);
    const T* ta = L.ring_t + st * 4 * ns;      // AD AR UD UR
    const T* tv = ta + 4 * nA;                 // BD BR VD VR
    const int* pa = L.ring_i + st * ns;
    const int* pb = pa + nA;
    const T c = __ldg(tb.c + k), s = __ldg(tb.s + k);
    const T cm1 = c - T(1);
    int ib = ib0, ia = ia0;
    for (int e = tid; e < nd; e += nt) {
      const T m = tv[ib] * ta[ia] + tv[nB + ib] * ta[nA + ia];
      const T sg = tv[3 * nB + ib] * ta[3 * nA + ia] -
                   tv[2 * nB + ib] * ta[2 * nA + ia];
      const T v = cur[e];
      const T g = cur[pb[ib] * nA + pa[ia]];
      nxt[e] = v + cm1 * (m * v) + s * (sg * g);
      ia += step_a;
      ib += step_b;
      if (ia >= nA) { ia -= nA; ++ib; }
    }
    cp_async_wait_all();
    __syncthreads();
    T* t = cur; cur = nxt; nxt = t;
  }

  T* dst = out + static_cast<size_t>(blockIdx.x) * nd;
  for (int e = tid; e < nd; e += nt) dst[e] = cur[e];
}

template <typename T, bool SMEM>
__global__ void __launch_bounds__(kMaxThreads)
gate_scan_bwd(Tables<T> tb, const T* __restrict__ v, const T* __restrict__ ct,
              T* __restrict__ w0, T* __restrict__ dth, T* scratch) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int nA = tb.nA, nB = tb.nB, nd = nA * nB, ns = nA + nB, K = tb.K;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, nwarps = nt >> 5;
  const Layout<T, SMEM> L(smem, scratch, nd, ns, kBwdBuffers);
  T* vc = L.state;
  T* vn = L.state + nd;
  T* wc = L.state + 2 * static_cast<size_t>(nd);
  T* wn = L.state + 3 * static_cast<size_t>(nd);
  const int ib0 = tid / nA, ia0 = tid - ib0 * nA;
  const int step_b = nt / nA, step_a = nt - step_b * nA;

  const size_t off = static_cast<size_t>(blockIdx.x) * nd;
  for (int e = tid; e < nd; e += nt) {
    vc[e] = v[off + e];
    wc[e] = ct[off + e];
  }
  stage_gate(tb, K - 1, L.ring_t + ((K - 1) & 1) * 4 * ns,
             L.ring_i + ((K - 1) & 1) * ns);
  cp_async_wait_all();
  __syncthreads();

  for (int k = K - 1; k >= 0; --k) {
    const int st = k & 1;
    if (k > 0)
      stage_gate(tb, k - 1, L.ring_t + (st ^ 1) * 4 * ns,
                 L.ring_i + (st ^ 1) * ns);
    const T* ta = L.ring_t + st * 4 * ns;
    const T* tv = ta + 4 * nA;
    const int* pa = L.ring_i + st * ns;
    const int* pb = pa + nA;
    const T c = __ldg(tb.c + k), s = __ldg(tb.s + k);
    const T cm1 = c - T(1);
    T acc = T(0);
    int ib = ib0, ia = ia0;
    for (int e = tid; e < nd; e += nt) {
      const T m = tv[ib] * ta[ia] + tv[nB + ib] * ta[nA + ia];
      const T sg = tv[3 * nB + ib] * ta[3 * nA + ia] -
                   tv[2 * nB + ib] * ta[2 * nA + ia];
      const int p = pb[ib] * nA + pa[ia];
      const T vk = vc[e], gk = vc[p], w = wc[e], gw = wc[p];
      const T vprev = vk + cm1 * (m * vk) - s * (sg * gk);
      const T pprev = gk + cm1 * (m * gk) + s * (sg * vk);
      acc += w * (-s * (m * vprev) + c * (sg * pprev));
      vn[e] = vprev;
      wn[e] = w + cm1 * (m * w) - s * (sg * gw);
      ia += step_a;
      ib += step_b;
      if (ia >= nA) { ia -= nA; ++ib; }
    }
    acc = warp_sum(acc);
    if (lane == 0) L.part[st * kMaxWarps + warp] = acc;
    cp_async_wait_all();
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

  for (int e = tid; e < nd; e += nt) w0[off + e] = wc[e];
}

template <typename F>
int set_smem(F kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

// route 0: state in shared memory; 1: state in `scratch`, (B, bufs, nd)
template <typename T>
int check(const Tables<T>& tb, int B, int route, int bufs, const T* scratch,
          size_t* smem) {
  if (B < 1 || tb.K < 1 || tb.nA < 1 || tb.nB < 1 || (route != 0 && route != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  if (static_cast<long long>(tb.nA) * tb.nB * bufs >= (1LL << 31))
    return static_cast<int>(cudaErrorInvalidValue);
  *smem = smem_bytes(tb.nA, tb.nB, sizeof(T), route == 0 ? bufs : 0);
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
  auto kernel = route == 0 ? gate_scan_fwd<T, true> : gate_scan_fwd<T, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(tb.nA * tb.nB), smem, stream>>>(tb, v0, out,
                                                            scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int scan_bwd(const Tables<T>& tb, const T* v, const T* ct, T* w0, T* dth,
             T* scratch, int B, int route, cudaStream_t stream) {
  size_t smem = 0;
  int rc = check(tb, B, route, kBwdBuffers, scratch, &smem);
  if (rc != 0) return rc;
  auto kernel = route == 0 ? gate_scan_bwd<T, true> : gate_scan_bwd<T, false>;
  rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<B, block_threads(tb.nA * tb.nB), smem, stream>>>(tb, v, ct, w0,
                                                            dth, scratch);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
Tables<T> tables(const void* pa, const void* pb, const void* ad,
                 const void* ar, const void* ud, const void* ur,
                 const void* bd, const void* br, const void* vd,
                 const void* vr, const void* c, const void* s, int K, int nA,
                 int nB) {
  Tables<T> tb;
  tb.pa = static_cast<const int*>(pa);
  tb.pb = static_cast<const int*>(pb);
  tb.a[0] = static_cast<const T*>(ad);
  tb.a[1] = static_cast<const T*>(ar);
  tb.a[2] = static_cast<const T*>(ud);
  tb.a[3] = static_cast<const T*>(ur);
  tb.b[0] = static_cast<const T*>(bd);
  tb.b[1] = static_cast<const T*>(br);
  tb.b[2] = static_cast<const T*>(vd);
  tb.b[3] = static_cast<const T*>(vr);
  tb.c = static_cast<const T*>(c);
  tb.s = static_cast<const T*>(s);
  tb.K = K;
  tb.nA = nA;
  tb.nB = nB;
  return tb;
}

}  // namespace

#define ESOO_TABLE_ARGS                                                     \
  const void *pa, const void *pb, const void *ad, const void *ar,           \
      const void *ud, const void *ur, const void *bd, const void *br,       \
      const void *vd, const void *vr, const void *c, const void *s

extern "C" int esoo_gate_scan_fwd_f32(ESOO_TABLE_ARGS, const void* v0,
                                      void* out, void* scratch, int B, int K,
                                      int nA, int nB, int route,
                                      void* stream) {
  return scan_fwd<float>(
      tables<float>(pa, pb, ad, ar, ud, ur, bd, br, vd, vr, c, s, K, nA, nB),
      static_cast<const float*>(v0), static_cast<float*>(out),
      static_cast<float*>(scratch), B, route,
      static_cast<cudaStream_t>(stream));
}

extern "C" int esoo_gate_scan_fwd_f64(ESOO_TABLE_ARGS, const void* v0,
                                      void* out, void* scratch, int B, int K,
                                      int nA, int nB, int route,
                                      void* stream) {
  return scan_fwd<double>(
      tables<double>(pa, pb, ad, ar, ud, ur, bd, br, vd, vr, c, s, K, nA, nB),
      static_cast<const double*>(v0), static_cast<double*>(out),
      static_cast<double*>(scratch), B, route,
      static_cast<cudaStream_t>(stream));
}

extern "C" int esoo_gate_scan_bwd_f32(ESOO_TABLE_ARGS, const void* v,
                                      const void* ct, void* w0, void* dth,
                                      void* scratch, int B, int K, int nA,
                                      int nB, int route, void* stream) {
  return scan_bwd<float>(
      tables<float>(pa, pb, ad, ar, ud, ur, bd, br, vd, vr, c, s, K, nA, nB),
      static_cast<const float*>(v), static_cast<const float*>(ct),
      static_cast<float*>(w0), static_cast<float*>(dth),
      static_cast<float*>(scratch), B, route,
      static_cast<cudaStream_t>(stream));
}

extern "C" int esoo_gate_scan_bwd_f64(ESOO_TABLE_ARGS, const void* v,
                                      const void* ct, void* w0, void* dth,
                                      void* scratch, int B, int K, int nA,
                                      int nB, int route, void* stream) {
  return scan_bwd<double>(
      tables<double>(pa, pb, ad, ar, ud, ur, bd, br, vd, vr, c, s, K, nA, nB),
      static_cast<const double*>(v), static_cast<const double*>(ct),
      static_cast<double*>(w0), static_cast<double*>(dth),
      static_cast<double*>(scratch), B, route,
      static_cast<cudaStream_t>(stream));
}

// The kernel's own shared-memory bytes and block size, for the host
// mirror's test (ops/gate_scan.py::_plan)
extern "C" long long esoo_gate_scan_smem_bytes(int nA, int nB, int itemsize,
                                               int bufs) {
  return static_cast<long long>(smem_bytes(nA, nB, itemsize, bufs));
}

extern "C" int esoo_gate_scan_threads(int nd) { return block_threads(nd); }
