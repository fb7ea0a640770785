// The orbital step's value and gradient in one pass over g (sm_90a, CUDA
// cores).
//
//   E2(U)    = sum g[p,q,r,s] U[p,i] U[q,j] U[r,k] U[s,l] Gamma[i,j,k,l]
//   dE2/dU   (m, n), both for U (m, n), Gamma (n, n, n, n), g (m, m, m, m)
//
// The JAX package evaluates this energy with jnp (the kron sandwich
// W^T (G2 W), W = U (x) U) and differentiates it with jax.grad; it has no
// Pallas kernel here, so this kernel replaces none.  At H8 cc-pVTZ -> 28
// (m = 112, n = 14, float64) the sandwich and its backward are two GEMMs
// of 61.7 GFLOP each, per BB iteration.
//
// The formulas.  g has the pair symmetry g[p,q,r,s] = g[r,s,p,q] (a real
// ERI tensor; the caller checks it), so with the pair-symmetrised
// Gt[i,j,k,l] = (Gamma[i,j,k,l] + Gamma[k,l,i,j]) / 2 all four gradient
// slots follow from the half-transform of each slab S_pq = g[p,q,:,:]:
//
//   X[p,q,k,l]  = sum_rs S_pq[r,s] U[r,k] U[s,l]       (U^T S_pq U)
//   W1[p,j,kl]  = sum_q U[q,j] X[p,q,kl]
//   W2[q,i,kl]  = sum_p U[p,i] X[p,q,kl]
//   s1[p,i]     = sum_{j,kl} Gt[i,j,kl] W1[p,j,kl]
//   s2[q,j]     = sum_{i,kl} Gt[i,j,kl] W2[q,i,kl]
//   E2 = sum U (.) s1,   dE2/dU = 2 (s1 + s2).
//
// What bounds it on an H100: bytes.  It must read g once: 8 m^4 bytes,
// 1.259 GB at (112, 14) float64, 0.376 ms at 3.35 TB/s.  Its work is
// m^4 n + m^3 n^2 FMAs for X (2.48 GFMA there, 0.17 ms at the 64 DFMA a
// clock an SM of the CUDA cores) and ~2 m^2 n^3 for the rest (69 MFMA).
// The design:
//
//   * One pass.  A block takes a contiguous stretch of slab groups (spb
//     consecutive slabs, i.e. consecutive (p, q)), so the grid reads g
//     exactly once and in order.
//   * The sum in the order that costs least per element of g.  A thread
//     owns CPT = 16 / sizeof(T) columns s of one slab of the group (16
//     bytes of each row) and keeps T[k, s] = sum_r U[r,k] S[r,s] for them
//     in registers (CPT NB accumulators); per row r it reads its 16 bytes
//     of S and U[r, :] (broadcast vector loads) and makes CPT NB FMAs.
//     When the group's rows are done, the block publishes T through shared
//     memory and contracts it with U over s into X (n^2 values a slab),
//     written to global memory: 19.7 MB at (112, 14) float64, which stays
//     in L2.
//   * Bytes in flight, and no barrier a row.  Each thread copies the 16
//     bytes of each row that it alone reads into its own slots of a ring
//     (cp.async, 16-byte cg copies where g's rows allow, a warp's copies
//     512 contiguous bytes), kStepRows rows a step and up to kMaxDepth
//     steps ahead, and waits for its own copies only: the warps run
//     apart, and the block meets at a barrier twice a group (T published,
//     T read), while the copies of the next group are in flight.  Two
//     blocks share an SM wherever a ring three steps deep fits (at most
//     128 registers a thread): at (112, 14) float64 one block's barriers
//     and contraction then overlap the other's rows.  On an H100 at (112,
//     14) float64 the four launches took 0.83 ms with a stage shared by
//     the block and a barrier a stage (copies alone 0.54 ms, arithmetic
//     alone 0.41 ms), 0.80 ms with per-thread rings and one block an SM,
//     0.59 ms with two.
//   * The finish (orbital_finish, one block a row of W1 or of W2, and
//     orbital_combine) reads X from L2 and Gt, and writes s1, s2, the
//     gradient and E2.  Gt is formed first by orbital_sym.
//   * Deterministic: every value is summed by one thread or one warp in a
//     fixed order, no atomics, so two calls agree bit for bit.
//   * FFMA on the CUDA cores in the element type (float or double), no
//     TF32 (the package's precision rule).
//
// The caller checks g's pair symmetry once per g with pair_asym_tiles, one
// read of g (G2 = g as (m^2, m^2) against its transpose, a tile pair a
// block through shared memory, so both tiles are read in rows): 0.376 ms
// of bytes at (112, 14) float64, where a strided comparison in PyTorch
// took 194 ms.
//
// C interface (ctypes): esoo_orbital_vag_f32 / _f64 make the four
// launches on the given stream, esoo_pair_asymmetry_f32 / _f64 one; each
// returns the first non-zero cudaGetLastError(); the caller allocates
// everything.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kMaxThreads = 256;
constexpr int kMaxN = 16;
constexpr int kMaxM = 256;
constexpr int kMaxGroup = 16;        // slabs a block works on at once
constexpr int kStepRows = 4;         // rows of a slab a ring step holds
constexpr int kMaxDepth = 8;         // ring steps
constexpr int kLChunk = 4;           // columns l of X a thread forms
constexpr size_t kMaxSmem = 232448;        // 227 KB a block may use
constexpr size_t kTwoBlockSmem = 115712;   // (228 KB an SM - 1 KB a block) / 2
constexpr int kPlanFields = 10;

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(s), "l"(src) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async_ca(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n"
               :: "r"(s), "l"(src), "n"(BYTES) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// wait until at most `pending` (0 .. kMaxDepth - 2) groups are in flight
__device__ __forceinline__ void cp_async_wait_pending(int pending) {
  switch (pending) {
    case 6: cp_async_wait<6>(); break;
    case 5: cp_async_wait<5>(); break;
    case 4: cp_async_wait<4>(); break;
    case 3: cp_async_wait<3>(); break;
    case 2: cp_async_wait<2>(); break;
    case 1: cp_async_wait<1>(); break;
    default: cp_async_wait<0>(); break;
  }
}

__host__ __device__ inline int round_up(int a, int b) {
  return (a + b - 1) / b * b;
}

// The pass's launch plan (read back by esoo_orbital_vag_plan).
struct Plan {
  int nb;        // n rounded up: a multiple of 2 (double) or 4 (float)
  int mp;        // m rounded up to 16 bytes: a thread's columns, T's rows
  int spb;       // slabs a block works on at once
  int threads;   // spb * ceil(m / CPT) rounded up to whole warps
  int steps;     // ring steps of kStepRows rows a slab
  int depth;     // ring steps in flight
  int per_sm;    // blocks an SM the plan was sized for (1 or 2)
  int smem;      // dynamic shared memory of the pass
  int finish_smem;
  int work;      // elements of the caller's workspace
};

inline size_t pass_smem(int n, int itemsize, int nb, int mp, int spb,
                        int threads, int steps, int depth) {
  const size_t ring =
      static_cast<size_t>(depth) * kStepRows * threads * (16 / itemsize);
  const size_t us = static_cast<size_t>(steps) * kStepRows * nb;
  const size_t ts = static_cast<size_t>(spb) * n * (mp + 1);
  return itemsize * (ring + us + ts);
}

inline bool make_plan(int m, int n, int itemsize, Plan* p) {
  if (m < 1 || m > kMaxM || n < 1 || n > kMaxN ||
      (itemsize != 4 && itemsize != 8))
    return false;
  const int cpt = 16 / itemsize;
  p->nb = round_up(n, itemsize == 8 ? 2 : 4);
  p->mp = round_up(m, cpt);
  const int tps = p->mp / cpt;
  p->spb = kMaxThreads / tps < kMaxGroup ? kMaxThreads / tps : kMaxGroup;
  p->threads = round_up(p->spb * tps, 32);
  p->steps = (m + kStepRows - 1) / kStepRows;
  p->depth = 0;
  for (int per_sm = 2; per_sm >= 1 && p->depth == 0; --per_sm) {
    const size_t limit = per_sm == 2 ? kTwoBlockSmem : kMaxSmem;
    for (int d = kMaxDepth; d >= (per_sm == 2 ? 3 : 2); --d)
      if (pass_smem(n, itemsize, p->nb, p->mp, p->spb, p->threads, p->steps,
                    d) <= limit) {
        p->depth = d;
        p->per_sm = per_sm;
        break;
      }
  }
  if (p->depth == 0) return false;
  p->smem = static_cast<int>(pass_smem(n, itemsize, p->nb, p->mp, p->spb,
                                       p->threads, p->steps, p->depth));
  p->finish_smem = itemsize * (m * n + n * n * n);
  p->work = m * m * n * n + n * n * n * n + 2 * m * n;
  return true;
}

// Vector loads of NB consecutive values (16-byte aligned) into registers.
template <typename T, int NB>
__device__ __forceinline__ void load_row(const T* p, T (&out)[NB]) {
  if constexpr (sizeof(T) == 8) {
#pragma unroll
    for (int k = 0; k < NB; k += 2) {
      const double2 v = *reinterpret_cast<const double2*>(p + k);
      out[k] = v.x;
      out[k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < NB; k += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + k);
      out[k] = v.x;
      out[k + 1] = v.y;
      out[k + 2] = v.z;
      out[k + 3] = v.w;
    }
  }
}

// The CPT = 16 / sizeof(T) values of one 16-byte slot.
template <typename T, int CPT>
__device__ __forceinline__ void load16(const T* p, T (&out)[CPT]) {
  if constexpr (sizeof(T) == 8) {
    const double2 v = *reinterpret_cast<const double2*>(p);
    out[0] = v.x;
    out[1] = v.y;
  } else {
    const float4 v = *reinterpret_cast<const float4*>(p);
    out[0] = v.x;
    out[1] = v.y;
    out[2] = v.z;
    out[3] = v.w;
  }
}

// X[pair, k, l] = (U^T S_pair U)[k, l] for every slab, one pass over g.
//
// Block b takes the slab groups [floor(b G / B), floor((b+1) G / B)) of
// the G = ceil(m^2 / spb) groups; step t of the block is rows
// [kStepRows (t % steps), + kStepRows) of group t / steps.  Thread (sl, cp)
// = (tid / tps, tid % tps) owns columns [CPT cp, CPT cp + CPT) of slab sl
// of the group (tps = mp / CPT).  Shared memory: the ring (depth,
// kStepRows, threads) of 16-byte slots, each thread's own; U as (steps
// kStepRows, NB) with zero rows past m and zero columns past n; T as (spb,
// n, mp + 1) (an odd row stride: the contraction's reads of n rows at one
// s fall in distinct banks).  The ring starts zeroed, so a thread's
// columns past m (never copied) stay zero, and rows past m (never copied)
// hold zeros or finite values of g that meet zero rows of U.
template <typename T, int NB>
__global__ void __launch_bounds__(kMaxThreads, 2)
orbital_pass(const T* __restrict__ g, const T* __restrict__ u,
             T* __restrict__ X, int m, int n, int mp, int spb, int steps,
             int depth, int vec16) {
  constexpr int CPT = 16 / sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const long long mm = static_cast<long long>(m) * m;
  const int tps = mp / CPT;
  const int tid = threadIdx.x, nthr = blockDim.x;
  const int slot_elems = kStepRows * nthr * CPT;       // one ring step
  const int tsk = mp + 1, tss = n * tsk;
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* us = ring + depth * slot_elems;
  T* ts = us + steps * kStepRows * NB;
  const long long groups = (mm + spb - 1) / spb;
  const long long glo = blockIdx.x * groups / gridDim.x;
  const long long ghi = (blockIdx.x + 1) * groups / gridDim.x;
  const int count = static_cast<int>(ghi - glo) * steps;
  const int sl = tid / tps, cp = tid - sl * tps, col = cp * CPT;
  const bool active = sl < spb;

  for (int e = tid; e < depth * slot_elems; e += nthr) ring[e] = T(0);
  for (int e = tid; e < steps * kStepRows * NB; e += nthr) {
    const int r = e / NB, k = e - r * NB;
    us[e] = r < m && k < n ? u[r * n + k] : T(0);
  }
  __syncthreads();

  // this thread's 16 bytes of rows [r0, r0 + kStepRows) of its slab at
  // step t, into ring slot `slot`
  auto issue = [&](int slot, int t) {
    const int gi = t / steps, r0 = (t - gi * steps) * kStepRows;
    const long long pair = (glo + gi) * spb + sl;
    if (!active || pair >= mm) return;
    const T* src = g + pair * mm + static_cast<long long>(r0) * m + col;
    T* dst = ring + slot * slot_elems + tid * CPT;
#pragma unroll
    for (int rr = 0; rr < kStepRows; ++rr) {
      if (r0 + rr >= m) break;
      if (vec16) {
        cp_async16(dst + rr * nthr * CPT, src + rr * m);
      } else {
#pragma unroll
        for (int c = 0; c < CPT; ++c)
          if (col + c < m)
            cp_async_ca<sizeof(T)>(dst + rr * nthr * CPT + c,
                                   src + rr * m + c);
      }
    }
  };
  for (int st = 0; st < depth - 1; ++st) {
    if (st < count) issue(st, st);
    cp_async_commit();
  }

  T tk[CPT][NB];
#pragma unroll
  for (int c = 0; c < CPT; ++c)
#pragma unroll
    for (int k = 0; k < NB; ++k) tk[c][k] = T(0);

  int slot = 0, refill = depth - 1;    // ring slots of steps t and t+depth-1
  for (int t = 0; t < count; ++t) {
    cp_async_wait_pending(depth - 2);  // this thread's copies of step t
    if (t + depth - 1 < count) issue(refill, t + depth - 1);
    cp_async_commit();
    refill = slot;
    const T* S = ring + slot * slot_elems + tid * CPT;
    slot = slot + 1 == depth ? 0 : slot + 1;
    const int gi = t / steps, st = t - gi * steps;

    if (active) {
      const T* urow = us + st * kStepRows * NB;
#pragma unroll
      for (int rr = 0; rr < kStepRows; ++rr) {
        T x[CPT], uv[NB];
        load16<T, CPT>(S + rr * nthr * CPT, x);
        load_row<T, NB>(urow + rr * NB, uv);
#pragma unroll
        for (int c = 0; c < CPT; ++c)
#pragma unroll
          for (int k = 0; k < NB; ++k) tk[c][k] = fmadd(x[c], uv[k], tk[c][k]);
      }
    }
    if (st + 1 < steps) continue;

    // the group's rows are done: T through shared memory, X = T U
    if (active) {
      T* tw = ts + sl * tss + col;
#pragma unroll
      for (int k = 0; k < NB; ++k)
        if (k < n)
#pragma unroll
          for (int c = 0; c < CPT; ++c) tw[k * tsk + c] = tk[c][k];
    }
#pragma unroll
    for (int c = 0; c < CPT; ++c)
#pragma unroll
      for (int k = 0; k < NB; ++k) tk[c][k] = T(0);
    __syncthreads();                    // T published
    const int lchunks = (n + kLChunk - 1) / kLChunk;
    const long long pair0 = (glo + gi) * spb;
    for (int w = tid; w < spb * n * lchunks; w += nthr) {
      const int lc = w % lchunks, kk = (w / lchunks) % n;
      const int s2 = w / (lchunks * n);
      if (pair0 + s2 >= mm) continue;
      T acc[kLChunk];
#pragma unroll
      for (int j = 0; j < kLChunk; ++j) acc[j] = T(0);
      const T* tr = ts + s2 * tss + kk * tsk;
      const T* ur = us + lc * kLChunk;
#pragma unroll 4
      for (int s = 0; s < m; ++s) {
        const T tv = tr[s];
#pragma unroll
        for (int j = 0; j < kLChunk; ++j)
          acc[j] = fmadd(tv, ur[s * NB + j], acc[j]);
      }
      T* xo = X + (pair0 + s2) * n * n + kk * n + lc * kLChunk;
#pragma unroll
      for (int j = 0; j < kLChunk; ++j)
        if (lc * kLChunk + j < n) xo[j] = acc[j];
    }
    __syncthreads();                    // T read
  }
}

// Gt[i,j,k,l] = (Gamma[i,j,k,l] + Gamma[k,l,i,j]) / 2, n2 = n^2.
template <typename T>
__global__ void orbital_sym(const T* __restrict__ G, T* __restrict__ gt,
                            int n2) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e < n2 * n2) {
    const int ij = e / n2, kl = e - ij * n2;
    gt[e] = T(0.5) * (G[e] + G[kl * n2 + ij]);
  }
}

// Block b < m: row p = b of s1; block b >= m: row q = b - m of s2.
// Thread e < n^2 owns column kl = e: W[a] = sum_x U[x, a] X[pair(x), kl]
// in the order x = 0 .. m-1 (pair(x) = p m + x for W1, x m + q for W2),
// then its share of each output a' over kl, sum_a Gt(a', a)[kl] W[a];
// warp w sums the shares of a' = w, w + 8, ... over kl in a fixed order.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
orbital_finish(const T* __restrict__ X, const T* __restrict__ u,
               const T* __restrict__ gt, T* __restrict__ slots, int m,
               int n) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* us = reinterpret_cast<T*>(smem_raw);      // (m, n)
  T* red = us + m * n;                          // (n, n^2)
  const int side = blockIdx.x / m, row = blockIdx.x - side * m;
  const int n2 = n * n, tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  for (int e = tid; e < m * n; e += blockDim.x) us[e] = u[e];
  __syncthreads();
  if (tid < n2) {
    T w[kMaxN];
#pragma unroll
    for (int a = 0; a < kMaxN; ++a) w[a] = T(0);
    const long long step = side == 0 ? n2 : static_cast<long long>(m) * n2;
    const T* xp = X + (side == 0 ? static_cast<long long>(row) * m * n2
                                 : static_cast<long long>(row) * n2) + tid;
#pragma unroll 8
    for (int x = 0; x < m; ++x) {
      const T xv = xp[x * step];
      const T* ux = us + x * n;
#pragma unroll
      for (int a = 0; a < kMaxN; ++a)
        if (a < n) w[a] = fmadd(ux[a], xv, w[a]);
    }
    for (int o = 0; o < n; ++o) {
      T part = T(0);
#pragma unroll
      for (int a = 0; a < kMaxN; ++a)
        if (a < n) {
          const int ij = side == 0 ? o * n + a : a * n + o;
          part = fmadd(gt[ij * n2 + tid], w[a], part);
        }
      red[o * n2 + tid] = part;
    }
  }
  __syncthreads();
  for (int o = warp; o < n; o += blockDim.x / 32) {
    T s = T(0);
    for (int e = lane; e < n2; e += 32) s += red[o * n2 + e];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0) slots[(side * m + row) * n + o] = s;
  }
}

// grad = 2 (s1 + s2) and E2 = sum U (.) s1, one block, summed in a fixed
// order (each thread its strided share, then the warps' sums in order).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
orbital_combine(const T* __restrict__ slots, const T* __restrict__ u,
                T* __restrict__ out, int mn) {
  __shared__ T red[kMaxThreads / 32];
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  T acc = T(0);
  for (int e = tid; e < mn; e += blockDim.x) {
    out[e] = T(2) * (slots[e] + slots[mn + e]);
    acc = fmadd(u[e], slots[e], acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) red[warp] = acc;
  __syncthreads();
  if (tid == 0) {
    T s = T(0);
    for (int w = 0; w < static_cast<int>(blockDim.x) / 32; ++w) s += red[w];
    out[mn] = s;
  }
}

// A kernel's dynamic shared memory limit raised to `smem` and the blocks
// an SM that it then holds (`per_sm`, when asked), set and asked once a
// device, kernel and size: the attribute stays with the kernel.
template <typename K>
int set_smem(K kernel, size_t smem, int threads = 0, int* per_sm = nullptr) {
  static const void* fn_set = nullptr;
  static int dev_set = -1, smem_set = -1, threads_set = -1, occupancy = 0;
  const void* fn = reinterpret_cast<const void*>(kernel);
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (fn != fn_set || dev != dev_set || static_cast<int>(smem) != smem_set ||
      threads != threads_set) {
    rc = static_cast<int>(cudaFuncSetAttribute(
        fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem)));
    if (rc != 0) return rc;
    occupancy = 0;
    if (threads > 0) {
      rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &occupancy, kernel, threads, smem));
      if (rc != 0) return rc;
    }
    fn_set = fn;
    dev_set = dev;
    smem_set = static_cast<int>(smem);
    threads_set = threads;
  }
  if (per_sm != nullptr) *per_sm = occupancy;
  return 0;
}

template <typename T, int NB>
int launch_pass(const T* g, const T* u, T* X, int m, int n, const Plan& p,
                int sms, int vec16, cudaStream_t stream) {
  auto kernel = orbital_pass<T, NB>;
  int per_sm = 0;
  const int rc = set_smem(kernel, p.smem, p.threads, &per_sm);
  if (rc != 0) return rc;
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  per_sm = per_sm < p.per_sm ? per_sm : p.per_sm;
  const long long groups = (static_cast<long long>(m) * m + p.spb - 1) / p.spb;
  const int blocks = static_cast<int>(
      groups < static_cast<long long>(sms) * per_sm ? groups : sms * per_sm);
  kernel<<<blocks, p.threads, p.smem, stream>>>(g, u, X, m, n, p.mp, p.spb,
                                                p.steps, p.depth, vec16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_pass(const T* g, const T* u, T* X, int m, int n, const Plan& p,
                  int sms, int vec16, cudaStream_t stream) {
  if constexpr (sizeof(T) == 8) {
    switch (p.nb) {
      case 2: return launch_pass<T, 2>(g, u, X, m, n, p, sms, vec16, stream);
      case 4: return launch_pass<T, 4>(g, u, X, m, n, p, sms, vec16, stream);
      case 6: return launch_pass<T, 6>(g, u, X, m, n, p, sms, vec16, stream);
      case 8: return launch_pass<T, 8>(g, u, X, m, n, p, sms, vec16, stream);
      case 10: return launch_pass<T, 10>(g, u, X, m, n, p, sms, vec16, stream);
      case 12: return launch_pass<T, 12>(g, u, X, m, n, p, sms, vec16, stream);
      case 14: return launch_pass<T, 14>(g, u, X, m, n, p, sms, vec16, stream);
      default: return launch_pass<T, 16>(g, u, X, m, n, p, sms, vec16, stream);
    }
  } else {
    switch (p.nb) {
      case 4: return launch_pass<T, 4>(g, u, X, m, n, p, sms, vec16, stream);
      case 8: return launch_pass<T, 8>(g, u, X, m, n, p, sms, vec16, stream);
      case 12: return launch_pass<T, 12>(g, u, X, m, n, p, sms, vec16, stream);
      default: return launch_pass<T, 16>(g, u, X, m, n, p, sms, vec16, stream);
    }
  }
}

// work: X (m^2 n^2), Gt (n^4), s1 and s2 (2 m n); out: grad (m n), E2.
template <typename T>
int orbital_vag(const T* g, const T* u, const T* Gamma, T* work, T* out,
                int m, int n, int sms, cudaStream_t stream) {
  Plan p;
  if (sms < 1 || !make_plan(m, n, sizeof(T), &p) ||
      static_cast<size_t>(p.finish_smem) > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  const int n2 = n * n, n4 = n2 * n2;
  T* X = work;
  T* gt = X + static_cast<size_t>(m) * m * n2;
  T* slots = gt + n4;
  orbital_sym<T><<<(n4 + kMaxThreads - 1) / kMaxThreads, kMaxThreads, 0,
                   stream>>>(Gamma, gt, n2);
  int rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  const int vec16 =
      (static_cast<size_t>(m) * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(g) % 16 == 0;
  rc = dispatch_pass<T>(g, u, X, m, n, p, sms, vec16, stream);
  if (rc != 0) return rc;
  rc = set_smem(orbital_finish<T>, p.finish_smem);
  if (rc != 0) return rc;
  orbital_finish<T><<<2 * m, kMaxThreads, p.finish_smem, stream>>>(
      X, u, gt, slots, m, n);
  rc = static_cast<int>(cudaGetLastError());
  if (rc != 0) return rc;
  orbital_combine<T><<<1, kMaxThreads, 0, stream>>>(slots, u, out, m * n);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTile = 32;          // pair_asym_tiles: a 32 x 32 tile pair
constexpr int kTileRows = 8;       // ... read by 32 x 8 threads

// Block (J, I) with I <= J: tiles A = G2[I, J] and B = G2[J, I] (32 x 32,
// zero past n2 = m^2), each read in rows into shared memory; partials[2 b]
// = max |A[r][c] - B[c][r]| and partials[2 b + 1] = max(|A|, |B|) over the
// tile pair (b = I tiles + J; blocks with I > J write zeros).  Every
// element of G2 lies in exactly one tile pair, and a max is exact in any
// order.
template <typename T>
__global__ void __launch_bounds__(kTile * kTileRows)
pair_asym_tiles(const T* __restrict__ G, T* __restrict__ partials, int n2) {
  __shared__ T a[kTile][kTile + 1], b[kTile][kTile + 1];
  __shared__ T red[2][kTile * kTileRows / 32];
  const int J = blockIdx.x, I = blockIdx.y;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * kTile + tx, warp = tid / 32, lane = tid % 32;
  T dmax = T(0), gmax = T(0);
  if (I <= J) {
#pragma unroll
    for (int r = ty; r < kTile; r += kTileRows) {
      const long long ra = static_cast<long long>(I) * kTile + r;
      const long long rb = static_cast<long long>(J) * kTile + r;
      const int ca = J * kTile + tx, cb = I * kTile + tx;
      a[r][tx] = ra < n2 && ca < n2 ? G[ra * n2 + ca] : T(0);
      b[r][tx] = rb < n2 && cb < n2 ? G[rb * n2 + cb] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int r = ty; r < kTile; r += kTileRows) {
      dmax = fmax(dmax, fabs(a[r][tx] - b[tx][r]));
      gmax = fmax(gmax, fmax(fabs(a[r][tx]), fabs(b[r][tx])));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    dmax = fmax(dmax, __shfl_xor_sync(0xffffffffu, dmax, off));
    gmax = fmax(gmax, __shfl_xor_sync(0xffffffffu, gmax, off));
  }
  if (lane == 0) {
    red[0][warp] = dmax;
    red[1][warp] = gmax;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < kTile * kTileRows / 32; ++w) {
      dmax = fmax(dmax, red[0][w]);
      gmax = fmax(gmax, red[1][w]);
    }
    const long long blk = static_cast<long long>(I) * gridDim.x + J;
    partials[2 * blk] = dmax;
    partials[2 * blk + 1] = gmax;
  }
}

template <typename T>
int pair_asymmetry(const T* g, T* partials, int m, cudaStream_t stream) {
  if (m < 1 || m > kMaxM) return static_cast<int>(cudaErrorInvalidValue);
  const int n2 = m * m, tiles = (n2 + kTile - 1) / kTile;
  pair_asym_tiles<T><<<dim3(tiles, tiles), dim3(kTile, kTileRows), 0,
                       stream>>>(g, partials, n2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (max |g - g^(r,s,p,q)|, max |g|) over each tile pair of G2 = g as
// (m^2, m^2) into partials (T^2 pairs of values, T = ceil(m^2 / 32));
// the caller takes the maxima.
extern "C" int esoo_pair_asymmetry_f32(const void* g, void* partials, int m,
                                       void* stream) {
  return pair_asymmetry<float>(static_cast<const float*>(g),
                               static_cast<float*>(partials), m,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int esoo_pair_asymmetry_f64(const void* g, void* partials, int m,
                                       void* stream) {
  return pair_asymmetry<double>(static_cast<const double*>(g),
                                static_cast<double*>(partials), m,
                                static_cast<cudaStream_t>(stream));
}

// The plan at (m, n, itemsize): nb, mp, spb, threads, steps, depth,
// per_sm, smem, finish_smem, work into out[0..10); 0, or
// cudaErrorInvalidValue for a shape the kernel does not take.
extern "C" int esoo_orbital_vag_plan(int m, int n, int itemsize, int* out) {
  Plan p;
  if (!make_plan(m, n, itemsize, &p))
    return static_cast<int>(cudaErrorInvalidValue);
  const int fields[kPlanFields] = {p.nb, p.mp, p.spb,
                                   p.threads, p.steps, p.depth, p.per_sm,
                                   p.smem, p.finish_smem, p.work};
  for (int i = 0; i < kPlanFields; ++i) out[i] = fields[i];
  return 0;
}

extern "C" int esoo_orbital_vag_f32(const void* g, const void* u,
                                    const void* Gamma, void* work, void* out,
                                    int m, int n, int sms, void* stream) {
  return orbital_vag<float>(
      static_cast<const float*>(g), static_cast<const float*>(u),
      static_cast<const float*>(Gamma), static_cast<float*>(work),
      static_cast<float*>(out), m, n, sms, static_cast<cudaStream_t>(stream));
}

extern "C" int esoo_orbital_vag_f64(const void* g, const void* u,
                                    const void* Gamma, void* work, void* out,
                                    int m, int n, int sms, void* stream) {
  return orbital_vag<double>(
      static_cast<const double*>(g), static_cast<const double*>(u),
      static_cast<const double*>(Gamma), static_cast<double*>(work),
      static_cast<double*>(out), m, n, sms, static_cast<cudaStream_t>(stream));
}
