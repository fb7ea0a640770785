// The 4-index integral transform in one pass over g (sm_90a, CUDA cores).
//
//   g_rot[i,j,k,l] = sum_pqrs g[p,q,r,s] u[p,i] u[q,j] u[r,k] u[s,l]
//
// Replaces esoo_tpu/ops/pallas_kernels.py:108 rotate_two_body_pallas (four
// chained Pallas GEMMs) for an active dimension n <= 8; larger n keeps the
// four-launch chain of csrc/gemm.cu (esoo_torch/ops/gemm.py).
//
// What bounds it on an H100: bytes.  It must read g once and write the
// n^4 result: 4 (m^4 + m n + n^4) bytes, 39.3 MB at m=56, n=4 in float32,
// 11.74 us at 3.35 TB/s.  Its work, 85 MFLOP at n=4 and 183 MFLOP at n=8
// (see transform_slab_pass), is far under the float32 FMA pipe
// (67 TFLOP/s).  The design:
//
//   * One pass.  g is m^2 contiguous slabs S_pq = g[p,q,:,:].  Block b of
//     B takes the pairs [floor(b m^2 / B), floor((b+1) m^2 / B)), one
//     contiguous stretch of g, so the grid reads g exactly once and in
//     order.  The m^3 n stage-1 intermediate of the chain never reaches
//     device memory.
//   * The sum in the order that costs least per slab (see
//     transform_slab_pass): a thread owns one column s of every slab and
//     keeps T'[k] = sum_r u[r,k] S_pq[r,s] and Y[j][k] += u[q,j] T'[k] in
//     registers; when p changes, the block contracts Y with u[s,l] and
//     u[p,i] into its n^4 accumulators (registers of its 256 threads, at
//     most 16 a thread).  One barrier a slab.  On the headline shape the
//     loop is bound by instruction issue and the shared-memory pipe, not
//     by FLOPs, so its fast path (float, n <= 4, m <= 64 and a multiple of
//     4) keeps each thread's 16 rows of u in registers and lays slabs out
//     at a fixed row stride of 64: per element of g, one shared load at an
//     immediate offset and n FMAs.  A first design (T = S u and
//     A = u^T T in every slab, three barriers, u read from shared memory)
//     was bound by its per-slab barriers and shuffles and by the broadcast
//     loads of u, not by HBM.
//   * Bytes in flight.  Shared memory holds a ring of `stages` slabs (2 to
//     8, as many as let two blocks share an SM); the copies of the next
//     stages - 1 slabs are in flight while the block computes one
//     (cp.async: 16-byte cg copies where the slab size and g's address
//     allow, else element-wise ca copies), against one 4-byte load a
//     thread in the chain's stage 1.
//   * Deterministic cross-block sum.  Each block writes its n^4 partial to
//     partials[b]; a second small kernel stages them in shared memory with
//     one round of copies and sums partials[0..B) in index order.  No
//     atomics: two calls on the same inputs agree bit for bit.
//   * One host call.  esoo_transform_f32 / esoo_transform_f64 make both
//     launches and return the first non-zero cudaGetLastError(); the chain
//     took four Python wrapper calls.
//   * FFMA on the CUDA cores in the element type (float or double), no
//     TF32 (the package's precision rule).
//
// C interface (ctypes): launches on the given stream, allocates nothing.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxN = 8;
constexpr int kMaxM = kThreads;              // a thread to a column of a slab
constexpr int kMaxStages = 8;
constexpr int kYRow = 16;                    // values of Y a thread publishes
constexpr size_t kMaxSmem = 232448;          // 227 KB a block may use

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

// wait until at most `pending` (0 .. kMaxStages - 2) groups are in flight
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

// elements of one slab in the ring: m^2 rounded up to 16 bytes
__host__ __device__ inline int slab_stride(int m, int itemsize) {
  const int per16 = 16 / itemsize;
  return (m * m + per16 - 1) / per16 * per16;
}

// u is kept (m, NB) with zero columns n..NB, NB = 4 or 8
__host__ __device__ inline int padded_n(int n) { return n <= 4 ? 4 : 8; }

// The fast path: float, n <= 4, m <= 64 and a multiple of 4, g 16-byte
// aligned.  Slabs sit in the ring as 64 x 64 (rows at a fixed stride, so
// the column loop addresses them with immediate offsets, rows past m zero)
// and each thread keeps its 16 rows of u in registers.
constexpr int kFastM = 64;

__host__ inline bool fast_path(int m, int n, int itemsize) {
  return itemsize == 4 && n <= 4 && m <= kFastM && m % 4 == 0;
}

// ring, u (m, NB), Y (256 threads x 16), V (NB, NB, NB)
__host__ inline size_t smem_bytes(int m, int n, int itemsize, int stages,
                                  bool fast) {
  const int nb = padded_n(n);
  const size_t slab = fast ? kFastM * kFastM : slab_stride(m, itemsize);
  return static_cast<size_t>(itemsize) *
         (stages * slab + m * nb + kThreads * kYRow + nb * nb * nb);
}

// Copy slab `pair` of g into ring buffer `dst` (each thread its share).
template <typename T>
__device__ __forceinline__ void load_slab(T* dst, const T* g, int pair,
                                          int mm, bool vec16) {
  const T* src = g + static_cast<size_t>(pair) * mm;
  if (vec16) {
    constexpr int per16 = 16 / sizeof(T);
    const int chunks = mm / per16;
    for (int c = threadIdx.x; c < chunks; c += kThreads)
      cp_async16(dst + c * per16, src + c * per16);
  } else {
    for (int e = threadIdx.x; e < mm; e += kThreads)
      cp_async_ca<sizeof(T)>(dst + e, src + e);
  }
}

// Fast path: slab `pair` into `dst` as rows of stride 64 (16-byte copies,
// a thread a 16-byte column chunk of every 16th row).
__device__ __forceinline__ void load_slab_rows(float* dst, const float* g,
                                               int pair, int m) {
  const float* src = g + static_cast<size_t>(pair) * m * m;
  const int c4 = threadIdx.x % 16 * 4;
  if (c4 < m)
    for (int r = threadIdx.x / 16; r < m; r += kThreads / 16)
      cp_async16(dst + r * kFastM + c4, src + r * m + c4);
}

template <typename T, int NB>
__device__ __forceinline__ const T* row_of(const T* base, int r) {
  return static_cast<const T*>(__builtin_assume_aligned(base + r * NB, 16));
}

// One block: its contiguous range of slabs, its n^4 partial to partials[b].
// NB (4 or 8) bounds n; a thread holds NB^4 / 256 accumulators.
//
//   acc[i,j,k,l] = sum_p u[p,i] V_p[j,k,l],
//   V_p[j,k,l]   = sum_s u[s,l] Y_p[j,k,s],
//   Y_p[j,k,s]   = sum_q u[q,j] sum_r u[r,k] S_pq[r,s].
//
// Thread (s, grp) owns column s of every slab and the rows r = grp mod G
// (C = 64, 128 or 256 columns, G = 256 / C row groups): per slab it forms
// T'[k] = sum_r u[r,k] S[r,s] and Y[j][k] += u[q,j] T'[k].  A broadcast
// vector load of u[r,:] costs the shared-memory pipe as much as four loads
// of the slab, so on the FAST path (see kFastM) the thread keeps its 16
// rows of u in registers and reads the slab with immediate offsets: one
// shared load and four FMAs a row.  Otherwise u comes from shared memory
// and the loop reads four rows ahead.
// When p changes (or the range ends) the block publishes Y through shared
// memory (16 values a thread a round, neighbouring s on neighbouring
// words), each warp sums its share over s and the row groups into V_p,
// and every thread adds u[p,i] V_p to its accumulators.
template <typename T, int NB, bool FAST>
__global__ void __launch_bounds__(kThreads, 2)
transform_slab_pass(const T* __restrict__ g, const T* __restrict__ u,
                    T* __restrict__ partials, int m, int n, int stages,
                    int vec16) {
  constexpr int NACC = (NB * NB * NB * NB + kThreads - 1) / kThreads;
  constexpr int JR = kYRow / NB;               // rows j of Y a round
  constexpr int UROWS = FAST ? kFastM / 4 : 1;   // FAST: G = 4 row groups
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int mm = m * m, n2 = n * n, n3 = n2 * n, n4 = n2 * n2;
  const int stride = FAST ? kFastM * kFastM : slab_stride(m, sizeof(T));
  T* ring = reinterpret_cast<T*>(smem_raw);
  T* us = ring + stages * stride;                      // u (m, NB)
  T* ys = us + m * NB;                                 // (G, 16, C)
  T* vs = ys + kThreads * kYRow;                       // V (n, n, n)
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int C = m <= 64 ? 64 : (m <= 128 ? 128 : 256);
  const int G = kThreads / C;
  const int s = tid % C, grp = tid / C;
  const int lo = static_cast<int>(
      static_cast<long long>(blockIdx.x) * mm / gridDim.x);
  const int hi = static_cast<int>(
      static_cast<long long>(blockIdx.x + 1) * mm / gridDim.x);
  const int count = hi - lo;

  auto fill = [&](int slot, int pair) {
    if constexpr (FAST)
      load_slab_rows(ring + slot * stride, g, pair, m);
    else
      load_slab(ring + slot * stride, g, pair, mm, vec16);
  };
  for (int st = 0; st < stages - 1; ++st) {
    if (st < count) fill(st, lo + st);
    cp_async_commit();
  }
  if constexpr (FAST)                  // rows m..63, never copied into
    for (int e = tid; e < stages * (kFastM - m) * kFastM; e += kThreads) {
      const int slot = e / ((kFastM - m) * kFastM);
      const int rest = e - slot * (kFastM - m) * kFastM;
      ring[slot * stride + m * kFastM + rest] = T(0);
    }
  for (int e = tid; e < m * NB; e += kThreads) {
    const int r = e / NB, l = e - r * NB;
    us[e] = l < n ? u[r * n + l] : T(0);
  }
  __syncthreads();
  T ureg[UROWS][NB];                   // u[grp + 4 i, :] (FAST: G = 4)
#pragma unroll
  for (int i = 0; i < UROWS; ++i)
#pragma unroll
    for (int k = 0; k < NB; ++k) {
      const int r = grp + 4 * i;
      ureg[i][k] = FAST && r < m ? us[r * NB + k] : T(0);
    }

  T acc[NACC];
#pragma unroll
  for (int a = 0; a < NACC; ++a) acc[a] = T(0);
  T Y[NB][NB];                                         // Y[j][k], column s
#pragma unroll
  for (int j = 0; j < NB; ++j)
#pragma unroll
    for (int k = 0; k < NB; ++k) Y[j][k] = T(0);

  int p = lo / m, q = lo - p * m;
  int slot = 0, refill = stages - 1;   // ring slots of slab t and t+stages-1
  for (int t = 0; t < count; ++t) {
    cp_async_wait_pending(stages - 2);  // slab t has landed (this thread)
    __syncthreads();                    // ... every thread's; slab t-1 read
    if (t + stages - 1 < count)         // refill the buffer of slab t-1
      fill(refill, lo + t + stages - 1);
    cp_async_commit();
    refill = slot;
    const T* S = ring + slot * stride + s;
    slot = slot + 1 == stages ? 0 : slot + 1;

    if (s < m) {
      T tk[NB];
#pragma unroll
      for (int k = 0; k < NB; ++k) tk[k] = T(0);
      if constexpr (FAST) {
        const T* Sg = S + grp * kFastM;              // rows grp + 4 i
#pragma unroll
        for (int i0 = 0; i0 < UROWS; i0 += 8) {
          T x[8];
#pragma unroll
          for (int i = 0; i < 8; ++i) x[i] = Sg[(i0 + i) * 4 * kFastM];
#pragma unroll
          for (int i = 0; i < 8; ++i)
#pragma unroll
            for (int k = 0; k < NB; ++k)
              tk[k] = fmadd(x[i], ureg[i0 + i][k], tk[k]);
        }
      } else {
        for (int r0 = grp; r0 < m; r0 += 4 * G) {
          T x[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int r = r0 + i * G;
            x[i] = r < m ? S[r * m] : T(0);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const T* ur = row_of<T, NB>(us, min(r0 + i * G, m - 1));
#pragma unroll
            for (int k = 0; k < NB; ++k) tk[k] = fmadd(x[i], ur[k], tk[k]);
          }
        }
      }
      const T* uq = row_of<T, NB>(us, q);
#pragma unroll
      for (int j = 0; j < NB; ++j) {
        const T w = uq[j];
#pragma unroll
        for (int k = 0; k < NB; ++k) Y[j][k] = fmadd(w, tk[k], Y[j][k]);
      }
    }
    if (++q < m && t + 1 < count) continue;       // p goes on

    // V_p[j,k,l] = sum_s u[s,l] sum_grp Y[j][k](s, grp), JR rows j a round
#pragma unroll
    for (int j0 = 0; j0 < NB; j0 += JR) {
      if (j0 >= n) break;
      __syncthreads();                  // ys free (earlier readers done)
#pragma unroll
      for (int v = 0; v < kYRow; ++v)
        ys[(grp * kYRow + v) * C + s] = Y[j0 + v / NB][v % NB];
      __syncthreads();
      for (int v = warp; v < kYRow; v += kThreads / 32) {
        const int j = j0 + v / NB, k = v % NB;
        if (j >= n || k >= n) continue;           // whole warp
        T z[NB];
#pragma unroll
        for (int l = 0; l < NB; ++l) z[l] = T(0);
        for (int c = lane; c < m; c += 32) {
          T y = ys[v * C + c];
          for (int h = 1; h < G; ++h) y += ys[(h * kYRow + v) * C + c];
          const T* uc = row_of<T, NB>(us, c);
#pragma unroll
          for (int l = 0; l < NB; ++l) z[l] = fmadd(y, uc[l], z[l]);
        }
#pragma unroll
        for (int l = 0; l < NB; ++l)
#pragma unroll
          for (int off = 16; off > 0; off >>= 1)
            z[l] += __shfl_xor_sync(0xffffffffu, z[l], off);
        if (lane == 0)
#pragma unroll
          for (int l = 0; l < NB; ++l)
            if (l < n) vs[(j * n + k) * n + l] = z[l];
      }
    }
    __syncthreads();
#pragma unroll
    for (int a = 0; a < NACC; ++a) {    // acc += u[p,i] V_p[j,k,l]
      const int e = tid + a * kThreads;
      if (e < n4) {
        const int i = e / n3;
        acc[a] = fmadd(us[p * NB + i], vs[e - i * n3], acc[a]);
      }
    }
#pragma unroll
    for (int j = 0; j < NB; ++j)
#pragma unroll
      for (int k = 0; k < NB; ++k) Y[j][k] = T(0);
    ++p;
    q = 0;
  }
  T* out = partials + static_cast<size_t>(blockIdx.x) * n4;
#pragma unroll
  for (int a = 0; a < NACC; ++a) {
    const int e = tid + a * kThreads;
    if (e < n4) out[e] = acc[a];
  }
}

// out[e] = sum over b = 0 .. blocks-1, in that order, of partials[b, e].
// A block takes 32 columns e: all its threads copy the (blocks, 32) tile
// into shared memory at once (one round of copies), then one warp sums
// each column in order.
constexpr int kReduceCols = 32;

template <typename T>
__global__ void __launch_bounds__(kThreads)
transform_reduce(const T* __restrict__ partials, T* __restrict__ out,
                 int blocks, int n4) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* tile = reinterpret_cast<T*>(smem_raw);        // (blocks, 32)
  const int e0 = blockIdx.x * kReduceCols;
  const int cols = min(kReduceCols, n4 - e0);
  const int col = threadIdx.x % kReduceCols;
  if (col < cols)
    for (int b = threadIdx.x / kReduceCols; b < blocks;
         b += kThreads / kReduceCols)
      cp_async_ca<sizeof(T)>(tile + b * kReduceCols + col,
                             partials + static_cast<size_t>(b) * n4 + e0 +
                                 col);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();
  if (threadIdx.x < cols) {
    constexpr int kBatch = 16;          // loads in flight ahead of the adds
    const T* col_p = tile + threadIdx.x;
    T sum = T(0);
    int b = 0;
    for (; b + kBatch <= blocks; b += kBatch) {
      T v[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) v[i] = col_p[(b + i) * kReduceCols];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) sum += v[i];
    }
    for (; b < blocks; ++b) sum += col_p[b * kReduceCols];
    out[e0 + threadIdx.x] = sum;
  }
}

template <typename K>
int set_smem(K kernel, size_t smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem)));
}

template <typename T, int NB, bool FAST>
int launch_pass(const T* g, const T* u, T* partials, int m, int n,
                int blocks, int stages, int vec16, size_t smem,
                cudaStream_t stream) {
  auto kernel = transform_slab_pass<T, NB, FAST>;
  const int rc = set_smem(kernel, smem);
  if (rc != 0) return rc;
  kernel<<<blocks, kThreads, smem, stream>>>(g, u, partials, m, n, stages,
                                             vec16);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int transform(const T* g, const T* u, T* partials, T* out, int m, int n,
              int blocks, int stages, cudaStream_t stream) {
  const int vec16 =
      (static_cast<size_t>(m) * m * sizeof(T)) % 16 == 0 &&
      reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const bool fast = vec16 && fast_path(m, n, sizeof(T));
  const size_t smem = smem_bytes(m, n, sizeof(T), stages, fast);
  const size_t reduce_smem =
      static_cast<size_t>(blocks) * kReduceCols * sizeof(T);
  if (m < 1 || m > kMaxM || n < 1 || n > kMaxN || blocks < 1 ||
      stages < 2 || stages > kMaxStages || smem > kMaxSmem ||
      reduce_smem > kMaxSmem)
    return static_cast<int>(cudaErrorInvalidValue);
  int rc;
  if (n > 4)
    rc = launch_pass<T, 8, false>(g, u, partials, m, n, blocks, stages, vec16,
                                  smem, stream);
  else if (fast && sizeof(T) == 4)
    rc = launch_pass<float, 4, true>(
        reinterpret_cast<const float*>(g), reinterpret_cast<const float*>(u),
        reinterpret_cast<float*>(partials), m, n, blocks, stages, vec16, smem,
        stream);
  else
    rc = launch_pass<T, 4, false>(g, u, partials, m, n, blocks, stages, vec16,
                                  smem, stream);
  if (rc != 0) return rc;
  const int n4 = n * n * n * n;
  rc = set_smem(transform_reduce<T>, reduce_smem);
  if (rc != 0) return rc;
  transform_reduce<T><<<(n4 + kReduceCols - 1) / kReduceCols, kThreads,
                        reduce_smem, stream>>>(partials, out, blocks, n4);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int esoo_transform_f32(const void* g, const void* u,
                                  void* partials, void* out, int m, int n,
                                  int blocks, int stages, void* stream) {
  return transform<float>(static_cast<const float*>(g),
                          static_cast<const float*>(u),
                          static_cast<float*>(partials),
                          static_cast<float*>(out), m, n, blocks, stages,
                          static_cast<cudaStream_t>(stream));
}

extern "C" int esoo_transform_f64(const void* g, const void* u,
                                  void* partials, void* out, int m, int n,
                                  int blocks, int stages, void* stream) {
  return transform<double>(static_cast<const double*>(g),
                           static_cast<const double*>(u),
                           static_cast<double*>(partials),
                           static_cast<double*>(out), m, n, blocks, stages,
                           static_cast<cudaStream_t>(stream));
}
