// Hand-written GEMM for the integral transform (sm_90a, CUDA cores).
//
// Replaces esoo_tpu/ops/pallas_kernels.py:43 _matmul_kernel / :57
// matmul_pallas (the Pallas tiled (M, K) @ (K, N) with an f32 VMEM
// accumulator, pl.pallas_call at :80) and, through four launches from
// esoo_torch/ops/gemm.py, the n > 8 route of its rotate_two_body_pallas
// 4-index transform (:108).
//
// gemm_narrow_ring: out = x^T y with x stored (K, M) row-major, y (K, N),
// N <= 16, out (M, N) row-major.  It runs every stage of the transform's
// chain, which contracts the LEADING axis of g (x is read as stored; the
// Pallas wrapper's g.reshape(m, m^3).T would materialize a transposed copy
// of the m^4 tensor).
//
// What bounds it on an H100: bytes.  It must read x and y once and write
// out once, (K M + K N + M N) elements: 719 MB in float32 at stage 1 of
// (m, n) = (112, 16), 0.215 ms at 3.35 TB/s.  Its 2 K M N FLOPs (5.0 G
// there) take 0.075 ms at the 67 TFLOP/s float32 CUDA-core peak.  The first
// design (gemm_narrow_tx: a thread per output row, 4-byte loads of
// x eight k ahead in registers) was bound by its per-element work: 23.5
// instructions per element of x at N = 16, and loads in flight only
// while a thread waited, so its time rose 58 % from N = 4 to 16 while the
// bytes rose 10 %.  This design answers each of those costs:
//
//   * Rows blocked in registers, 16-byte accesses.  A thread owns R
//     consecutive rows of out (R = 4 at float32, 2 at float64: one 16-byte
//     vector of x a k).  For each k it reads that vector and y[k, 0:NB] as
//     16-byte broadcast vectors from shared memory, once for its R rows,
//     and does R * NB FMAs: at N = 16, 64 FFMA and 5 LDS.128 per 16 bytes
//     of x, where the FFMAs set the floor (~45 % of the FP32 pipe at the
//     full memory rate).  Accumulators are in the element type.
//   * x through a ring of cp.async copies.  Each thread copies its own 16
//     bytes of x for each k-row of a stage (kStageK rows) into a ring of
//     kRing stages in dynamic shared memory and later reads back only what
//     it copied, so the ring needs cp.async.wait_group and no barrier.  The
//     copies of the next kRing - 1 stages (64 KB a block, one block an SM)
//     are in flight while the thread computes one, with no register
//     holding a load; stages of 16 k-rows keep the steps of a
//     latency-bound small stage few (7 at K = 112).  The ring runs on
//     across tiles, so a block's next tile is in flight while it stores
//     the last one.  16-byte copies need
//     x's rows 16-byte aligned (M * sizeof(T) % 16 == 0, x aligned);
//     otherwise (M = 17, say) the same kernel copies element by element
//     (VEC = false).  Copies past M, past K or past the tile zero-fill, so
//     the ragged edge computes zeros that are never stored.
//   * y staged once a block: y is at most K x 16 elements (7 KB at m =
//     112), kept as (K, NB) with zero columns N..NB and copied by cp.async
//     with the ring's first stage.  A K whose y exceeds kYBytes is staged
//     in chunks, between two barriers, at the start of each chunk of every
//     tile.
//   * Coalesced output.  A warp's 32 R rows of out are 32 R N contiguous
//     elements.  The warp stages 8 lanes' rows at a time in shared memory
//     (an odd stride of 16-byte chunks: no bank conflicts) and writes them
//     back with 16-byte stores, neighbouring lanes on neighbouring chunks.
//   * Persistent grid.  SMs x (blocks an SM, from
//     cudaOccupancyMaxActiveBlocksPerMultiprocessor; cached with the SM
//     count at the first launch on a device) blocks, and no more than one
//     a warp's worth of rows, so a small stage (M = 4096 at stage 4) still
//     spreads over the SMs.  Tiles of 256 groups of R rows go to the
//     blocks in rounds, so all blocks read neighbouring columns of x at
//     the same time (a contiguous range a block scattered the copies over
//     the whole of x at once, and even copying alone fell well short of
//     the memory rate); the groups past the last full round are split
//     evenly over the blocks as one narrower last tile, so no block waits
//     on another (no tail wave).
//     The grid is 1-D, so M up to 2^31 - 1 runs.
//   * Deterministic: every output element is one thread's sum over k in
//     k order; two calls return the same bits.
//   * FFMA on the CUDA cores in the element type, no tensor cores: TF32
//     is forbidden by the package's precision rule, and once the
//     instruction cost is gone the kernel is memory-bound, which the FP32
//     pipe suffices for.
//
// gemm_tiled: everything else (N > 16, or x stored (M, K)), a 64x64x16
// shared-memory tile, 256 threads of 4x4 outputs.  No main path runs it.
//
// C interface (ctypes): esoo_matmul_f32 / esoo_matmul_f64 launch on the
// given stream, allocate nothing, and return the first non-zero CUDA error;
// esoo_matmul_narrow_plan reports the narrow kernel's launch plan.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

constexpr int kThreads = 256;

// ---- narrow N, x stored (K, M) ------------------------------------------
constexpr int kRing = 2;             // stages in the ring
constexpr int kStageK = 16;          // k-rows of x a stage
constexpr int kYBytes = 16384;       // the y chunk in shared memory
constexpr int kOutLanes = 8;         // lanes a warp stages a round
constexpr int kRingBytes = kRing * kStageK * kThreads * 16;
constexpr int kMaxDevices = 64;

// ring, y chunk, per-warp output staging (kOutLanes lanes x NB + 1 chunks)
__host__ __device__ constexpr int narrow_smem_bytes(int nb) {
  return kRingBytes + kYBytes + (kThreads / 32) * kOutLanes * (nb + 1) * 16;
}

template <typename T>
struct Vec16;
template <>
struct Vec16<float> {
  using type = float4;
  static constexpr int n = 4;
  __device__ static void unpack(const float4& v, float* o) {
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};
template <>
struct Vec16<double> {
  using type = double2;
  static constexpr int n = 2;
  __device__ static void unpack(const double2& v, double* o) {
    o[0] = v.x; o[1] = v.y;
  }
};

// cp.async of 16 bytes (cg) or of one element (ca); `valid` false copies
// nothing and fills the destination with zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(s), "l"(src), "r"(valid ? 16 : 0) : "memory");
}

template <int BYTES>
__device__ __forceinline__ void cp_async_elem(void* dst, const void* src,
                                              bool valid) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(s), "l"(src), "n"(BYTES), "r"(valid ? BYTES : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// out = x^T y; see the note at the top.  NB (4, 8 or 16) bounds N; VEC
// takes 16-byte copies of x (rows 16-byte aligned), else element copies.
template <typename T, int NB, bool VEC>
__global__ void __launch_bounds__(kThreads, 1)
gemm_narrow_ring(const T* __restrict__ x, const T* __restrict__ y,
                 T* __restrict__ out, int M, int K, int N) {
  using V = typename Vec16<T>::type;
  constexpr int R = Vec16<T>::n;                 // rows of out a thread
  constexpr int KY = kYBytes / (NB * static_cast<int>(sizeof(T)));
  constexpr int P = NB + 1;                      // chunks a staged lane
  static_assert(KY % kStageK == 0, "a y chunk holds whole stages");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  V* ring = reinterpret_cast<V*>(smem_raw);
  T* ys = reinterpret_cast<T*>(smem_raw + kRingBytes);
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  T* staged = reinterpret_cast<T*>(smem_raw + kRingBytes + kYBytes) +
              warp * kOutLanes * P * R;

  // Tiles of 256 groups of R rows, in rounds over the B blocks: tile t of
  // block b holds the groups [(t B + b) 256, +256), so the blocks read
  // neighbouring columns of x at the same time.  The groups past the last
  // full round are split evenly over the blocks as one narrower last tile.
  const long long groups = (static_cast<long long>(M) + R - 1) / R;
  const long long round = static_cast<long long>(gridDim.x) * kThreads;
  const int full = static_cast<int>(groups / round);
  const long long rest0 = full * round, rest = groups - rest0;
  const long long plo = rest0 + blockIdx.x * rest / gridDim.x;
  const long long phi = rest0 + (blockIdx.x + 1) * rest / gridDim.x;
  const int tiles = full + (phi > plo ? 1 : 0);
  auto tile_lo = [&](int t) {
    return t < full ? (static_cast<long long>(t) * gridDim.x + blockIdx.x) *
                          kThreads
                    : plo;
  };
  auto tile_hi = [&](int t, long long lo) {
    return t < full ? lo + kThreads : phi;
  };
  const int nks = max(1, (K + kStageK - 1) / kStageK);    // stages a tile
  const int krows = nks * kStageK;                       // k, zero-padded
  const int ychunks = (krows + KY - 1) / KY;
  const int steps = tiles * nks;

  // rows [c KY, c KY + KY) of y as (KY, NB), zero past K and past N: by
  // cp.async (landing with the next commit group) or by plain loads
  auto load_y = [&](int c, bool async) {
    const int k0 = c * KY, rows = min(KY, krows - k0);
    for (int e = tid; e < rows * NB; e += kThreads) {
      const int k = k0 + e / NB, j = e % NB;
      const bool ok = k < K && j < N;
      const T* src = ok ? y + static_cast<size_t>(k) * N + j : y;
      if (async)
        cp_async_elem<sizeof(T)>(ys + e, src, ok);
      else
        ys[e] = ok ? *src : T(0);
    }
  };

  // copies of the next step (tile it: groups [ilo, ihi); stage iks) into
  // ring slot `slot`
  int it = 0, iks = 0;
  long long ilo = tile_lo(0), ihi = tile_hi(0, ilo);
  auto fetch = [&](int slot) {
    if (it < tiles) {
      if (ilo + warp * 32 < ihi) {              // the warp has rows here
        const long long g = ilo + tid;
        const int k0 = iks * kStageK;
        const int rows = g < ihi ? min(kStageK, K - k0) : 0;  // k-rows to copy
        const T* src = x + static_cast<size_t>(k0) * M + g * R;
        V* dst = ring + slot * (kStageK * kThreads) + tid;
#pragma unroll
        for (int kk = 0; kk < kStageK; ++kk, src += M) {
          if constexpr (VEC) {
            cp_async16(dst + kk * kThreads, kk < rows ? src : x, kk < rows);
          } else {
            T* d = reinterpret_cast<T*>(dst + kk * kThreads);
#pragma unroll
            for (int r = 0; r < R; ++r) {
              const bool ok = kk < rows && g * R + r < M;
              cp_async_elem<sizeof(T)>(d + r, ok ? src + r : x, ok);
            }
          }
        }
      }
      if (++iks == nks) {
        iks = 0;
        ++it;
        ilo = tile_lo(it);
        ihi = tile_hi(it, ilo);
      }
    }
    cp_async_commit();
  };

  if (tiles == 0) return;
  if (ychunks == 1) load_y(0, true);    // all of y, with ring stage 0
#pragma unroll
  for (int s = 0; s < kRing - 1; ++s) fetch(s);

  T acc[R][NB];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int j = 0; j < NB; ++j) acc[r][j] = T(0);

  int slot = 0, refill = kRing - 1, ks = 0, tile = 0;
  long long clo = tile_lo(0), chi = tile_hi(0, clo);   // the tile computed
  for (int s = 0; s < steps; ++s) {
    cp_async_wait<kRing - 2>();         // step s has landed (own copies)
    fetch(refill);                      // step s + kRing - 1, slot of s - 1
    refill = slot;
    const int k0 = ks * kStageK;
    if (ychunks == 1) {
      if (s == 0) __syncthreads();      // every thread's copies of y too
    } else if (k0 % KY == 0) {          // the next chunk of y
      __syncthreads();
      load_y(k0 / KY, false);
      __syncthreads();
    }
    const long long gw = clo + warp * 32;     // the warp's first group
    const bool active = gw < chi;
    if (active) {
      const V* xs = ring + slot * (kStageK * kThreads) + tid;
      const T* yk = ys + (k0 % KY) * NB;
#pragma unroll
      for (int kk = 0; kk < kStageK; ++kk) {
        T xr[R];
        Vec16<T>::unpack(xs[kk * kThreads], xr);
#pragma unroll
        for (int j0 = 0; j0 < NB; j0 += R) {
          T yv[R];
          Vec16<T>::unpack(*reinterpret_cast<const V*>(yk + kk * NB + j0),
                           yv);
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int jj = 0; jj < R; ++jj)
              acc[r][j0 + jj] = fmadd(xr[r], yv[jj], acc[r][j0 + jj]);
        }
      }
    }
    slot = slot + 1 == kRing ? 0 : slot + 1;
    if (++ks < nks) continue;

    // the tile is done: the warp's rows [gw R, end) of out are `valid`
    // contiguous elements; kOutLanes lanes' rows a round through `staged`
    if (active) {
      const long long end = min(chi * R, static_cast<long long>(M));
      const int valid =
          static_cast<int>(min(static_cast<long long>(32 * R), end - gw * R)) *
          N;
      T* dst = out + gw * R * N;
      for (int rd = 0; rd < 32 / kOutLanes; ++rd) {
        const int first = rd * kOutLanes * R * N;
        if (first >= valid) break;
        if (lane / kOutLanes == rd) {
          T* seg = staged + (lane % kOutLanes) * P * R;
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int j = 0; j < NB; ++j)
              if (j < N) seg[r * N + j] = acc[r][j];
        }
        __syncwarp();
        for (int c = lane; c < kOutLanes * N; c += 32) {
          const int l = c / N;
          const T* src = staged + (l * P + c - l * N) * R;
          const int e = first + c * R;
          if (e + R <= valid) {
            *reinterpret_cast<V*>(dst + e) = *reinterpret_cast<const V*>(src);
          } else {
            for (int i = 0; i < R && e + i < valid; ++i) dst[e + i] = src[i];
          }
        }
        __syncwarp();
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int j = 0; j < NB; ++j) acc[r][j] = T(0);
    ks = 0;
    ++tile;
    clo = tile_lo(tile);
    chi = tile_hi(tile, clo);
  }
  cp_async_wait<0>();
}

template <typename K>
int set_smem(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      reinterpret_cast<const void*>(kernel),
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

// The SM count and the blocks an SM holds, for the current device, queried
// once per device and instantiation.
template <typename T, int NB, bool VEC>
int narrow_config(int* sms, int* per_sm) {
  static int cached_sms[kMaxDevices] = {}, cached_per_sm[kMaxDevices] = {};
  int dev = 0;
  int rc = static_cast<int>(cudaGetDevice(&dev));
  if (rc != 0) return rc;
  if (dev < 0 || dev >= kMaxDevices)
    return static_cast<int>(cudaErrorInvalidDevice);
  if (cached_per_sm[dev] == 0) {
    auto kernel = gemm_narrow_ring<T, NB, VEC>;
    constexpr int smem = narrow_smem_bytes(NB);
    int count = 0, blocks = 0;
    rc = set_smem(kernel, smem);
    if (rc == 0)
      rc = static_cast<int>(cudaDeviceGetAttribute(
          &count, cudaDevAttrMultiProcessorCount, dev));
    if (rc == 0)
      rc = static_cast<int>(cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &blocks, kernel, kThreads, smem));
    if (rc != 0) return rc;
    if (blocks < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    cached_sms[dev] = count;
    cached_per_sm[dev] = blocks;
  }
  *sms = cached_sms[dev];
  *per_sm = cached_per_sm[dev];
  return 0;
}

// blocks of the persistent grid: every block at least a warp's groups
inline long long narrow_blocks(long long groups, int sms, int per_sm) {
  const long long cap = static_cast<long long>(sms) * per_sm;
  const long long warps = (groups + 31) / 32;
  return warps < cap ? warps : cap;
}

template <typename T, int NB, bool VEC>
int launch_narrow(const T* x, const T* y, T* out, int M, int K, int N,
                  cudaStream_t stream) {
  int sms = 0, per_sm = 0;
  const int rc = narrow_config<T, NB, VEC>(&sms, &per_sm);
  if (rc != 0) return rc;
  const long long groups = (static_cast<long long>(M) + Vec16<T>::n - 1) /
                           Vec16<T>::n;
  const int blocks = static_cast<int>(narrow_blocks(groups, sms, per_sm));
  gemm_narrow_ring<T, NB, VEC><<<blocks, kThreads, narrow_smem_bytes(NB),
                                 stream>>>(x, y, out, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, bool VEC>
int launch_narrow_nb(const T* x, const T* y, T* out, int M, int K, int N,
                     cudaStream_t stream) {
  if (N <= 4) return launch_narrow<T, 4, VEC>(x, y, out, M, K, N, stream);
  if (N <= 8) return launch_narrow<T, 8, VEC>(x, y, out, M, K, N, stream);
  return launch_narrow<T, 16, VEC>(x, y, out, M, K, N, stream);
}

// ---- general shared-memory tile ----------------------------------------
constexpr int kTM = 64, kTN = 64, kTK = 16;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gemm_tiled(const T* __restrict__ x, const T* __restrict__ y,
           T* __restrict__ out, int M, int K, int N, int trans_x) {
  __shared__ T As[kTK][kTM + 1];
  __shared__ T Bs[kTK][kTN];
  const int tid = threadIdx.x;
  const int tr = tid / 16, tc = tid % 16;
  const int m0 = blockIdx.y * kTM, n0 = blockIdx.x * kTN;
  T acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = T(0);

  for (int k0 = 0; k0 < K; k0 += kTK) {
    for (int e = tid; e < kTM * kTK; e += kThreads) {
      int mm, kk;
      if (trans_x) {          // neighbouring threads along m: coalesced
        kk = e / kTM;
        mm = e % kTM;
      } else {                // neighbouring threads along k: coalesced
        mm = e / kTK;
        kk = e % kTK;
      }
      const int gm = m0 + mm, gk = k0 + kk;
      T v = T(0);
      if (gm < M && gk < K)
        v = trans_x ? x[(size_t)gk * M + gm] : x[(size_t)gm * K + gk];
      As[kk][mm] = v;
    }
    for (int e = tid; e < kTK * kTN; e += kThreads) {
      const int kk = e / kTN, nn = e % kTN;
      const int gk = k0 + kk, gn = n0 + nn;
      Bs[kk][nn] = (gk < K && gn < N) ? y[(size_t)gk * N + gn] : T(0);
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTK; ++kk) {
      T a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = As[kk][tr + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = Bs[kk][tc + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmadd(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int gm = m0 + tr + 16 * i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int gn = n0 + tc + 16 * j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const T* x, const T* y, T* out, int M, int K, int N, int trans_x,
           cudaStream_t stream) {
  if (M <= 0 || N <= 0) return static_cast<int>(cudaGetLastError());
  if (trans_x && N <= 16) {
    if (reinterpret_cast<uintptr_t>(out) % 16 != 0)
      return static_cast<int>(cudaErrorMisalignedAddress);
    const bool vec = (static_cast<size_t>(M) * sizeof(T)) % 16 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 16 == 0;
    return vec ? launch_narrow_nb<T, true>(x, y, out, M, K, N, stream)
               : launch_narrow_nb<T, false>(x, y, out, M, K, N, stream);
  }
  const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
  gemm_tiled<T><<<grid, kThreads, 0, stream>>>(x, y, out, M, K, N, trans_x);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int NB>
int plan(int M, int K, int* p) {
  constexpr int R = Vec16<T>::n;
  const bool vec = (static_cast<size_t>(M) * sizeof(T)) % 16 == 0;
  int sms = 0, per_sm = 0;
  const int rc = vec ? narrow_config<T, NB, true>(&sms, &per_sm)
                     : narrow_config<T, NB, false>(&sms, &per_sm);
  if (rc != 0) return rc;
  const long long groups = (static_cast<long long>(M) + R - 1) / R;
  const int nks = K > kStageK ? (K + kStageK - 1) / kStageK : 1;
  const int items[] = {NB, R, kStageK, kRing,
                       kYBytes / (NB * static_cast<int>(sizeof(T))),
                       narrow_smem_bytes(NB), sms, per_sm,
                       static_cast<int>(narrow_blocks(groups, sms, per_sm)),
                       nks, vec ? 1 : 0};
  for (int i = 0; i < 11; ++i) p[i] = items[i];
  return 0;
}

}  // namespace

extern "C" int esoo_matmul_f32(const void* x, const void* y, void* out,
                               int M, int K, int N, int trans_x,
                               void* stream) {
  return launch<float>(static_cast<const float*>(x),
                       static_cast<const float*>(y), static_cast<float*>(out),
                       M, K, N, trans_x, static_cast<cudaStream_t>(stream));
}

extern "C" int esoo_matmul_f64(const void* x, const void* y, void* out,
                               int M, int K, int N, int trans_x,
                               void* stream) {
  return launch<double>(static_cast<const double*>(x),
                        static_cast<const double*>(y),
                        static_cast<double*>(out), M, K, N, trans_x,
                        static_cast<cudaStream_t>(stream));
}

// The narrow kernel's plan for (M, K, N) and an element of `itemsize`
// bytes on the current device, x assumed 16-byte aligned: plan[0..10] =
// NB, rows a thread, k-rows a stage, ring stages, rows of a y chunk,
// dynamic shared memory, SMs, blocks an SM, grid blocks, stages a tile,
// 16-byte copies (1) or element copies (0).
extern "C" int esoo_matmul_narrow_plan(int M, int K, int N, int itemsize,
                                       int* plan_out) {
  if (M <= 0 || N <= 0 || N > 16 || (itemsize != 4 && itemsize != 8))
    return static_cast<int>(cudaErrorInvalidValue);
  if (itemsize == 4) {
    if (N <= 4) return plan<float, 4>(M, K, plan_out);
    if (N <= 8) return plan<float, 8>(M, K, plan_out);
    return plan<float, 16>(M, K, plan_out);
  }
  if (N <= 4) return plan<double, 4>(M, K, plan_out);
  if (N <= 8) return plan<double, 8>(M, K, plan_out);
  return plan<double, 16>(M, K, plan_out);
}
