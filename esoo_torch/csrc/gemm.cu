// Hand-written GEMM for the integral transform (sm_90a, CUDA cores).
//
// Replaces esoo_tpu/ops/pallas_kernels.py::matmul_pallas (the Pallas
// tiled (M, K) @ (K, N) with an f32 VMEM accumulator, pl.pallas_call at
// :80) and, through four launches from esoo_torch/ops/gemm.py, its
// rotate_two_body_pallas 4-index transform (:108).
//
// What bounds it on an H100: the transform's four stages all have a
// narrow N (the active dimension n, 4 on the H4 headline problem) and
// contract the LEADING axis of a (K, M) row-major operand, so each stage
// does ~2n FLOPs per byte of x — far below the ~17 FLOP/B a float32 FMA
// pipe needs before memory stops being the limit.  The design follows:
//
//   * trans_x: x is read as stored, (K, M) row-major.  The Pallas
//     wrapper's g.reshape(m, m^3).T would materialize a transposed copy of
//     the m^4 tensor on the card and double the bytes of stage 1.
//   * narrow N (<= 16) with trans_x: one thread per output row m, y staged
//     in shared memory (broadcast reads), the K loop reading x[k, m] with
//     neighbouring threads on neighbouring addresses (coalesced), 8 loads
//     in flight per thread.  A 64- or 128-wide N tile would waste >90% of
//     its FMAs at N = 4.
//   * otherwise a 64x64x16 shared-memory tile, 256 threads of 4x4 outputs.
//   * FFMA on the CUDA cores, accumulating in the element type (float or
//     double): no TF32 tensor cores, which the package's precision rule
//     forbids, and f64 runs here too instead of a library call.
//   * ragged edges are masked in the kernel; nothing is padded on the host.
//
// C interface (ctypes): esoo_matmul_f32 / esoo_matmul_f64 launch on the
// given stream, allocate nothing, and return cudaGetLastError().

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float fmadd(float a, float b, float c) {
  return fmaf(a, b, c);
}
__device__ __forceinline__ double fmadd(double a, double b, double c) {
  return fma(a, b, c);
}

constexpr int kThreads = 256;

// ---- narrow N, x stored (K, M): one thread per output row --------------
constexpr int kKChunk = 128;

template <typename T, int NB>
__global__ void __launch_bounds__(kThreads)
gemm_narrow_tx(const T* __restrict__ x, const T* __restrict__ y,
               T* __restrict__ out, int M, int K, int N) {
  __shared__ T ys[kKChunk * NB];
  const int m = blockIdx.x * kThreads + threadIdx.x;
  T acc[NB];
#pragma unroll
  for (int j = 0; j < NB; ++j) acc[j] = T(0);

  for (int k0 = 0; k0 < K; k0 += kKChunk) {
    const int kc = min(kKChunk, K - k0);
    __syncthreads();
    for (int e = threadIdx.x; e < kKChunk * NB; e += kThreads) {
      const int kk = e / NB, j = e % NB;
      ys[e] = (kk < kc && j < N) ? y[(size_t)(k0 + kk) * N + j] : T(0);
    }
    __syncthreads();
    if (m < M) {
      const T* xp = x + (size_t)k0 * M + m;
#pragma unroll 8
      for (int kk = 0; kk < kc; ++kk) {
        const T xv = __ldg(xp + (size_t)kk * M);
#pragma unroll
        for (int j = 0; j < NB; ++j) acc[j] = fmadd(xv, ys[kk * NB + j], acc[j]);
      }
    }
  }
  if (m < M) {
    T* op = out + (size_t)m * N;
#pragma unroll
    for (int j = 0; j < NB; ++j)
      if (j < N) op[j] = acc[j];
  }
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
  if (M > 0 && N > 0) {
    if (trans_x && N <= 16) {
      const dim3 grid((M + kThreads - 1) / kThreads);
      if (N <= 4)
        gemm_narrow_tx<T, 4><<<grid, kThreads, 0, stream>>>(x, y, out, M, K, N);
      else if (N <= 8)
        gemm_narrow_tx<T, 8><<<grid, kThreads, 0, stream>>>(x, y, out, M, K, N);
      else
        gemm_narrow_tx<T, 16><<<grid, kThreads, 0, stream>>>(x, y, out, M, K, N);
    } else {
      const dim3 grid((N + kTN - 1) / kTN, (M + kTM - 1) / kTM);
      gemm_tiled<T><<<grid, kThreads, 0, stream>>>(x, y, out, M, K, N, trans_x);
    }
  }
  return static_cast<int>(cudaGetLastError());
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
