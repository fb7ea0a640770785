// The Davidson sigma's two gathers over single-excitation lists (sm_90a,
// CUDA cores): the alpha gather and the beta back-gather on either side of
// one product, for esoo_torch/sim/strings.py::sigma_lists (both) and
// build_list_ops (the back-gather).
//
// Replaces no TPU kernel.  The JAX package's sigma (esoo_tpu/sim/
// strings.py:683 sigma, K4) is jnp: dense products by the (n^2, ns, ns)
// sign stacks of the same-spin operators D_q = a+_p a_r, which XLA runs on
// the TPU's matrix unit.  On the H100 those products multiply by zero: a
// row of D_q holds at most one nonzero (44,044 of 196 x 1001^2 entries a
// spin at H8 -> 28), so the dense route did ~1,880 GFLOP a sigma for the
// 4.45 GFLOP of couplings the sector has.  These kernels apply D_q as what
// it is, a signed partial permutation of strings.
//
// With src[q, j] the source string of target string j under D_q (-1 where
// there is none) and sgn[q, j] its Jordan-Wigner sign (int8, 0 there):
//   alpha gather:      T[q, r, j] = sgn[q, j] V[r, src[q, j]]
//                      (T_q = V D_q^T: D_q on the alpha side of each row r
//                      of V, r running over states and beta strings)
//   beta back-gather:  out[k, j, i] = base[k, j, i]
//                        + sum over q ascending with src[q, j] >= 0 of
//                          sgn[q, j] Y[q, k, src[q, j], i]
//                      (base + sum_q D_q Y_q, on the beta side of state k;
//                      summed in double at either precision, so a float
//                      output is rounded once)
// Between them the caller runs Y = GX @ T, the cross-spin pair coupling, as
// one torch.matmul.
//
// What bounds each on an H100 (H8 -> 28: n = 14, q = 196, ns = 1001,
// float64):
//   * Alpha gather: the bytes of T, written once: 196 x 1,002,001 x 8 B =
//     1.57 GB, 0.47 ms at 3.35 TB/s.  V (8 MB) comes from L2.  One block
//     a row r of V and kOps operators; a warp writes 32 consecutive j of
//     one row of T, so every store is coalesced, and gathers V[r, src]
//     through the read-only cache, where the row's 8 KB stay.  Measured on
//     an H100 80GB HBM3 (700 W) at this shape, float64: 0.52-0.70 ms of
//     kernel time across runs, 67-91 % of the bound; staging up to 8 rows
//     of V in shared memory with each thread writing all of them took
//     1.11-1.41 ms, and fewer blocks with more operators each were slower
//     too.
//   * Beta back-gather: the rows of Y it reads, each once (src[q, .] is
//     one-to-one): 44 rows of 8 KB for each of the 1,001 output rows of a
//     state, 353 MB, 0.105 ms, and out written once (8 MB).  One block an
//     output row: it compacts the row's operators (src >= 0) in ascending
//     q into shared memory, then each thread sums its columns over them in
//     that order, starting from base, in double registers (free beside the
//     bytes; a float sum over the row's ~44 terms would round at each one
//     at the scale of base, the sigma's largest part).  No atomics: a rerun
//     gives the same bits, and the plain version (ops/sigma_lists.py) sums
//     in the same order in double.  Each term is +-y, exact in double, so
//     a fused multiply-add rounds as the plain version's addition does.
//
// C interface (ctypes): launches on the given stream, allocates nothing,
// returns cudaGetLastError() (or cudaErrorInvalidValue for a shape the
// kernels do not take).

#include <cuda_runtime.h>
#include <cstddef>
#include <cstdint>

namespace {

constexpr int kThreads = 256;        // both kernels' block size
constexpr int kWarps = kThreads / 32;
constexpr int kOps = 2;              // alpha gather: operators a block writes
constexpr int kMaxOps = 1024;        // beta back-gather: operators, n <= 32
constexpr int kCols = 4;             // beta back-gather: columns a thread sums

// One block a row r of V and kOps operators: blockIdx.x = r.
template <typename T>
__global__ void __launch_bounds__(kThreads)
alpha_gather(const T* __restrict__ V, const int* __restrict__ src,
             const int8_t* __restrict__ sgn, T* __restrict__ out, int q,
             int R, int ns) {
  const int r = blockIdx.x;
  const T* vrow = V + static_cast<size_t>(r) * ns;
  const int a0 = blockIdx.y * kOps;
  const int a1 = q - a0 < kOps ? q : a0 + kOps;
  for (int a = a0; a < a1; ++a) {
    const int* srow = src + static_cast<size_t>(a) * ns;
    const int8_t* grow = sgn + static_cast<size_t>(a) * ns;
    T* orow = out + (static_cast<size_t>(a) * R + r) * ns;
    for (int j = threadIdx.x; j < ns; j += kThreads) {
      const int s = srow[j];
      orow[j] = s >= 0 ? static_cast<T>(grow[j]) * __ldg(vrow + s) : T(0);
    }
  }
}

// One block an output row (k, j) of K states of ns rows: blockIdx.x =
// k * ns + j.
template <typename T>
__global__ void __launch_bounds__(kThreads)
beta_gather(const T* __restrict__ Y, const int* __restrict__ src,
            const int8_t* __restrict__ sgn, const T* __restrict__ base,
            T* __restrict__ out, int q, int K, int ns, int C) {
  __shared__ long long row_at[kMaxOps];   // the Y row of each term
  __shared__ T sign_at[kMaxOps];
  __shared__ int warp_count[kWarps];
  const int k = blockIdx.x / ns;
  const int j = blockIdx.x - k * ns;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  // the row's terms, compacted in ascending q
  int count = 0;
  for (int b0 = 0; b0 < q; b0 += kThreads) {
    const int b = b0 + threadIdx.x;
    const int s = b < q ? src[static_cast<size_t>(b) * ns + j] : -1;
    const unsigned keep = __ballot_sync(0xffffffffu, s >= 0);
    if (lane == 0) warp_count[warp] = __popc(keep);
    __syncthreads();
    int at = count;
    int total = count;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) at += warp_count[w];
      total += warp_count[w];
    }
    if (s >= 0) {
      at += __popc(keep & ((1u << lane) - 1u));
      row_at[at] = (static_cast<long long>(b) * K + k) * ns + s;
      sign_at[at] = static_cast<T>(sgn[static_cast<size_t>(b) * ns + j]);
    }
    count = total;
    __syncthreads();
  }
  const size_t o = (static_cast<size_t>(k) * ns + j) * C;
  for (int i0 = 0; i0 < C; i0 += kCols * kThreads) {
    double acc[kCols];
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int i = i0 + c * kThreads + threadIdx.x;
      acc[c] = i < C ? static_cast<double>(base[o + i]) : 0.0;
    }
#pragma unroll 4
    for (int l = 0; l < count; ++l) {
      const T* yrow = Y + row_at[l] * C;
      const double f = sign_at[l];
#pragma unroll
      for (int c = 0; c < kCols; ++c) {
        const int i = i0 + c * kThreads + threadIdx.x;
        if (i < C) acc[c] += f * static_cast<double>(yrow[i]);
      }
    }
#pragma unroll
    for (int c = 0; c < kCols; ++c) {
      const int i = i0 + c * kThreads + threadIdx.x;
      if (i < C) out[o + i] = static_cast<T>(acc[c]);
    }
  }
}

constexpr int kInvalid = static_cast<int>(cudaErrorInvalidValue);

template <typename T>
int launch_alpha(const void* V, const void* src, const void* sgn, void* out,
                 int q, int R, int ns, cudaStream_t stream) {
  if (q <= 0 || R <= 0 || ns <= 0) return kInvalid;
  const dim3 grid(R, (q + kOps - 1) / kOps);
  alpha_gather<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(V), static_cast<const int*>(src),
      static_cast<const int8_t*>(sgn), static_cast<T*>(out), q, R, ns);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_beta(const void* Y, const void* src, const void* sgn,
                const void* base, void* out, int q, int K, int ns, int C,
                cudaStream_t stream) {
  if (q <= 0 || q > kMaxOps || K <= 0 || ns <= 0 || C <= 0) return kInvalid;
  const long long blocks = static_cast<long long>(K) * ns;
  if (blocks > 0x7fffffffLL) return kInvalid;
  beta_gather<T><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(Y), static_cast<const int*>(src),
      static_cast<const int8_t*>(sgn), static_cast<const T*>(base),
      static_cast<T*>(out), q, K, ns, C);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#define ESOO_SIGMA_LISTS(TAG, T)                                             \
  extern "C" int esoo_alpha_gather_##TAG(const void* V, const void* src,     \
                                         const void* sgn, void* out, int q,  \
                                         int R, int ns, void* stream) {      \
    return launch_alpha<T>(V, src, sgn, out, q, R, ns,                       \
                           static_cast<cudaStream_t>(stream));               \
  }                                                                          \
  extern "C" int esoo_beta_gather_##TAG(                                     \
      const void* Y, const void* src, const void* sgn, const void* base,     \
      void* out, int q, int K, int ns, int C, void* stream) {                \
    return launch_beta<T>(Y, src, sgn, base, out, q, K, ns, C,               \
                          static_cast<cudaStream_t>(stream));                \
  }

ESOO_SIGMA_LISTS(f32, float)
ESOO_SIGMA_LISTS(f64, double)

// The back-gather's operator limit, for the host mirror's test
// (ops/sigma_lists.py::_MAX_OPS)
extern "C" int esoo_beta_gather_max_ops() { return kMaxOps; }
