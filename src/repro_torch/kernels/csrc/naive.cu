// The paper's naive AIDW kernel: both phases in one launch, no shared
// memory.
//
// Replaces two TPU kernels:
//   src/repro/kernels/aidw_naive.py:_naive_kernel_soa  (`naive`, SoA)
//   src/repro/kernels/aidw_naive.py:_naive_kernel_aoas (`naive`,
//     layout="aoas")
//
// Design: one thread per query, reading every data point from global
// memory; all threads of a warp read the same point at the same time (one
// L1 broadcast).  Pass 1 folds each d^2 into a sorted register k-best of
// compile-time size K with knn.cu's insertion (strict `<` against the k-th
// best, duplicates kept) and computes alpha with knn.cu's epilogue, so
// alpha is the bits of the tiled kernel's (the same k-smallest multiset).
// Pass 2 computes the distances again and the weights, as the paper's
// kernel does, and sums them in weight.cu's order: per tile of tile_d
// points (the plan's block_d) left to right, the tile sums folded into
// running totals in data order.  So z is the bits of the tiled kernels'
// z, and naive and tiled differ only in where the data is staged, which
// is the paper's comparison.  The Pallas kernel sums its whole row in one
// jnp.sum, whose order is XLA's; the results agree within the fp slack.
// AOAS reads each (x, y, z, 0) struct with one float4 (two double2) load.
//
// Pass 2 runs weight.cu's tile loop (aidw_common.cuh: weight_tile) on
// points read from global memory, so its weights (pow_weight: lg2/ex2 on
// the special-function units in float32) and sums are weight.cu's.
//
// What bounds it on an H100: instruction issue and the special-function
// units, as weight.cu: pass 2's weight loop dominates, and pass 1 adds
// kNN's 6 operations a pair.  Each CUDA block reads the whole data set once per pass, from L2
// after the first block (m = 2^20 points are 12 MiB in f32 SoA).
#include "aidw_common.cuh"
#include "aoas.cuh"

namespace aidw {

// AOAS: dx is the (m, 4) struct array and dy, dz are unused.
template <typename T, int K, bool AOAS>
__global__ void naive_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                             const T* __restrict__ dx, const T* __restrict__ dy,
                             const T* __restrict__ dz, int n, int m, int tile_d,
                             AlphaConsts<T> consts, T eps, T tiny, T* __restrict__ z_out,
                             T* __restrict__ alpha_out) {
  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  if (q >= n) return;  // no barrier below: a thread past the batch just leaves
  const T px = qx[q];
  const T py = qy[q];

  // ---- pass 1: k-best of d^2, then alpha (paper Fig. 3 lines 11-34)
  T best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = T(INFINITY);
  for (int i = 0; i < m; ++i) {
    T x, y;
    if constexpr (AOAS) {
      load_xy(dx, i, x, y);
    } else {
      x = dx[i];
      y = dy[i];
    }
    kbest_insert(best, sq_dist(px, py, x, y));
  }
  const T alpha = kbest_alpha(best, consts);
  alpha_out[q] = alpha;

  // ---- pass 2: the distances again, then the weights (lines 52-58)
  const T neg_ah = -mul_rn(alpha, T(0.5));
  T sum_w = T(0), sum_wz = T(0), min_d2 = T(INFINITY), hit_z = T(0);
  const auto point = [&](int i, T& x, T& y, T& zj) {
    if constexpr (AOAS) {
      load_xyz(dx, i, x, y, zj);
    } else {
      x = dx[i];
      y = dy[i];
      zj = dz[i];
    }
  };
  for (int base = 0; base < m; base += tile_d)
    weight_tile(px, py, neg_ah, base, min(base + tile_d, m), point, tiny, sum_w, sum_wz, min_d2, hit_z);
  z_out[q] = (min_d2 <= eps) ? hit_z : sum_wz / sum_w;
}

template <typename T, bool AOAS>
cudaError_t launch(const void* qx, const void* qy, const void* dx, const void* dy, const void* dz,
                   int n, int m, int tile_d, int k, int threads, AlphaConsts<T> c, double eps,
                   double tiny, void* z, void* alpha, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || tile_d <= 0 || m <= 0) return cudaErrorInvalidValue;
  const int blocks = (n + threads - 1) / threads;
  const T* a = static_cast<const T*>(qx);
  const T* b = static_cast<const T*>(qy);
  const T* x = static_cast<const T*>(dx);
  const T* y = static_cast<const T*>(dy);
  const T* z_in = static_cast<const T*>(dz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AIDW_NAIVE_CASE(KV)                                                                  \
  case KV:                                                                                   \
    naive_kernel<T, KV, AOAS><<<blocks, threads, 0, s>>>(a, b, x, y, z_in, n, m, tile_d, c,  \
                                                         static_cast<T>(eps),                \
                                                         static_cast<T>(tiny),               \
                                                         static_cast<T*>(z),                 \
                                                         static_cast<T*>(alpha));            \
    return cudaGetLastError();
  switch (k) {
    AIDW_K_LIST(AIDW_NAIVE_CASE)
    default:
      break;
  }
#undef AIDW_NAIVE_CASE
  return cudaErrorInvalidValue;  // no instance for this k
}

}  // namespace aidw

// z[q], alpha[q] for q < n.  SoA: qx, qy: (n,); dx, dy, dz: (m,), summed in
// tiles of tile_d points.  The alpha constants come as doubles and are
// rounded to the dtype.
#define AIDW_NAIVE_SOA_ENTRY(NAME, T)                                                            \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* dx, const void* dy,   \
                              const void* dz, int n, int m, int tile_d, int k, int threads,      \
                              double r_exp, double pi_over_rmax, double r_min, double r_max,     \
                              double a1, double a2, double a3, double a4, double a5, double eps, \
                              double tiny, void* z, void* alpha, void* stream) {                 \
    return aidw::launch<T, false>(qx, qy, dx, dy, dz, n, m, tile_d, k, threads,                  \
                                  aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,  \
                                                             a1, a2, a3, a4, a5),                \
                                  eps, tiny, z, alpha, stream);                                  \
  }

AIDW_NAIVE_SOA_ENTRY(aidw_naive_soa_f32, float)
AIDW_NAIVE_SOA_ENTRY(aidw_naive_soa_f64, double)

// AoaS: data is the (m, 4) struct array.
#define AIDW_NAIVE_AOAS_ENTRY(NAME, T)                                                           \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* data, int n, int m,   \
                              int tile_d, int k, int threads, double r_exp, double pi_over_rmax, \
                              double r_min, double r_max, double a1, double a2, double a3,       \
                              double a4, double a5, double eps, double tiny, void* z,            \
                              void* alpha, void* stream) {                                       \
    return aidw::launch<T, true>(qx, qy, data, nullptr, nullptr, n, m, tile_d, k, threads,       \
                                 aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,   \
                                                            a1, a2, a3, a4, a5),                 \
                                 eps, tiny, z, alpha, stream);                                   \
  }

AIDW_NAIVE_AOAS_ENTRY(aidw_naive_aoas_f32, float)
AIDW_NAIVE_AOAS_ENTRY(aidw_naive_aoas_f64, double)
