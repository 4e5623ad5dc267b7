// Fused AIDW: both phases in one launch.
//
// Replaces src/repro/kernels/aidw_fused.py:_fused_kernel (launched by
// aidw_fused_soa, the `fused` impl).  The Pallas kernel walks the data tiles
// twice over a (query block, phase, tile) grid and hands alpha / 2 from
// phase 0 to phase 1 in VMEM scratch, so alpha never makes the round trip
// through device memory between the two passes.
//
// Design: one thread per query, gcd(block_q, 256) threads a block.  Pass 1
// stages each tile of tile_d points (the plan's block_d) of x and y into
// shared memory and folds it into a sorted register k-best with knn.cu's
// insertion, then computes alpha with knn.cu's epilogue: the same k-smallest
// multiset, so the same bits as B1.  Alpha stays in a register and
// alpha / 2 = alpha * 0.5 exactly.  Pass 2 stages x, y and z tile by tile
// and runs weight.cu's tile loop (aidw_common.cuh: weight_tile): each
// tile summed left to right, the tile sums folded into running totals in
// data order, the first minimum kept with a strict `<`.  So z is the bits of
// weight.cu's z on B1's alpha, and the launch writes z and alpha, the only
// outputs.
//
// What bounds it on an H100: instruction issue and the special-function
// units, as weight.cu: pass 2's weight loop (aidw_common.cuh:
// weight_tile, whose weights are pow_weight's lg2/ex2 in float32)
// dominates, pass 1 adds kNN's 6 operations a pair.
// Each CUDA block reads the data twice, from L2 after the first block.
#include "aidw_common.cuh"

namespace aidw {

template <typename T, int K>
__global__ void fused_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                             const T* __restrict__ dx, const T* __restrict__ dy,
                             const T* __restrict__ dz, int n, int m, int tile_d,
                             AlphaConsts<T> consts, T eps, T tiny, T* __restrict__ z_out,
                             T* __restrict__ alpha_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + tile_d;
  T* sz = sy + tile_d;

  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = q < n;
  const T px = live ? qx[q] : T(0);
  const T py = live ? qy[q] : T(0);

  // ---- pass 1: k-best of d^2 over the staged tiles, then alpha
  T best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = T(INFINITY);
  for (int base = 0; base < m; base += tile_d) {
    const int cnt = min(tile_d, m - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      sx[i] = dx[base + i];
      sy[i] = dy[base + i];
    }
    __syncthreads();
    for (int j = 0; j < cnt; ++j) kbest_insert(best, sq_dist(px, py, sx[j], sy[j]));
    __syncthreads();
  }
  const T alpha = kbest_alpha(best, consts);

  // ---- pass 2: the weight sweep at alpha / 2, in weight.cu's sum order
  const T neg_ah = -mul_rn(alpha, T(0.5));
  T sum_w = T(0), sum_wz = T(0), min_d2 = T(INFINITY), hit_z = T(0);
  const auto point = [&](int j, T& x, T& y, T& z) {
    x = sx[j];
    y = sy[j];
    z = sz[j];
  };
  for (int base = 0; base < m; base += tile_d) {
    const int cnt = min(tile_d, m - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      sx[i] = dx[base + i];
      sy[i] = dy[base + i];
      sz[i] = dz[base + i];
    }
    __syncthreads();
    weight_tile(px, py, neg_ah, 0, cnt, point, tiny, sum_w, sum_wz, min_d2, hit_z);
    __syncthreads();
  }
  if (live) {
    z_out[q] = (min_d2 <= eps) ? hit_z : sum_wz / sum_w;
    alpha_out[q] = alpha;
  }
}

template <typename T>
cudaError_t launch(const void* qx, const void* qy, const void* dx, const void* dy, const void* dz,
                   int n, int m, int tile_d, int k, int threads, AlphaConsts<T> c, double eps,
                   double tiny, void* z, void* alpha, void* stream) {
  if (n <= 0) return cudaSuccess;
  const size_t smem = 3 * static_cast<size_t>(tile_d) * sizeof(T);
  if (threads <= 0 || threads > 1024 || tile_d <= 0 || m <= 0 || smem > 48 * 1024)
    return cudaErrorInvalidValue;
  const int blocks = (n + threads - 1) / threads;
  const T* a = static_cast<const T*>(qx);
  const T* b = static_cast<const T*>(qy);
  const T* x = static_cast<const T*>(dx);
  const T* y = static_cast<const T*>(dy);
  const T* z_in = static_cast<const T*>(dz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AIDW_FUSED_CASE(KV)                                                                       \
  case KV:                                                                                        \
    fused_kernel<T, KV><<<blocks, threads, smem, s>>>(a, b, x, y, z_in, n, m, tile_d, c,          \
                                                      static_cast<T>(eps), static_cast<T>(tiny),  \
                                                      static_cast<T*>(z), static_cast<T*>(alpha)); \
    return cudaGetLastError();
  switch (k) {
    AIDW_K_LIST(AIDW_FUSED_CASE)
    default:
      break;
  }
#undef AIDW_FUSED_CASE
  return cudaErrorInvalidValue;  // no instance for this k
}

}  // namespace aidw

// z[q], alpha[q] for q < n.  qx, qy: (n,); dx, dy, dz: (m,), walked in tiles
// of tile_d points (3 * tile_d values fit 48 KiB of shared memory).  The
// alpha constants come as doubles and are rounded to the dtype.
#define AIDW_FUSED_ENTRY(NAME, T)                                                                \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* dx, const void* dy,   \
                              const void* dz, int n, int m, int tile_d, int k, int threads,      \
                              double r_exp, double pi_over_rmax, double r_min, double r_max,     \
                              double a1, double a2, double a3, double a4, double a5, double eps, \
                              double tiny, void* z, void* alpha, void* stream) {                 \
    return aidw::launch<T>(qx, qy, dx, dy, dz, n, m, tile_d, k, threads,                         \
                           aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max, a1, a2, \
                                                      a3, a4, a5),                               \
                           eps, tiny, z, alpha, stream);                                         \
  }

AIDW_FUSED_ENTRY(aidw_fused_f32, float)
AIDW_FUSED_ENTRY(aidw_fused_f64, double)
