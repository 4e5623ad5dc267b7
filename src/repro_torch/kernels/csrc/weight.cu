// Exact Phase 2 of AIDW (Eq. 1): for each query, w = (d^2)^(-alpha/2) over
// all m data points, z = sum(w z) / sum(w), or the z of the first nearest
// point when its d^2 <= exact_hit_eps.
//
// Replaces src/repro/kernels/aidw_tiled.py:_weight_kernel_soa (launched by
// aidw_tiled_soa for the `tiled` impl and by aidw_grid.py:phase2_weights_full
// on the grid path) and, with AOAS, src/repro/kernels/aidw_tiled.py:
// _weight_kernel_aoas (launched by aidw_tiled_aoas, `tiled` with
// layout="aoas"): the (m, 4) structs are staged into the same sx, sy, sz
// tiles with one vector load a point, so the inner loop, and the bits, are
// the SoA ones.  With CONST_AH it replaces src/repro/kernels/idw_tiled.py:
// _idw_kernel (launched by idw_tiled_soa, the `idw` impl): the same sweep
// at one alpha / 2 for every query, passed by value and rounded to the
// dtype once on the host, as jnp.asarray(alpha * 0.5, dtype) rounds it.
//
// Design: one thread per query; the data streams through shared memory in
// tiles of tile_d points (the plan's block_d, the Pallas kernel's data
// tile), every thread of the block reading the same point (a broadcast).
// Each thread accumulates sum(w), sum(w z), min d^2 and the z at the first
// minimum sequentially, with a strict `<` for the minimum, which keeps the
// first index as weight_tile's rule does.  Like the Pallas kernel, the sums
// are taken per tile and the tile sums folded into running totals at the
// same tile boundaries: a float32 sum of 2^20 terms in one accumulator
// would lose the small far-field weights against the large near ones, and
// with the same boundaries only the order inside a tile differs from the
// plain version.  No atomics and no split of the data axis: the sum order
// is fixed by the data order alone, so results are the same bits from run
// to run and do not depend on how many queries are launched together.
//
// w = exp(-ah * log(max(d^2, tiny))) with precise expf/logf (exp/log for
// double), never powf and never fast math.  A sentinel pad point has
// d^2 = +inf, log = +inf and w = exp(-inf) = 0.
//
// What bounds it on an H100: instruction issue.  Besides the 11 flops for
// d^2 and the sums, precise expf is an FP32 range reduction around one
// MUFU.EX2 and precise logf an FP32 polynomial with no MUFU op, so the
// per-pair loop issues several times more instructions than it does flops
// or special-function ops (chip_smoke.py prints the count from the sm_90a
// SASS).  Memory traffic is m points per CUDA block of queries, read from
// L2 after the first block.
#include "aidw_common.cuh"
#include "aoas.cuh"

namespace aidw {

// AOAS: dx is the (m, 4) struct array and dy, dz are unused.
// CONST_AH: every query takes ah_const and ah is unused.
template <typename T, bool AOAS, bool CONST_AH>
__global__ void weight_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                              const T* __restrict__ ah, const T* __restrict__ dx,
                              const T* __restrict__ dy, const T* __restrict__ dz, int n, int m,
                              int tile_d, T eps, T tiny, T ah_const, T* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + tile_d;
  T* sz = sy + tile_d;

  const long long q = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  const bool live = q < n;
  const T px = live ? qx[q] : T(0);
  const T py = live ? qy[q] : T(0);
  T neg_ah;
  if constexpr (CONST_AH) {
    neg_ah = -ah_const;
  } else {
    neg_ah = live ? -ah[q] : T(0);
  }

  T sum_w = T(0), sum_wz = T(0), min_d2 = T(INFINITY), hit_z = T(0);
  for (int base = 0; base < m; base += tile_d) {
    const int cnt = min(tile_d, m - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      if constexpr (AOAS) {
        load_xyz(dx, base + i, sx[i], sy[i], sz[i]);
      } else {
        sx[i] = dx[base + i];
        sy[i] = dy[base + i];
        sz[i] = dz[base + i];
      }
    }
    __syncthreads();
    weight_tile_sums(px, py, neg_ah, sx, sy, sz, cnt, tiny, sum_w, sum_wz, min_d2, hit_z);
    __syncthreads();
  }
  if (live) out[q] = (min_d2 <= eps) ? hit_z : sum_wz / sum_w;
}

template <typename T, bool AOAS, bool CONST_AH = false>
cudaError_t launch(const void* qx, const void* qy, const void* ah, const void* dx, const void* dy,
                   const void* dz, int n, int m, int tile_d, int threads, double eps, double tiny,
                   void* out, void* stream, double ah_const = 0.0) {
  if (n <= 0) return cudaSuccess;
  const size_t smem = 3 * static_cast<size_t>(tile_d) * sizeof(T);
  if (threads <= 0 || threads > 1024 || tile_d <= 0 || smem > 48 * 1024) return cudaErrorInvalidValue;
  const int blocks = (n + threads - 1) / threads;
  weight_kernel<T, AOAS, CONST_AH><<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qx), static_cast<const T*>(qy), static_cast<const T*>(ah),
      static_cast<const T*>(dx), static_cast<const T*>(dy), static_cast<const T*>(dz), n, m, tile_d,
      static_cast<T>(eps), static_cast<T>(tiny), static_cast<T>(ah_const), static_cast<T*>(out));
  return cudaGetLastError();
}

}  // namespace aidw

// out[q] for q < n.  qx, qy, ah (= alpha / 2): (n,); dx, dy, dz: (m,),
// summed in tiles of tile_d points (3 * tile_d values fit 48 KiB of shared
// memory).
#define AIDW_WEIGHT_ENTRY(NAME, T)                                                               \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* ah, const void* dx,   \
                              const void* dy, const void* dz, int n, int m, int tile_d,          \
                              int threads, double eps, double tiny, void* out, void* stream) {   \
    return aidw::launch<T, false>(qx, qy, ah, dx, dy, dz, n, m, tile_d, threads, eps, tiny, out,   \
                                  stream);                                                        \
  }

AIDW_WEIGHT_ENTRY(aidw_weight_f32, float)
AIDW_WEIGHT_ENTRY(aidw_weight_f64, double)

// The AoaS twin: data is the (m, 4) struct array.
#define AIDW_WEIGHT_AOAS_ENTRY(NAME, T)                                                           \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* ah, const void* data,  \
                              int n, int m, int tile_d, int threads, double eps, double tiny,     \
                              void* out, void* stream) {                                          \
    return aidw::launch<T, true>(qx, qy, ah, data, nullptr, nullptr, n, m, tile_d, threads, eps,  \
                                 tiny, out, stream);                                              \
  }

AIDW_WEIGHT_AOAS_ENTRY(aidw_weight_aoas_f32, float)
AIDW_WEIGHT_AOAS_ENTRY(aidw_weight_aoas_f64, double)

// Standard IDW: out[q] for q < n at the constant power alpha; alpha / 2 is
// taken in double and rounded to the dtype once.
#define AIDW_IDW_ENTRY(NAME, T)                                                                  \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* dx, const void* dy,   \
                              const void* dz, int n, int m, int tile_d, int threads, double alpha, \
                              double eps, double tiny, void* out, void* stream) {                \
    return aidw::launch<T, false, true>(qx, qy, nullptr, dx, dy, dz, n, m, tile_d, threads, eps,  \
                                        tiny, out, stream, alpha * 0.5);                          \
  }

AIDW_IDW_ENTRY(aidw_idw_f32, float)
AIDW_IDW_ENTRY(aidw_idw_f64, double)
