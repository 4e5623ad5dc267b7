// Exact Phase 2 of AIDW (Eq. 1): for each query, w = (d^2)^(-alpha/2) over
// all m data points, z = sum(w z) / sum(w), or the z of the first nearest
// point when its d^2 <= exact_hit_eps.
//
// Replaces src/repro/kernels/aidw_tiled.py:_weight_kernel_soa (launched by
// aidw_tiled_soa for the `tiled` impl and by aidw_grid.py:phase2_weights_full
// on the grid path) and, with AOAS, src/repro/kernels/aidw_tiled.py:
// _weight_kernel_aoas (launched by aidw_tiled_aoas, `tiled` with
// layout="aoas").  With CONST_AH it replaces src/repro/kernels/idw_tiled.py:
// _idw_kernel (launched by idw_tiled_soa, the `idw` impl): the same sweep
// at one alpha / 2 for every query, passed by value and rounded to the
// dtype once on the host, as jnp.asarray(alpha * 0.5, dtype) rounds it.
// With FOLD it is the ring's fold (the port of the jnp scan
// src/repro/core/distributed.py:86 _fold_weights, which has no Pallas
// kernel): the same sweep over a data shard, but the four partials (sum_w,
// sum_wz, min_d2, hit_z) start from the values carried in, each tile's sums
// are added to them in data order as _fold_weights adds s + sum(tile), the
// strict `<` keeps the carried minimum on a tie, and the epilogue writes
// the four partials, or, on the ring's last step, z.
//
// The sum order, which fixes the bits: each query sums its weights
// sequentially inside each tile of tile_d points (the plan's block_d, the
// Pallas kernel's data tile), folds the tile sums into running totals in
// data order, and keeps the first minimum d^2 and its z with a strict `<`.
// A float32 sum of 2^20 terms in one accumulator would lose the small
// far-field weights against the large near ones; with the plain version's
// tile boundaries only the order inside a tile differs from it.  No atomics
// and no split of the data axis: a query's z depends on the data order
// alone, not on the block size, the batch size or which other queries
// share the launch (the masked arm of the far-field plans gathers a subset
// of the blocks and relies on that).
//
// What bounds it on an H100, 65,536 queries x m = 2^20 (6.87e10 pairs):
// the special-function units and instruction issue, 33-35 ms each.  In
// float32 a pair costs two MUFU ops (aidw_common.cuh: pow_weight, lg2 and
// ex2), and at 16 MUFU results per SM and clock that is 32.9 ms; it issues
// about 17 SASS instructions (d^2 5, the clamp 2, the two MUFU ops and
// their product, the sums 3, the first minimum 3, a share of the point's
// load and of the loop), and at 128 per SM and clock that is about 35 ms.
// The flops alone (11 a pair) would take 11.3 ms, the bytes far less: the
// data is 12 MiB in float32 and sits in the 50 MB L2 after the first block.
// (The first design, precise expf/logf, issued 54.5 instructions a pair:
// 126.3 ms.)  chip_smoke.py phase 1 prints the count and the MUFU mix from
// the sm_90a SASS, phase 30 the time of each block size.
//
// What the design does about it:
//  * the weight is pow_weight: one MUFU.LG2 and one MUFU.EX2 in float32,
//    in place of precise logf (an FP32 polynomial) and expf (a range
//    reduction around MUFU.EX2); float64 keeps precise exp/log, bit for bit
//    as before;
//  * each point is staged once in shared memory as one {x, y, z, pad}
//    vector (aoas.cuh: a float4, two double2 in float64), so a pair reads
//    it with one broadcast LDS.128 instead of three loads; the AoaS layout
//    is staged by copying its structs as they are;
//  * the loop takes kWeightGroup points a step (aidw_common.cuh:
//    weight_tile, weight_group): their loads, d^2 and weights come before
//    the in-order sums, so each warp has that many chains through the MUFU
//    latencies.  A batch of 65,536 queries gives each scheduler only about
//    4 warps, and one a point at a time left most of the latency bare;
//  * one query a thread.  Two or four queries a thread against one staged
//    point were measured on the H100 and were slower at 8,192, 65,536 and
//    2^20 queries: the MUFU ops, not the issue slots they save, set the
//    pace, and they leave fewer warps (PERF.md, section 6);
//  * a stage holds several plan tiles (kStageBytes of shared memory), so
//    the block meets at a barrier once per stage, not once per tile.
#include "aidw_common.cuh"
#include "aoas.cuh"

namespace aidw {

// A stage is aidw_common.cuh: kStageBytes of {x, y, z, pad} points, shared
// with fused.cu's weight pass.

// AOAS: dx is the (m, 4) struct array and dy, dz are unused.
// CONST_AH: every query takes ah_const and ah is unused.
// FOLD: carry_in (4, n) holds sum_w, sum_wz, min_d2 and hit_z; the kernel
// writes them to carry_out (4, n), which may be carry_in, or z to out where
// carry_out is NULL.
// One thread a query; stage_d is a multiple of tile_d.
template <typename T, bool AOAS, bool CONST_AH, bool FOLD>
__global__ void weight_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                              const T* __restrict__ ah, const T* __restrict__ dx,
                              const T* __restrict__ dy, const T* __restrict__ dz, int n, int m,
                              int tile_d, int stage_d, T eps, T tiny, T ah_const, T* __restrict__ out,
                              const T* carry_in, T* carry_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sp = reinterpret_cast<T*>(smem_raw);  // stage_d points of {x, y, z, pad}

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
  if constexpr (FOLD) {
    if (live) {
      sum_w = carry_in[q];
      sum_wz = carry_in[n + q];
      min_d2 = carry_in[2LL * n + q];
      hit_z = carry_in[3LL * n + q];
    }
  }
  const auto point = [sp](int j, T& x, T& y, T& z) { staged_xyz(sp, j, x, y, z); };

  for (int base = 0; base < m; base += stage_d) {
    const int cnt = min(stage_d, m - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      if constexpr (AOAS) {
        stage_struct(sp, i, dx, base + i);
      } else {
        stage_point(sp, i, dx[base + i], dy[base + i], dz[base + i]);
      }
    }
    __syncthreads();
    for (int t0 = 0; t0 < cnt; t0 += tile_d)
      weight_tile(px, py, neg_ah, t0, min(t0 + tile_d, cnt), point, tiny, sum_w, sum_wz, min_d2, hit_z);
    __syncthreads();
  }
  if (!live) return;
  if constexpr (FOLD) {
    if (carry_out != nullptr) {
      carry_out[q] = sum_w;
      carry_out[n + q] = sum_wz;
      carry_out[2LL * n + q] = min_d2;
      carry_out[3LL * n + q] = hit_z;
      return;
    }
  }
  out[q] = (min_d2 <= eps) ? hit_z : sum_wz / sum_w;
}

template <typename T, bool AOAS, bool CONST_AH = false, bool FOLD = false>
cudaError_t launch(const void* qx, const void* qy, const void* ah, const void* dx, const void* dy,
                   const void* dz, int n, int m, int tile_d, int threads, double eps, double tiny, void* out,
                   void* stream, double ah_const = 0.0, const void* carry_in = nullptr, void* carry_out = nullptr) {
  if (FOLD && (carry_in == nullptr || (carry_out == nullptr) == (out == nullptr))) return cudaErrorInvalidValue;
  if (n <= 0) return cudaSuccess;
  const size_t point_bytes = 4 * sizeof(T);
  const size_t tile_bytes = static_cast<size_t>(tile_d) * point_bytes;
  if (threads <= 0 || threads > 1024 || tile_d <= 0 || tile_bytes > kMaxSharedBytes) return cudaErrorInvalidValue;
  const size_t tiles = tile_bytes >= kStageBytes ? 1 : kStageBytes / tile_bytes;
  const int stage_d = static_cast<int>(tiles) * tile_d;
  const size_t smem = static_cast<size_t>(stage_d) * point_bytes;
  auto kernel = weight_kernel<T, AOAS, CONST_AH, FOLD>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  const int blocks = (n + threads - 1) / threads;
  kernel<<<blocks, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qx), static_cast<const T*>(qy), static_cast<const T*>(ah), static_cast<const T*>(dx),
      static_cast<const T*>(dy), static_cast<const T*>(dz), n, m, tile_d, stage_d, static_cast<T>(eps),
      static_cast<T>(tiny), static_cast<T>(ah_const), static_cast<T*>(out), static_cast<const T*>(carry_in),
      static_cast<T*>(carry_out));
  return cudaGetLastError();
}

}  // namespace aidw

// out[q] for q < n.  qx, qy, ah (= alpha / 2): (n,); dx, dy, dz: (m,),
// summed in tiles of tile_d points; `threads` a block, one query a thread.
#define AIDW_WEIGHT_ENTRY(NAME, T)                                                               \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* ah, const void* dx,   \
                              const void* dy, const void* dz, int n, int m, int tile_d,          \
                              int threads, double eps, double tiny, void* out, void* stream) {   \
    return aidw::launch<T, false>(qx, qy, ah, dx, dy, dz, n, m, tile_d, threads, eps, tiny, out,  \
                                  stream);                                                       \
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
                              const void* dz, int n, int m, int tile_d, int threads,             \
                              double alpha, double eps, double tiny, void* out, void* stream) {  \
    return aidw::launch<T, false, true>(qx, qy, nullptr, dx, dy, dz, n, m, tile_d, threads, eps,  \
                                        tiny, out, stream, alpha * 0.5);                          \
  }

AIDW_IDW_ENTRY(aidw_idw_f32, float)
AIDW_IDW_ENTRY(aidw_idw_f64, double)

// The ring's fold (FOLD) on a data shard dx, dy, dz of m points: carry_in
// (4, n) = sum_w, sum_wz, min_d2, hit_z carried in; carry_out (4, n) the
// four partials after the shard, or, with carry_out NULL (the ring's last
// step), z (n,) to out.
#define AIDW_WEIGHT_FOLD_ENTRY(NAME, T)                                                           \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* ah, const void* dx,   \
                              const void* dy, const void* dz, const void* carry_in, int n, int m, \
                              int tile_d, int threads, double eps, double tiny, void* carry_out,  \
                              void* out, void* stream) {                                          \
    return aidw::launch<T, false, false, true>(qx, qy, ah, dx, dy, dz, n, m, tile_d, threads, eps, \
                                               tiny, out, stream, 0.0, carry_in, carry_out);      \
  }

AIDW_WEIGHT_FOLD_ENTRY(aidw_weight_fold_f32, float)
AIDW_WEIGHT_FOLD_ENTRY(aidw_weight_fold_f64, double)
