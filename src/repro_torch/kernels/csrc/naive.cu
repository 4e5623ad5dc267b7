// The paper's naive AIDW kernel: both phases in one launch, no data in
// shared memory.
//
// Replaces two TPU kernels:
//   src/repro/kernels/aidw_naive.py:_naive_kernel_soa  (`naive`, SoA)
//   src/repro/kernels/aidw_naive.py:_naive_kernel_aoas (`naive`,
//     layout="aoas")
//
// What makes it the paper's naive kernel: every data point is read from
// global memory, through L1 and L2, in both passes, and the distances are
// computed twice; no data point is staged in shared memory (it serves only
// to merge a query's partial results).  So naive against tiled
// (knn.cu + weight.cu, which stage the data) is the paper's comparison.
//
// The bits: pass 1 keeps the k smallest d^2 (a multiset: knn.cu's insertion,
// strict `<` against the k-th best, duplicates kept, +inf and NaN never
// entering) and computes alpha with knn.cu's epilogue, so alpha is the bits
// of the tiled kernel's whatever order the points come in.  Pass 2 sums the
// weights in weight.cu's order: each tile of tile_d points (the plan's
// block_d) left to right from 0 (aidw_common.cuh: weight_tile, whose
// weights are pow_weight's lg2/ex2 in float32), the tile sums folded into
// the totals in data order, the first minimum d^2 and its z kept with a
// strict `<`.  So z is the bits of the tiled kernels' z.  The Pallas kernel
// sums its whole row in one jnp.sum, whose order is XLA's; the results agree
// within the fp slack.
//
// What bounds it on an H100, 65,536 queries x m = 2^20 (6.87e10 pairs a
// pass): pass 2 as weight.cu, the special-function units (2 MUFU ops a
// float32 pair, 32.9 ms) and instruction issue (about 16.5 SASS a pair);
// pass 1 as knn.cu, its 6 FP32 operations a pair (12.3 ms) and about 8 SASS
// a pair.  Then the latency of the global loads: the data (12 MiB in
// float32 SoA, 16 MiB AoaS) sits in L2, and every warp streams all of it
// through L1 twice.  The first design (one point a step and one k-th-best
// test a point in pass 1, two or three scalar loads a point, one thread a
// query, 256 threads a block) ran at 30% of the 39.0 ms operations bound:
// 130.0 ms (SoA), 134.5 (AoaS).
//
// What the design does about it:
//  * pass 1 walks kKnnGroup points a step behind one k-th-best test
//    (aidw_common.cuh: knn_rows, knn_group), SoA x and y as 16-byte vector
//    loads (two float4 each for 8 points; four double2 in float64), AoaS
//    one 8-byte load of x and y a struct;
//  * pass 2 feeds weight_tile kWeightGroup points from three 16-byte loads
//    of x, y and z in SoA (SoaRows; six in float64), one float4 (two
//    double2) a point in AoaS;
//  * S threads of a CUDA block share a query, one part each, as in knn.cu
//    (kernels/aidw_naive.py: naive_launch, S = 1, 2 or 4): thread t takes
//    query t % (blockDim / S) and part t / (blockDim / S), and blockDim / S
//    is a multiple of 32, so all the lanes of a warp work on one part and
//    read one address (each load one broadcast), and S warps hide the
//    latency of a query's loads.  In pass 1 part p takes the groups p, p +
//    S, ... of kKnnGroup points (knn_rows; a group's loads sit at fixed
//    offsets from one address); the parts' k-best arrays go through shared
//    memory, and every part
//    inserts the others' (every part ends with the row's k-best and
//    alpha).  In pass 2 part p takes tiles p, p + S, ... of each round,
//    each summed from 0 with the tile's own first minimum, and puts its
//    sums and minimum in shared memory; after the barrier every thread folds
//    the round's S tiles in tile order: the totals one thread would have,
//    bit for bit.  Shared memory holds nothing else.
#include "aidw_common.cuh"
#include "aoas.cuh"

namespace aidw {

template <typename T, bool AOAS>
__device__ __forceinline__ auto global_rows(const T* dx, const T* dy, const T* dz) {
  if constexpr (AOAS) {
    return AoasRows<T>{dx};
  } else {
    return SoaRows<T>{dx, dy, dz};
  }
}

// AOAS: dx is the (m, 4) struct array and dy, dz are unused.  splits (S)
// threads a query, blockDim.x / S queries a CUDA block (a multiple of 32
// when S > 1).  Shared memory with S > 1: the parts' k-best arrays (S K
// values a query), then two buffers of the rounds' tile sums and minima (8 S
// values a query).
template <typename T, int K, bool AOAS>
__global__ void naive_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                             const T* __restrict__ dx, const T* __restrict__ dy,
                             const T* __restrict__ dz, int n, int m, int tile_d, int splits,
                             AlphaConsts<T> consts, T eps, T tiny, T* __restrict__ z_out,
                             T* __restrict__ alpha_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const part_sums = reinterpret_cast<T*>(smem_raw);
  const int qc = blockDim.x / splits;  // queries a CUDA block
  const int part = threadIdx.x / qc;
  const int qi = threadIdx.x - part * qc;
  const long long q = static_cast<long long>(blockIdx.x) * qc + qi;
  // a thread past the batch computes on its last query and stores nothing:
  // every thread meets the barriers
  const bool live = q < n;
  const long long qq = live ? q : n - 1;
  const auto rows = global_rows<T, AOAS>(dx, dy, dz);
  const T px = qx[qq];
  const T py = qy[qq];

  // ---- pass 1: k-best of d^2, then alpha (paper Fig. 3 lines 11-34)
  T best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = T(INFINITY);
  knn_rows(px, py, rows, m, part, splits, best);
  if (splits > 1) {  // every part inserts the other parts' k-bests
#pragma unroll
    for (int j = 0; j < K; ++j) part_sums[(part * K + j) * qc + qi] = best[j];
    __syncthreads();
    for (int p = 0; p < splits; ++p) {
      if (p == part) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) kbest_insert(best, part_sums[(p * K + j) * qc + qi]);
    }
    __syncthreads();  // the k-bests are read before the rounds' sums land
  }
  const T alpha = kbest_alpha(best, consts);

  // ---- pass 2: the distances again, then the weights (lines 52-58)
  const T neg_ah = -mul_rn(alpha, T(0.5));
  T sum_w = T(0), sum_wz = T(0), min_d2 = T(INFINITY), hit_z = T(0);
  // a tile's sums into the totals in data order, its first minimum with `<`
  const auto fold = [&](T w, T wz, T d2, T zj) {
    sum_w = add_rn(sum_w, w);
    sum_wz = add_rn(sum_wz, wz);
    if (d2 < min_d2) {
      min_d2 = d2;
      hit_z = zj;
    }
  };
  const int n_tiles = (m + tile_d - 1) / tile_d;
  for (int r = 0; r < n_tiles; r += splits) {
    // this part's tile of the round from 0: 0 + its sums gives their bits
    // (a sum that starts at +0 is never -0)
    T tw = T(0), twz = T(0), tmin = T(INFINITY), thz = T(0);
    const int tile = r + part;
    if (tile < n_tiles) {
      const int t0 = tile * tile_d;
      weight_tile(px, py, neg_ah, t0, min(t0 + tile_d, m), rows, tiny, tw, twz, tmin, thz);
    }
    if (splits == 1) {
      fold(tw, twz, tmin, thz);
      continue;
    }
    // the round's S tiles through shared memory, folded in tile order; the
    // buffers alternate, so a round's sums land only after every thread
    // passed the barrier that follows its reads of the round before
    T* const buf = part_sums + ((r / splits) & 1) * 4 * splits * qc;
    buf[(4 * part) * qc + qi] = tw;
    buf[(4 * part + 1) * qc + qi] = twz;
    buf[(4 * part + 2) * qc + qi] = tmin;
    buf[(4 * part + 3) * qc + qi] = thz;
    __syncthreads();
    for (int s = 0; s < splits && r + s < n_tiles; ++s)
      fold(buf[(4 * s) * qc + qi], buf[(4 * s + 1) * qc + qi], buf[(4 * s + 2) * qc + qi],
           buf[(4 * s + 3) * qc + qi]);
  }
  if (live && part == 0) {
    alpha_out[q] = alpha;
    z_out[q] = (min_d2 <= eps) ? hit_z : sum_wz / sum_w;
  }
}

template <typename T, bool AOAS>
cudaError_t launch(const void* qx, const void* qy, const void* dx, const void* dy, const void* dz,
                   int n, int m, int tile_d, int k, int threads, int splits, AlphaConsts<T> c, double eps,
                   double tiny, void* z, void* alpha, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || tile_d <= 0 || m <= 0) return cudaErrorInvalidValue;
  if (splits <= 0 || threads % splits != 0 || (splits > 1 && threads / splits % 32 != 0))
    return cudaErrorInvalidValue;
  const int qc = threads / splits;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + qc - 1) / qc);
  // S > 1: the larger of the k-bests (S k) and the two round buffers (8 S) a query
  const size_t smem = splits > 1 ? static_cast<size_t>(splits) * (k > 8 ? k : 8) * qc * sizeof(T) : 0;
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(qx);
  const T* b = static_cast<const T*>(qy);
  const T* x = static_cast<const T*>(dx);
  const T* y = static_cast<const T*>(dy);
  const T* z_in = static_cast<const T*>(dz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AIDW_NAIVE_CASE(KV)                                                                              \
  case KV: {                                                                                             \
    auto kernel = naive_kernel<T, KV, AOAS>;                                                             \
    if (smem > 48 * 1024) {                                                                              \
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,  \
                                                   static_cast<int>(smem));                              \
      if (err != cudaSuccess) return err;                                                                \
    }                                                                                                    \
    kernel<<<blocks, threads, smem, s>>>(a, b, x, y, z_in, n, m, tile_d, splits, c, static_cast<T>(eps), \
                                         static_cast<T>(tiny), static_cast<T*>(z), static_cast<T*>(alpha)); \
    return cudaGetLastError();                                                                           \
  }
  switch (k) {
    AIDW_K_LIST(AIDW_NAIVE_CASE)
    default:
      break;
  }
#undef AIDW_NAIVE_CASE
  return cudaErrorInvalidValue;  // no instance for this k
}

}  // namespace aidw

// z[q], alpha[q] for q < n.  SoA: qx, qy: (n,); dx, dy, dz: (m,), each
// 16-byte aligned, summed in tiles of tile_d points.  threads a CUDA block,
// splits of them a query (kernels/aidw_naive.py: naive_launch).  The alpha
// constants come as doubles and are rounded to the dtype.
#define AIDW_NAIVE_SOA_ENTRY(NAME, T)                                                            \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* dx, const void* dy,   \
                              const void* dz, int n, int m, int tile_d, int k, int threads,      \
                              int splits, double r_exp, double pi_over_rmax, double r_min,       \
                              double r_max, double a1, double a2, double a3, double a4,          \
                              double a5, double eps, double tiny, void* z, void* alpha,          \
                              void* stream) {                                                    \
    return aidw::launch<T, false>(qx, qy, dx, dy, dz, n, m, tile_d, k, threads, splits,          \
                                  aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,  \
                                                             a1, a2, a3, a4, a5),                \
                                  eps, tiny, z, alpha, stream);                                  \
  }

AIDW_NAIVE_SOA_ENTRY(aidw_naive_soa_f32, float)
AIDW_NAIVE_SOA_ENTRY(aidw_naive_soa_f64, double)

// AoaS: data is the (m, 4) struct array.
#define AIDW_NAIVE_AOAS_ENTRY(NAME, T)                                                           \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* data, int n, int m,   \
                              int tile_d, int k, int threads, int splits, double r_exp,          \
                              double pi_over_rmax, double r_min, double r_max, double a1,        \
                              double a2, double a3, double a4, double a5, double eps,            \
                              double tiny, void* z, void* alpha, void* stream) {                 \
    return aidw::launch<T, true>(qx, qy, data, nullptr, nullptr, n, m, tile_d, k, threads,       \
                                 splits,                                                         \
                                 aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,   \
                                                            a1, a2, a3, a4, a5),                 \
                                 eps, tiny, z, alpha, stream);                                   \
  }

AIDW_NAIVE_AOAS_ENTRY(aidw_naive_aoas_f32, float)
AIDW_NAIVE_AOAS_ENTRY(aidw_naive_aoas_f64, double)
