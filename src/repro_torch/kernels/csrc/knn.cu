// Phase 1 of AIDW: the k nearest squared distances of each query, then its
// adaptive power alpha (Eq. 2-6).
//
// Replaces four TPU kernels:
//   src/repro/kernels/aidw_tiled.py:_knn_kernel_soa  (dense walk; the
//     `tiled` impl's shared data row and the grid path's pipeline="dense";
//     with nbins > 0 the `binned` prefilter)
//   src/repro/kernels/aidw_grid.py:_knn_kernel_skip  (per-block tile table,
//     the grid path's default pipeline="prefetch")
//   src/repro/kernels/aidw_tiled.py:_knn_kernel_aoas (the shared data row
//     in the AoaS layout, `tiled` with layout="aoas")
//   src/repro/kernels/aidw_tiled_v2.py:_knn_kernel_v2 (the shared data row
//     with the threshold-skip merge count, `tiled_v2`)
// One source serves all.  Query q reads candidate row q / block_q (a row
// stride of 0 gives the `tiled` impl's single shared data row).  With a tile
// table `nt`, row i walks only its first nt[i] * tile_d candidates; without
// one it walks the whole row.  The skipped tail holds only sentinel points,
// whose +inf never enters a k-best set, so both walks give the same bits.
//
// Design: one thread per query; the CUDA block's threads all lie in one
// candidate row and stream it through shared memory in tiles of blockDim
// points (the paper's tiled kernel).  The k-best is a sorted register array
// of compile-time size K, updated by a branch-free insertion with strict `<`
// against the k-th best (duplicates kept, as merge_k_best keeps them).
// AOAS stages each (x, y, z, 0) struct into the same sx, sy tiles with one
// vector load, so the inner loop, and the bits, are the SoA ones.
// BINNED (nbins > 0) cuts the row into bins of sub = tile_d / nbins
// consecutive points (a bin is index / sub, since tiles start at multiples
// of tile_d); each thread keeps its current bin's running minimum across
// the staged chunks and inserts it into the k-best when the bin ends: the
// k smallest bin minima, the multiset of JAX's merge_k_best(best,
// bin_minima).
// VOTE (tiled_v2) also counts the Pallas kernel's merges.  That kernel
// merges a (block_q, tile_d) tile only if some d^2 in it is below its row's
// k-th best tau at the tile's start.  So each thread keeps its tile's
// minimum d^2 (one min a pair) and tau at the tile's start; at the tile's
// end the CUDA block votes on `minimum < tau` with __syncthreads_or, and
// thread 0 writes the vote to votes[block][tile]; the wrapper ORs the votes
// of the CUDA blocks inside one plan block and counts them.  The block
// stages chunks of gcd(blockDim, tile_d) points, so no chunk straddles a
// tile and the vote sits after a chunk's loop, outside the per-pair loop.
// Every pair still goes through the insertion, which keeps the same
// k-smallest multiset whether a tile merges or not: alpha is B1's bits.
//
// What bounds it on an H100: the d^2 arithmetic (5 flops and one compare
// per pair, 67 TFLOP/s f32, 34 TFLOP/s f64); the shared-memory reads are
// broadcasts.  A candidate row is read once per CUDA block, not per query.
#include "aidw_common.cuh"
#include "aoas.cuh"

namespace aidw {

// AOAS: cand_x is the (c_tot, 4) struct array and cand_y is unused.
// VOTE: votes is (gridDim.x, c_tot / tile_d), one byte per CUDA block and tile.
template <typename T, int K, bool AOAS, bool BINNED, bool VOTE>
__global__ void knn_alpha_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                                 const T* __restrict__ cand_x, const T* __restrict__ cand_y,
                                 long long row_stride, const int* __restrict__ nt, int block_q,
                                 int c_tot, int tile_d, int sub, AlphaConsts<T> consts,
                                 T* __restrict__ alpha, unsigned char* __restrict__ votes) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* sx = reinterpret_cast<T*>(smem_raw);
  T* sy = sx + blockDim.x;

  const long long first_q = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long q = first_q + threadIdx.x;
  const long long row = first_q / block_q;  // the whole CUDA block lies in this row
  const T* rx = cand_x + row * row_stride;
  const T* ry = cand_y + row * row_stride;
  int len = c_tot;
  if (nt != nullptr) {
    const long long walk = static_cast<long long>(nt[row]) * tile_d;
    len = walk < 0 ? 0 : (walk < c_tot ? static_cast<int>(walk) : c_tot);
  }

  const T px = qx[q];
  const T py = qy[q];
  T best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = T(INFINITY);

  T bin_min = T(INFINITY);  // BINNED: the current bin's running minimum
  int in_bin = 0;           // BINNED: points of the current bin seen so far
  T tile_min = T(INFINITY);  // VOTE: the current tile's minimum d^2
  T tau = best[K - 1];       // VOTE: the k-th best at the current tile's start
  int step = blockDim.x;     // points a staged chunk; VOTE: gcd(blockDim, tile_d)
  if constexpr (VOTE) {
    for (int b = tile_d; b != 0;) {
      const int r = step % b;
      step = b;
      b = r;
    }
  }
  for (int base = 0; base < len; base += step) {
    const int idx = base + threadIdx.x;
    if ((!VOTE || threadIdx.x < step) && idx < len) {
      if constexpr (AOAS) {
        load_xy(rx, idx, sx[threadIdx.x], sy[threadIdx.x]);
      } else {
        sx[threadIdx.x] = rx[idx];
        sy[threadIdx.x] = ry[idx];
      }
    }
    __syncthreads();
    const int cnt = min(step, len - base);
    for (int j = 0; j < cnt; ++j) {
      T v = sq_dist(px, py, sx[j], sy[j]);
      if constexpr (BINNED) {
        bin_min = v < bin_min ? v : bin_min;
        if (++in_bin < sub) continue;
        v = bin_min;
        bin_min = T(INFINITY);
        in_bin = 0;
      }
      if constexpr (VOTE) tile_min = v < tile_min ? v : tile_min;
      kbest_insert(best, v);
    }
    if constexpr (VOTE) {
      if ((base + cnt) % tile_d == 0) {  // a tile ends with this chunk: the block votes
        const int any = __syncthreads_or(tile_min < tau);
        if (threadIdx.x == 0) votes[static_cast<long long>(blockIdx.x) * (c_tot / tile_d) + (base / tile_d)] = any != 0;
        tile_min = T(INFINITY);
        tau = best[K - 1];
      }
    }
    __syncthreads();
  }
  alpha[q] = kbest_alpha(best, consts);
}

template <typename T, int K, bool AOAS>
cudaError_t launch_k(const T* qx, const T* qy, const T* cx, const T* cy, long long row_stride,
                     const int* nt, int n, int block_q, int c_tot, int tile_d, int nbins,
                     int threads, AlphaConsts<T> consts, T* alpha, unsigned char* votes,
                     cudaStream_t stream) {
  const int blocks = n / threads;
  const size_t smem = 2 * static_cast<size_t>(threads) * sizeof(T);
  if (votes != nullptr) {
    if constexpr (AOAS) {
      return cudaErrorInvalidValue;  // the merge count is SoA-only, as in the reference
    } else {
      knn_alpha_kernel<T, K, false, false, true><<<blocks, threads, smem, stream>>>(
          qx, qy, cx, cy, row_stride, nt, block_q, c_tot, tile_d, 0, consts, alpha, votes);
    }
  } else if (nbins > 0) {
    if constexpr (AOAS) {
      return cudaErrorInvalidValue;  // the binned prefilter is SoA-only, as in the reference
    } else {
      knn_alpha_kernel<T, K, false, true, false><<<blocks, threads, smem, stream>>>(
          qx, qy, cx, cy, row_stride, nt, block_q, c_tot, tile_d, tile_d / nbins, consts, alpha, nullptr);
    }
  } else {
    knn_alpha_kernel<T, K, AOAS, false, false><<<blocks, threads, smem, stream>>>(
        qx, qy, cx, cy, row_stride, nt, block_q, c_tot, tile_d, 0, consts, alpha, nullptr);
  }
  return cudaGetLastError();
}

// votes != NULL takes the merge count (shared row, no tile table, no bins).
template <typename T, bool AOAS>
cudaError_t launch(const void* qx, const void* qy, const void* cx, const void* cy,
                   long long row_stride, const void* nt, int n, int block_q, int c_tot, int tile_d,
                   int nbins, int k, int threads, AlphaConsts<T> c, void* alpha, void* votes,
                   void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || n % threads != 0 || block_q % threads != 0)
    return cudaErrorInvalidValue;
  if (nbins < 0 || (nbins > 0 && (tile_d % nbins != 0 || c_tot % tile_d != 0)))
    return cudaErrorInvalidValue;
  if (votes != nullptr && (row_stride != 0 || nt != nullptr || nbins != 0 || tile_d <= 0 || c_tot % tile_d != 0))
    return cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(qx);
  const T* b = static_cast<const T*>(qy);
  const T* x = static_cast<const T*>(cx);
  const T* y = static_cast<const T*>(cy);
  const int* t = static_cast<const int*>(nt);
  T* out = static_cast<T*>(alpha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* v = static_cast<unsigned char*>(votes);
#define AIDW_K_CASE(KV) \
  case KV:              \
    return launch_k<T, KV, AOAS>(a, b, x, y, row_stride, t, n, block_q, c_tot, tile_d, nbins, threads, c, \
                                 out, v, s);
  switch (k) {
    AIDW_K_LIST(AIDW_K_CASE)
    default:
      break;
  }
#undef AIDW_K_CASE
  return cudaErrorInvalidValue;  // no instance for this k
}

}  // namespace aidw

// alpha[q] for q < n.  qx, qy: (n,); cand_x, cand_y: rows of c_tot points,
// row r at offset r * row_stride; nt: (n / block_q,) int32 tile counts or
// NULL; nbins > 0 takes the binned prefilter's bin minima (nbins bins per
// tile of tile_d points).  The alpha constants come as doubles and are
// rounded to the dtype.
#define AIDW_KNN_ENTRY(NAME, T)                                                                   \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* cand_x,                \
                              const void* cand_y, long long row_stride, const void* nt, int n,    \
                              int block_q, int c_tot, int tile_d, int nbins, int k, int threads,  \
                              double r_exp, double pi_over_rmax, double r_min, double r_max,      \
                              double a1, double a2, double a3, double a4, double a5, void* alpha, \
                              void* stream) {                                                     \
    return aidw::launch<T, false>(qx, qy, cand_x, cand_y, row_stride, nt, n, block_q, c_tot,      \
                                  tile_d, nbins, k, threads,                                      \
                                  aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,   \
                                                             a1, a2, a3, a4, a5),                 \
                                  alpha, nullptr, stream);                                        \
  }

AIDW_KNN_ENTRY(aidw_knn_alpha_f32, float)
AIDW_KNN_ENTRY(aidw_knn_alpha_f64, double)

// The AoaS twin on the shared data row: data is the (c_tot, 4) struct array.
#define AIDW_KNN_AOAS_ENTRY(NAME, T)                                                              \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* data, int n,           \
                              int block_q, int c_tot, int tile_d, int k, int threads,             \
                              double r_exp, double pi_over_rmax, double r_min, double r_max,      \
                              double a1, double a2, double a3, double a4, double a5, void* alpha, \
                              void* stream) {                                                     \
    return aidw::launch<T, true>(qx, qy, data, nullptr, 0, nullptr, n, block_q, c_tot, tile_d, 0, \
                                 k, threads,                                                      \
                                 aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,    \
                                                            a1, a2, a3, a4, a5),                  \
                                 alpha, nullptr, stream);                                         \
  }

AIDW_KNN_AOAS_ENTRY(aidw_knn_alpha_aoas_f32, float)
AIDW_KNN_AOAS_ENTRY(aidw_knn_alpha_aoas_f64, double)

// The threshold-skip twin on the shared data row (m points, m % tile_d == 0):
// alpha, and votes (n / threads, m / tile_d) bytes, 1 where some thread of
// CUDA block b fired an insertion in tile j.
#define AIDW_KNN_V2_ENTRY(NAME, T)                                                                \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* dx, const void* dy,    \
                              int n, int block_q, int m, int tile_d, int k, int threads,          \
                              double r_exp, double pi_over_rmax, double r_min, double r_max,      \
                              double a1, double a2, double a3, double a4, double a5, void* alpha, \
                              void* votes, void* stream) {                                        \
    if (votes == nullptr) return cudaErrorInvalidValue;                                           \
    return aidw::launch<T, false>(qx, qy, dx, dy, 0, nullptr, n, block_q, m, tile_d, 0, k,        \
                                  threads,                                                        \
                                  aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,   \
                                                             a1, a2, a3, a4, a5),                 \
                                  alpha, votes, stream);                                          \
  }

AIDW_KNN_V2_ENTRY(aidw_knn_alpha_v2_f32, float)
AIDW_KNN_V2_ENTRY(aidw_knn_alpha_v2_f64, double)
