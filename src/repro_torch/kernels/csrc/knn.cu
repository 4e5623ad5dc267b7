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
// FOLD is the ring's fold (the port of the jnp scan
// src/repro/core/distributed.py:62 _fold_knn, which has no Pallas kernel):
// the same walk on one shared data row (a data shard), but each query's
// k-best starts from the k values carried in (best_in, (n, K)) instead of
// +inf, and the epilogue writes the sorted k-best to best_out (n, K); on
// the ring's last step best_out is NULL and it writes alpha as B1 does,
// with the constants of the whole data count.  The carry enters through
// the insertion, once, in part 0; the other parts start at +inf, so the
// merge of the parts gives the k smallest of the carry and the shard.
//
// The set a walk keeps, the K smallest d^2 with their multiplicities, does
// not depend on the order in which the points come: an insertion takes a
// value only when it is strictly below the k-th best (duplicates kept, as
// merge_k_best keeps them), +inf sentinels and NaN never enter.  So a
// query's points may be split between threads and taken in groups, and its
// alpha keeps its bits.
//
// What bounds it on an H100: the d^2 arithmetic.  A pair is 2 sub, 2 mul
// and 1 add, written with the _rn intrinsics so that nvcc forms no FMA,
// plus one min or compare: 6 FP32-pipe slots at 128 per SM and clock
// (33.45e12 a second, half the 67 TFLOP/s that counts an FMA twice), or on
// the FP64 pipe at 64.  65,536 queries x m = 2^20 is 12.3 ms in float32,
// 24.6 ms in float64.  Next comes instruction issue (one a clock per
// scheduler): the float32 hot loop issues 7.6 SASS instructions a pair
// (chip_smoke.py phase 1), 15.7 ms.  The row is read from L2 (8 MiB of x
// and y at m = 2^20 in float32) once per CUDA block and part; the shared-
// memory reads are broadcasts.  The first design (one point a step, a
// compare and a branch after every d^2, two 4-byte shared loads a pair, a
// barrier pair every 256 points) ran at a third of the bound, 36.7 ms.
//
// What the design does about it:
//  * a step takes kKnnGroup points (aidw_common.cuh: knn_span, knn_group),
//    two groups a loop step: their loads are vector loads (float4 /
//    double2) of the staged x and y arrays, their d^2 independent chains,
//    and one test against the k-th best decides whether the group is
//    inserted (a min tree of FMNMX in float32; eight compares in float64,
//    which has no min instruction);
//  * the row is staged in stages of kKnnStageBytes of x and y, copied with
//    cp.async into the other of two buffers while the current one is swept,
//    so the block meets at one barrier a stage.  AOAS copies the (x, y, z,
//    0) structs with cp.async into a landing buffer and converts them to
//    the x and y arrays after the stage lands (one barrier more), so both
//    layouts run the one inner loop;
//  * S threads share a query (splits): thread t takes query t % (blockDim
//    / S) and part t / (blockDim / S) of every stage (each part a multiple
//    of kKnnGroup points, or of the bin), so a warp's lanes read the same
//    point; at the end the S sorted k-best arrays are merged through shared
//    memory with the same insertion.  S multiplies the warps a small batch
//    has; kernels/aidw_tiled.py: knn_launch picks it.
//
// BINNED (nbins > 0) cuts the row into bins of sub = tile_d / nbins
// consecutive points (a bin is index / sub, since tiles start at multiples
// of tile_d); each thread folds its bin's points into a running minimum and
// inserts it into the k-best when the bin ends: the k smallest bin minima,
// the multiset of JAX's merge_k_best(best, bin_minima).  A bin of whole
// groups folds each group's minimum in (knn_bins); any other bin goes
// through knn_span.  A bin may span two stages when S = 1; with S > 1 the
// stage is a multiple of sub and a part a whole number of bins.
// VOTE (tiled_v2, S = 1) also counts the Pallas kernel's merges.  That
// kernel merges a (block_q, tile_d) tile only if some d^2 in it is below
// its row's k-th best tau at the tile's start.  So each thread keeps its
// tile's minimum d^2 and tau at the tile's start; at the tile's end the
// CUDA block votes on `minimum < tau` with __syncthreads_or, and thread 0
// writes the vote to votes[block][tile]; the wrapper ORs the votes of the
// CUDA blocks inside one plan block and counts them.  A stage is swept in
// spans that end at tile ends, so the vote sits between spans, outside the
// per-pair loop.  Every pair still goes through the insertion, which keeps
// the same k-smallest multiset whether a tile merges or not: alpha is B1's
// bits.
#include "aidw_common.cuh"
#include "aoas.cuh"

namespace aidw {

// The stage (aidw_common.cuh: kKnnStageBytes of x and y) and its copy
// (stage_values) are shared with fused.cu's kNN pass.

// cnt (x, y, z, 0) structs of src (aligned to a struct) into dst, as they are.
template <typename T>
__device__ __forceinline__ void stage_structs(T* dst, const T* __restrict__ src, int cnt) {
  constexpr int V = 16 / sizeof(T);  // values a 16-byte copy
  for (int i = threadIdx.x; i < cnt * 4 / V; i += blockDim.x) cp_async16(dst + i * V, src + i * V);
}

// The binned prefilter's walk over points a <= j < b (multiples of
// kKnnGroup) of the staged arrays when a bin is a whole number of groups:
// each group's minimum folds into the bin's, and every groups_per_bin-th
// group, counted down by left across calls, the bin's minimum goes into
// the k-best.
template <typename T, int K>
__device__ __forceinline__ void knn_bins(T px, T py, const T* sx, const T* sy, int a, int b, int groups_per_bin,
                                         T& bin_min, int& left, T (&best)[K]) {
  constexpr int G = kKnnGroup;
#pragma unroll 2
  for (int j = a; j < b; j += G) {
    T x[G], y[G];
    load_group(sx + j, x);
    load_group(sy + j, y);
    bin_min = min_num(bin_min, knn_group<T, K, G, false, true>(px, py, x, y, best));
    if (--left == 0) {
      kbest_insert(best, bin_min);
      bin_min = T(INFINITY);
      left = groups_per_bin;
    }
  }
}

// AOAS: cand_x is the (c_tot, 4) struct array and cand_y is unused.
// VOTE: votes is (gridDim.x, c_tot / tile_d), one byte per CUDA block and tile.
// FOLD: best_in (n, K) is carried in; best_out (n, K), or alpha where it is NULL.
// splits threads share a query; stage_d points a stage (for BINNED with
// splits > 1 a multiple of sub).  Shared memory: SoA two stages of x and y
// (4 stage_d values), AOAS one stage of x and y and a landing stage of
// structs (6 stage_d values); with splits > 1 at least (splits - 1) K
// values per query of the block for the merge.
template <typename T, int K, bool AOAS, bool BINNED, bool VOTE, bool FOLD>
__global__ void knn_alpha_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                                 const T* __restrict__ cand_x, const T* __restrict__ cand_y,
                                 long long row_stride, const int* __restrict__ nt, int block_q,
                                 int c_tot, int tile_d, int sub, int stage_d, int splits,
                                 AlphaConsts<T> consts, T* __restrict__ alpha, unsigned char* __restrict__ votes,
                                 const T* __restrict__ best_in, T* __restrict__ best_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);

  const int qc = blockDim.x / splits;  // queries a CUDA block
  const int part = threadIdx.x / qc;
  const int qi = threadIdx.x - part * qc;
  const long long first_q = static_cast<long long>(blockIdx.x) * qc;
  const long long q = first_q + qi;
  const long long row = first_q / block_q;  // the whole CUDA block lies in this row
  const T* rx = cand_x + row * row_stride;
  const T* ry = AOAS ? nullptr : cand_y + row * row_stride;
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
  if constexpr (FOLD) {
    if (part == 0) {  // the carry, in any order, through the insertion
#pragma unroll
      for (int j = 0; j < K; ++j) kbest_insert(best, best_in[q * K + j]);
    }
  }

  // stage s of points [base, base + cnt) into its buffer
  const auto issue = [&](int s, int base) {
    const int cnt = min(stage_d, len - base);
    if constexpr (AOAS) {
      stage_structs(smem + 2 * stage_d, rx + 4LL * base, cnt);
    } else {
      T* buf = smem + (s & 1) * 2 * stage_d;
      stage_values(buf, rx + base, cnt);
      stage_values(buf + stage_d, ry + base, cnt);
    }
  };

  const int seg = BINNED ? sub : tile_d;  // BINNED: a bin; VOTE: a tile
  const int unit = BINNED ? sub : kKnnGroup;  // a part is a multiple of it
  T seg_min = T(INFINITY);  // BINNED: the current bin's minimum; VOTE: the current tile's
  T tau = best[K - 1];      // VOTE: the k-th best at the current tile's start
  int left = sub / kKnnGroup;  // BINNED with whole-group bins: groups to the current bin's end
  if (len > 0) issue(0, 0);
  for (int base = 0, s = 0; base < len; base += stage_d, ++s) {
    const int cnt = min(stage_d, len - base);
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every thread is done with stage s - 1
    const T* sx;
    if constexpr (AOAS) {
      const T* raw = smem + 2 * stage_d;
      for (int i = threadIdx.x; i < cnt; i += blockDim.x) load_xy(raw, i, smem[i], smem[stage_d + i]);
      __syncthreads();
      sx = smem;
    } else {
      sx = smem + (s & 1) * 2 * stage_d;
    }
    const T* sy = sx + stage_d;
    if (base + stage_d < len) issue(s + 1, base + stage_d);  // lands while this stage is swept

    const int per = ((cnt + splits - 1) / splits + unit - 1) / unit * unit;
    const int lo = min(part * per, cnt);
    const int hi = min(lo + per, cnt);
    if constexpr (!BINNED && !VOTE) {
      knn_span<T, K, true, false>(px, py, sx, sy, lo, hi, best);
    } else if (BINNED && sub % kKnnGroup == 0) {
      knn_bins(px, py, sx, sy, lo, hi, sub / kKnnGroup, seg_min, left, best);
    } else {
      int next = ((base + lo) / seg + 1) * seg - base;  // the end of the segment holding point lo
      for (int t = lo; t < hi;) {
        const int end = min(hi, next);
        seg_min = min_num(seg_min, knn_span<T, K, VOTE, true>(px, py, sx, sy, t, end, best));
        t = end;
        if (end != next) continue;  // the segment goes on in the next stage
        next += seg;
        if constexpr (BINNED) {
          kbest_insert(best, seg_min);
        } else {  // a tile ends: the block votes
          const int any = __syncthreads_or(seg_min < tau);
          if (threadIdx.x == 0)
            votes[static_cast<long long>(blockIdx.x) * (c_tot / tile_d) + (base + end - 1) / tile_d] = any != 0;
          tau = best[K - 1];
        }
        seg_min = T(INFINITY);
      }
    }
  }

  if (splits > 1) {  // merge the parts' k-best arrays into part 0's
    T* merge = smem;  // [part - 1][j][qi]
    __syncthreads();  // every part is done with the stages
    if (part > 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) merge[((part - 1) * K + j) * qc + qi] = best[j];
    }
    __syncthreads();
    if (part > 0) return;
    for (int p = 1; p < splits; ++p) {
#pragma unroll
      for (int j = 0; j < K; ++j) kbest_insert(best, merge[((p - 1) * K + j) * qc + qi]);
    }
  }
  if constexpr (FOLD) {
    if (best_out != nullptr) {
#pragma unroll
      for (int j = 0; j < K; ++j) best_out[q * K + j] = best[j];
      return;
    }
  }
  alpha[q] = kbest_alpha(best, consts);
}

// The stage of a launch: kKnnStageBytes of x and y, for BINNED with
// splits > 1 cut to a multiple of the bin.  Returns 0 where none fits.
template <typename T>
int stage_points(int sub, int splits) {
  const int cap = kKnnStageBytes / (2 * static_cast<int>(sizeof(T)));
  if (sub > 0 && splits > 1) return sub <= cap && cap % sub == 0 ? cap : 0;
  return cap;
}

template <typename T, int K, bool AOAS>
cudaError_t launch_k(const T* qx, const T* qy, const T* cx, const T* cy, long long row_stride,
                     const int* nt, int n, int block_q, int c_tot, int tile_d, int nbins,
                     int threads, int splits, AlphaConsts<T> consts, T* alpha, unsigned char* votes,
                     const T* best_in, T* best_out, cudaStream_t stream) {
  const int qc = threads / splits;
  const int blocks = n / qc;
  const int sub = nbins > 0 ? tile_d / nbins : 0;
  const int stage_d = stage_points<T>(sub, splits);
  if (stage_d == 0) return cudaErrorInvalidValue;
  const size_t stage_bytes = static_cast<size_t>(AOAS ? 6 : 4) * stage_d * sizeof(T);
  const size_t merge_bytes = static_cast<size_t>(splits - 1) * K * qc * sizeof(T);
  const size_t smem = stage_bytes > merge_bytes ? stage_bytes : merge_bytes;
  if (smem > kMaxSharedBytes) return cudaErrorInvalidValue;
  if (AOAS && (votes != nullptr || nbins > 0))
    return cudaErrorInvalidValue;  // the merge count and the bins are SoA-only, as in the reference
  auto kernel = best_in != nullptr ? &knn_alpha_kernel<T, K, false, false, false, true>
                : votes != nullptr ? &knn_alpha_kernel<T, K, false, false, true, false>
                : nbins > 0        ? &knn_alpha_kernel<T, K, false, true, false, false>
                                   : &knn_alpha_kernel<T, K, AOAS, false, false, false>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (err != cudaSuccess) return err;
  }
  kernel<<<blocks, threads, smem, stream>>>(qx, qy, cx, cy, row_stride, nt, block_q, c_tot, tile_d, sub, stage_d,
                                            splits, consts, alpha, votes, best_in, best_out);
  return cudaGetLastError();
}

// votes != NULL takes the merge count (shared row, no tile table, no bins,
// splits 1); best_in != NULL the fold (shared row, no tile table, no bins,
// no votes; best_out or alpha, one of them).  threads a CUDA block, splits
// of them a query: the block's threads / splits queries lie in one
// candidate row.
template <typename T, bool AOAS>
cudaError_t launch(const void* qx, const void* qy, const void* cx, const void* cy,
                   long long row_stride, const void* nt, int n, int block_q, int c_tot, int tile_d,
                   int nbins, int k, int threads, int splits, AlphaConsts<T> c, void* alpha, void* votes,
                   void* stream, const void* best_in = nullptr, void* best_out = nullptr) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || splits <= 0 || threads % splits != 0) return cudaErrorInvalidValue;
  const int qc = threads / splits;
  if (n % qc != 0 || block_q % qc != 0) return cudaErrorInvalidValue;
  if (tile_d <= 0 || nbins < 0 || (nbins > 0 && (tile_d % nbins != 0 || c_tot % tile_d != 0)))
    return cudaErrorInvalidValue;
  if (votes != nullptr && (row_stride != 0 || nt != nullptr || nbins != 0 || c_tot % tile_d != 0 || splits != 1))
    return cudaErrorInvalidValue;
  if (best_in != nullptr && (AOAS || row_stride != 0 || nt != nullptr || nbins != 0 || votes != nullptr ||
                             (best_out == nullptr) == (alpha == nullptr)))
    return cudaErrorInvalidValue;
  const T* a = static_cast<const T*>(qx);
  const T* b = static_cast<const T*>(qy);
  const T* x = static_cast<const T*>(cx);
  const T* y = static_cast<const T*>(cy);
  const int* t = static_cast<const int*>(nt);
  T* out = static_cast<T*>(alpha);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned char* v = static_cast<unsigned char*>(votes);
  const T* b_in = static_cast<const T*>(best_in);
  T* b_out = static_cast<T*>(best_out);
#define AIDW_K_CASE(KV) \
  case KV:              \
    return launch_k<T, KV, AOAS>(a, b, x, y, row_stride, t, n, block_q, c_tot, tile_d, nbins, threads, splits, \
                                 c, out, v, b_in, b_out, s);
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
// tile of tile_d points).  threads a CUDA block, splits of them sharing a
// query (kernels/aidw_tiled.py: knn_launch).  The alpha constants come as
// doubles and are rounded to the dtype.
#define AIDW_KNN_ENTRY(NAME, T)                                                                   \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* cand_x,                \
                              const void* cand_y, long long row_stride, const void* nt, int n,    \
                              int block_q, int c_tot, int tile_d, int nbins, int k, int threads,  \
                              int splits, double r_exp, double pi_over_rmax, double r_min,        \
                              double r_max, double a1, double a2, double a3, double a4,           \
                              double a5, void* alpha,                                             \
                              void* stream) {                                                     \
    return aidw::launch<T, false>(qx, qy, cand_x, cand_y, row_stride, nt, n, block_q, c_tot,      \
                                  tile_d, nbins, k, threads, splits,                              \
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
                              int splits, double r_exp, double pi_over_rmax, double r_min,        \
                              double r_max, double a1, double a2, double a3, double a4,           \
                              double a5, void* alpha,                                             \
                              void* stream) {                                                     \
    return aidw::launch<T, true>(qx, qy, data, nullptr, 0, nullptr, n, block_q, c_tot, tile_d, 0, \
                                 k, threads, splits,                                              \
                                 aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,    \
                                                            a1, a2, a3, a4, a5),                  \
                                 alpha, nullptr, stream);                                         \
  }

AIDW_KNN_AOAS_ENTRY(aidw_knn_alpha_aoas_f32, float)
AIDW_KNN_AOAS_ENTRY(aidw_knn_alpha_aoas_f64, double)

// The threshold-skip twin on the shared data row (m points, m % tile_d == 0):
// alpha, and votes (n / threads, m / tile_d) bytes, 1 where some thread of
// CUDA block b fired an insertion in tile j; splits must be 1.
#define AIDW_KNN_V2_ENTRY(NAME, T)                                                                \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* dx, const void* dy,    \
                              int n, int block_q, int m, int tile_d, int k, int threads,          \
                              int splits, double r_exp, double pi_over_rmax, double r_min,        \
                              double r_max, double a1, double a2, double a3, double a4,           \
                              double a5, void* alpha,                                             \
                              void* votes, void* stream) {                                        \
    if (votes == nullptr) return cudaErrorInvalidValue;                                           \
    return aidw::launch<T, false>(qx, qy, dx, dy, 0, nullptr, n, block_q, m, tile_d, 0, k,        \
                                  threads, splits,                                                \
                                  aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,   \
                                                             a1, a2, a3, a4, a5),                 \
                                  alpha, votes, stream);                                          \
  }

AIDW_KNN_V2_ENTRY(aidw_knn_alpha_v2_f32, float)
AIDW_KNN_V2_ENTRY(aidw_knn_alpha_v2_f64, double)

// The ring's fold (FOLD) on a data shard dx, dy of m points: best_in (n, k)
// carried in; best_out (n, k) the sorted k-best, or, with best_out NULL
// (the ring's last step), alpha (n,) with the alpha constants of the whole
// data count.  threads a CUDA block, splits of them a query: the block's
// threads / splits queries lie in one block of block_q, which divides n.
#define AIDW_KNN_FOLD_ENTRY(NAME, T)                                                              \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* dx, const void* dy,    \
                              const void* best_in, int n, int block_q, int m, int k, int threads, \
                              int splits, double r_exp, double pi_over_rmax, double r_min,        \
                              double r_max, double a1, double a2, double a3, double a4,           \
                              double a5, void* best_out, void* alpha, void* stream) {             \
    if (best_in == nullptr) return cudaErrorInvalidValue;                                         \
    return aidw::launch<T, false>(qx, qy, dx, dy, 0, nullptr, n, block_q, m, m > 0 ? m : 1, 0, k, \
                                  threads, splits,                                                \
                                  aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max,   \
                                                             a1, a2, a3, a4, a5),                 \
                                  alpha, nullptr, stream, best_in, best_out);                     \
  }

AIDW_KNN_FOLD_ENTRY(aidw_knn_fold_f32, float)
AIDW_KNN_FOLD_ENTRY(aidw_knn_fold_f64, double)
