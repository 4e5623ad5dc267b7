// Far-field half of the far-field Phase 2 of AIDW: for each query, one
// aggregate term per grid cell outside its query block's near rectangle,
// count * w(centroid) into sum w and z_sum * w(centroid) into sum w z.
//
// Replaces src/repro/kernels/aidw_grid.py:_far_cell_kernel (launched by
// aidw_grid.py:phase2_far_aggregates).
//
// Design: one thread per query; the plan's padded cell arrays (centroid x/y,
// count, z-sum, integer cell x/y), shared by every query, stream through
// shared memory, every thread reading the same cell.  The CUDA block's
// thread count divides block_q, so its threads share one query block and one
// near rectangle rects[row] = (xlo, xhi, ylo, yhi) (inclusive cell bounds),
// read once per CUDA block.  A cell inside the rectangle gets weight 0:
// its points were swept exactly by near.cu.  Each tile of tile_d cells is
// summed into its own accumulators in runs of kSumRun cells (each run left
// to right, then the run sums left to right: the plain version's run_sum
// order) and the tile sums are folded into the running totals at the tile_d
// boundaries (the Pallas kernel's), with no compensation.  No atomics: the
// same bits run to run.
//
// Pad and empty cells add exactly 0: a pad cell has the sentinel centroid
// (d^2 = +inf, log = +inf, w = exp(-inf) = 0), count 0, z-sum 0 and cell
// coordinates -1; an empty cell has a finite centroid (its cell centre) and
// count 0.  w is finite or 0 in both cases, so no inf * 0 arises.
//
// w = exp(-ah * log(max(d^2, tiny))) with precise expf/logf, never powf and
// never fast math; d^2 and the products through the _rn helpers.
//
// What bounds it on an H100: instruction issue, as for weight.cu, plus the
// four integer compares of the rectangle test per pair; the cell arrays
// (6 values per cell) are read once per CUDA block, from L2 after the first.
#include "aidw_common.cuh"

namespace aidw {

constexpr int kFarChunk = 1024;  // cells staged in shared memory at a time

template <typename T>
__global__ void far_cell_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                                const T* __restrict__ ah, const int* __restrict__ rects,
                                const T* __restrict__ fx, const T* __restrict__ fy,
                                const T* __restrict__ fcnt, const T* __restrict__ fzs,
                                const int* __restrict__ fix, const int* __restrict__ fiy,
                                int block_q, int ncp, int tile_d, T tiny, T* __restrict__ sw_out,
                                T* __restrict__ swz_out) {
  __shared__ T sx[kFarChunk];
  __shared__ T sy[kFarChunk];
  __shared__ T sc[kFarChunk];
  __shared__ T sz[kFarChunk];
  __shared__ int si[kFarChunk];
  __shared__ int sj[kFarChunk];
  __shared__ int rect[4];

  const long long first_q = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long q = first_q + threadIdx.x;
  const long long row = first_q / block_q;  // the whole CUDA block lies in this query block
  for (int i = threadIdx.x; i < 4; i += blockDim.x) rect[i] = rects[4 * row + i];
  __syncthreads();
  const int xlo = rect[0], xhi = rect[1], ylo = rect[2], yhi = rect[3];

  const T px = qx[q];
  const T py = qy[q];
  const T neg_ah = -ah[q];

  T sum_w = T(0), sum_wz = T(0);
  for (int base = 0; base < ncp; base += tile_d) {
    const int cnt = min(tile_d, ncp - base);
    T tile_w = T(0), tile_wz = T(0);
    for (int c0 = 0; c0 < cnt; c0 += kFarChunk) {
      const int cc = min(kFarChunk, cnt - c0);
      for (int i = threadIdx.x; i < cc; i += blockDim.x) {
        const int c = base + c0 + i;
        sx[i] = fx[c];
        sy[i] = fy[c];
        sc[i] = fcnt[c];
        sz[i] = fzs[c];
        si[i] = fix[c];
        sj[i] = fiy[c];
      }
      __syncthreads();
      for (int j0 = 0; j0 < cc; j0 += kSumRun) {
        T run_w = T(0), run_wz = T(0);
        for (int j = j0; j < j0 + kSumRun; ++j) {
          const T d2 = sq_dist(px, py, sx[j], sy[j]);
          T w = exp_p(mul_rn(neg_ah, log_p(d2 > tiny ? d2 : tiny)));
          const int cx = si[j], cy = sj[j];
          if (cx >= xlo && cx <= xhi && cy >= ylo && cy <= yhi) w = T(0);
          run_w = add_rn(run_w, mul_rn(w, sc[j]));
          run_wz = add_rn(run_wz, mul_rn(w, sz[j]));
        }
        tile_w = add_rn(tile_w, run_w);
        tile_wz = add_rn(tile_wz, run_wz);
      }
      __syncthreads();
    }
    sum_w = add_rn(sum_w, tile_w);
    sum_wz = add_rn(sum_wz, tile_wz);
  }
  sw_out[q] = sum_w;
  swz_out[q] = sum_wz;
}

template <typename T>
cudaError_t launch_far(const void* qx, const void* qy, const void* ah, const void* rects,
                       const void* fx, const void* fy, const void* fcnt, const void* fzs,
                       const void* fix, const void* fiy, int n, int block_q, int ncp, int tile_d,
                       int threads, double tiny, void* sw, void* swz, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || n % threads != 0 || block_q % threads != 0 || tile_d <= 0 ||
      tile_d % kSumRun != 0 || ncp % tile_d != 0)
    return cudaErrorInvalidValue;
  far_cell_kernel<T><<<n / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qx), static_cast<const T*>(qy), static_cast<const T*>(ah),
      static_cast<const int*>(rects), static_cast<const T*>(fx), static_cast<const T*>(fy),
      static_cast<const T*>(fcnt), static_cast<const T*>(fzs), static_cast<const int*>(fix),
      static_cast<const int*>(fiy), block_q, ncp, tile_d, static_cast<T>(tiny),
      static_cast<T*>(sw), static_cast<T*>(swz));
  return cudaGetLastError();
}

}  // namespace aidw

// sw, swz [q] for q < n.  qx, qy, ah (= alpha / 2): (n,); rects: (n / block_q,
// 4) int32; fx, fy, fcnt, fzs: (ncp,); fix, fiy: (ncp,) int32; threads
// divides block_q and n; kSumRun divides tile_d.
#define AIDW_FAR_ENTRY(NAME, T)                                                                     \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* ah, const void* rects,   \
                              const void* fx, const void* fy, const void* fcnt, const void* fzs,    \
                              const void* fix, const void* fiy, int n, int block_q, int ncp,        \
                              int tile_d, int threads, double tiny, void* sw, void* swz,            \
                              void* stream) {                                                       \
    return aidw::launch_far<T>(qx, qy, ah, rects, fx, fy, fcnt, fzs, fix, fiy, n, block_q, ncp,    \
                               tile_d, threads, tiny, sw, swz, stream);                             \
  }

AIDW_FAR_ENTRY(aidw_far_cell_f32, float)
AIDW_FAR_ENTRY(aidw_far_cell_f64, double)
