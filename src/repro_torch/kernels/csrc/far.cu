// Far-field half of the far-field Phase 2 of AIDW: for each query, one
// aggregate term per grid cell outside its query block's near rectangle,
// count * w(centroid) into sum w and z_sum * w(centroid) into sum w z.
//
// Replaces src/repro/kernels/aidw_grid.py:_far_cell_kernel (launched by
// aidw_grid.py:phase2_far_aggregates).
//
// The sum order, which fixes the bits: one thread per query sweeps the
// plan's padded cells in order, each tile of tile_d cells summed in runs of
// kSumRun cells (each run left to right from 0, then the run sums left to
// right: the plain version's run_sum order), the tile sums folded into the
// running totals at the tile_d boundaries (the Pallas kernel's), with no
// compensation.  No atomics: the same bits run to run.
//
// The near rectangle: the CUDA block's thread count divides block_q, so its
// threads share one query block and its rectangle rects[row] = (xlo, xhi,
// ylo, yhi) (inclusive cell bounds).  A cell inside it was swept exactly by
// near.cu and must add nothing.  The mask is applied once a cell, where the
// block stages it: an inside cell is staged with the sentinel centroid and
// count = z_sum = 0, so its term is ex2(-inf) * 0 = +0.  The plain
// version's term for it is 0 * count = +0 or 0 * z_sum = +-0, and adding
// +-0 to a run, which starts at +0 and is never -0, gives the same bits.
// Pad cells carry the sentinel and 0 already; an empty cell has a finite
// centroid and count 0, so w is finite or 0 and no inf * 0 arises.
//
// What bounds it on an H100, the 65,536-query serving batch of aidw-pod-1m:
// the launch walks every padded cell for every query, about 5.4e9 pairs,
// 5.25e9 of which the inputs need (occupied cells outside the rectangle).
// In float32 a pair costs two MUFU ops (aidw_common.cuh: pow_weight, lg2
// and ex2), 2.5 ms at 16 per SM and clock, and about 15 SASS instructions
// (d^2 5, the clamp, the MUFU ops and their product, two products, two
// sums, a share of the load and of the loop), about 2.4 ms at 128 per SM
// and clock.  The cell arrays (about 1.5 MB in float32) are read from L2,
// once per CUDA block.  The first design (precise expf/logf, six 4-byte
// shared loads and the rectangle test every pair) ran 13.18 ms.
//
// What the design does about it:
//  * the weight is pow_weight: one MUFU.LG2 and one MUFU.EX2 in float32;
//    float64 keeps precise exp/log and its bits;
//  * each cell is staged once a CUDA block as one {cent_x, cent_y, count,
//    z_sum} vector, the rectangle applied there, so a pair is one LDS.128
//    and no integer test;
//  * the loop takes kWeightGroup cells a step (aidw_common.cuh: run_span,
//    run_group), their loads, d^2 and weights before the in-order sums;
//  * two stage buffers, one barrier a stage: right after it each thread
//    writes its cells of the next stage into the other buffer, then sweeps
//    this one.  Those loads are not overlapped with the sweep; a float32
//    stage is 4-8 cells a thread (256 or 128 threads) against 1,024 pairs.
#include "aidw_common.cuh"

namespace aidw {

// one stage buffer: 1,024 float32 or 512 float64 cells; two buffers a CUDA block
constexpr int kFarStageBytes = 16 * 1024;

template <typename T>
__global__ void far_cell_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                                const T* __restrict__ ah, const int* __restrict__ rects,
                                const T* __restrict__ fx, const T* __restrict__ fy,
                                const T* __restrict__ fcnt, const T* __restrict__ fzs,
                                const int* __restrict__ fix, const int* __restrict__ fiy,
                                int block_q, int ncp, int tile_d, T tiny, T* __restrict__ sw_out,
                                T* __restrict__ swz_out) {
  constexpr int kStage = kFarStageBytes / (4 * static_cast<int>(sizeof(T)));
  static_assert(kStage % kSumRun == 0, "a stage holds whole runs");
  __shared__ __align__(16) T stage[2][4 * kStage];

  const long long first_q = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long q = first_q + threadIdx.x;
  const long long row = first_q / block_q;  // the whole CUDA block lies in this query block
  const int xlo = rects[4 * row], xhi = rects[4 * row + 1], ylo = rects[4 * row + 2], yhi = rects[4 * row + 3];
  const T sent = coord_sentinel<T>();

  const T px = qx[q];
  const T py = qy[q];
  const T neg_ah = -ah[q];

  // stage s holds cells [base, base + kStage), the rectangle's masked
  const auto fill = [&](int s, int base) {
    T* buf = stage[s & 1];
    const int cnt = min(kStage, ncp - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      const int c = base + i;
      const int cx = fix[c], cy = fiy[c];
      if (cx >= xlo && cx <= xhi && cy >= ylo && cy <= yhi) {
        stage_vec(buf, i, sent, sent, T(0), T(0));
      } else {
        stage_vec(buf, i, fx[c], fy[c], fcnt[c], fzs[c]);
      }
    }
  };

  T sum_w = T(0), sum_wz = T(0), tile_w = T(0), tile_wz = T(0), unused_d2 = T(INFINITY), unused_z = T(0);
  if (ncp > 0) fill(0, 0);
  for (int base = 0, s = 0; base < ncp; base += kStage, ++s) {
    __syncthreads();  // stage s written; every thread is done with stage s - 1
    if (base + kStage < ncp) fill(s + 1, base + kStage);
    run_stage<T, false>(stage[s & 1], base, min(kStage, ncp - base), tile_d, px, py, neg_ah, tiny, tile_w, tile_wz,
                        sum_w, sum_wz, unused_d2, unused_z);
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
