// Near-field half of the far-field Phase 2 of AIDW: for each query, the
// exact weight sums over its query block's near-field candidate row, with
// the raw accumulators (sum w, sum w z, min d^2, z at the first minimum)
// written out instead of a finished z, so the engine can add the far-cell
// terms (far.cu) before it divides.
//
// Replaces src/repro/kernels/aidw_grid.py:_near_weight_kernel (launched by
// aidw_grid.py:phase2_near_weights).
//
// The sum order, which fixes the bits: query q reads row q / block_q and
// walks its first nt[row] tiles of tile_d points (the tail is sentinel
// padding, weight 0, and is not read).  Each tile is summed in runs of
// kSumRun points (each run left to right from 0, then the run sums left to
// right: the plain version's run_sum order) and the tile sums are folded
// into the running totals at the tile_d boundaries, the Pallas kernel's,
// with no compensation.  The minimum keeps the first index with a strict
// `<`.  No atomics: the same bits run to run, whatever the block size.
//
// What bounds it on an H100, the 65,536-query serving batch of aidw-pod-1m
// (1.95e9 pairs): in float32 a pair costs two MUFU ops (aidw_common.cuh:
// pow_weight, lg2 and ex2), 0.93 ms at 16 per SM and clock, and about 16
// SASS instructions (d^2 5, the clamp, the MUFU ops and their product, the
// sums 3, a share of the minimum's test and of the load), about 1 ms at 128
// per SM and clock.  The rows are read from L2, once per CUDA block.  The
// first design (precise expf/logf, three 4-byte shared loads a pair, one
// pair at a time, 256 threads for every batch) ran 5.67 ms.
//
// What the design does about it:
//  * the weight is pow_weight: one MUFU.LG2 and one MUFU.EX2 in float32;
//    float64 keeps precise exp/log and its bits;
//  * each candidate is staged as one {x, y, z, pad} vector (one LDS.128 a
//    pair), copied with cp.async into the other of two buffers while the
//    current stage is swept: one barrier a stage;
//  * the loop takes kWeightGroup points a step (aidw_common.cuh: run_span,
//    run_group): their loads, d^2 and weights come before the in-order
//    sums, and one test of the group's minimum d^2 guards the first-minimum
//    update;
//  * rows differ in length, and a CUDA block never spans two rows, so the
//    threads a block come from kernels/aidw_grid.py: row_launch, which
//    takes fewer for a batch of few rows so they spread over more SMs;
//  * the CUDA blocks take the rows in the order `order` gives, longest
//    first: a batch of a few hundred rows is one wave, which the block
//    scheduler deals out over the SMs in block order, so each SM gets one
//    block of every band of similar lengths.  In row order a SM's share
//    rested on which long rows fell on it, and one batch's time moved from
//    one layout of its rows to the next (chip_smoke.py phase 32 times the
//    launch rule's pick in both orders).
#include "aidw_common.cuh"

namespace aidw {

// one stage buffer: 512 float32 or 256 float64 points of {x, y, z, pad};
// two buffers a CUDA block
constexpr int kNearStageBytes = 8 * 1024;

template <typename T>
__global__ void near_weight_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                                   const T* __restrict__ ah, const T* __restrict__ cand_x,
                                   const T* __restrict__ cand_y, const T* __restrict__ cand_z,
                                   const int* __restrict__ nt, const int* __restrict__ order, int block_q,
                                   int c_tot, int tile_d,
                                   T tiny, T* __restrict__ sw_out, T* __restrict__ swz_out,
                                   T* __restrict__ md_out, T* __restrict__ hz_out) {
  constexpr int kStage = kNearStageBytes / (4 * static_cast<int>(sizeof(T)));
  static_assert(kStage % kSumRun == 0, "a stage holds whole runs");
  __shared__ __align__(16) T stage[2][4 * kStage];

  // the CUDA blocks of one row are consecutive; the rows come in `order`
  // (NULL: row order).  The whole CUDA block lies in its row.
  const int per_row = block_q / static_cast<int>(blockDim.x);
  const int slot = static_cast<int>(blockIdx.x) / per_row;
  const long long row = order ? order[slot] : slot;
  const long long q = row * block_q + static_cast<long long>(blockIdx.x % per_row) * blockDim.x + threadIdx.x;
  const T* rx = cand_x + row * c_tot;
  const T* ry = cand_y + row * c_tot;
  const T* rz = cand_z + row * c_tot;
  const long long walk = static_cast<long long>(nt[row]) * tile_d;
  const int len = walk < 0 ? 0 : (walk < c_tot ? static_cast<int>(walk) : c_tot);

  const T px = qx[q];
  const T py = qy[q];
  const T neg_ah = -ah[q];

  // stage s holds points [base, base + kStage) of the row as {x, y, z, -}
  const auto issue = [&](int s, int base) {
    T* buf = stage[s & 1];
    const int cnt = min(kStage, len - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      cp_async_elem(buf + 4 * i, rx + base + i);
      cp_async_elem(buf + 4 * i + 1, ry + base + i);
      cp_async_elem(buf + 4 * i + 2, rz + base + i);
    }
  };

  T sum_w = T(0), sum_wz = T(0), tile_w = T(0), tile_wz = T(0), min_d2 = T(INFINITY), hit_z = T(0);
  if (len > 0) issue(0, 0);
  for (int base = 0, s = 0; base < len; base += kStage, ++s) {
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every thread is done with stage s - 1
    if (base + kStage < len) issue(s + 1, base + kStage);  // lands while this stage is swept
    run_stage<T, true>(stage[s & 1], base, min(kStage, len - base), tile_d, px, py, neg_ah, tiny, tile_w, tile_wz,
                       sum_w, sum_wz, min_d2, hit_z);
  }
  sw_out[q] = sum_w;
  swz_out[q] = sum_wz;
  md_out[q] = min_d2;
  hz_out[q] = hit_z;
}

template <typename T>
cudaError_t launch_near(const void* qx, const void* qy, const void* ah, const void* cx, const void* cy,
                        const void* cz, const void* nt, const void* order, int n, int block_q, int c_tot,
                        int tile_d,
                        int threads, double tiny, void* sw, void* swz, void* md, void* hz,
                        void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || n % threads != 0 || block_q % threads != 0 || tile_d <= 0 ||
      tile_d % kSumRun != 0 || c_tot % tile_d != 0)
    return cudaErrorInvalidValue;
  near_weight_kernel<T><<<n / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qx), static_cast<const T*>(qy), static_cast<const T*>(ah),
      static_cast<const T*>(cx), static_cast<const T*>(cy), static_cast<const T*>(cz),
      static_cast<const int*>(nt), static_cast<const int*>(order), block_q, c_tot, tile_d, static_cast<T>(tiny),
      static_cast<T*>(sw), static_cast<T*>(swz), static_cast<T*>(md), static_cast<T*>(hz));
  return cudaGetLastError();
}

}  // namespace aidw

// sw, swz, md, hz [q] for q < n.  qx, qy, ah (= alpha / 2): (n,); cand_x,
// cand_y, cand_z: (n / block_q, c_tot) rows; nt: (n / block_q,) int32 tile
// counts; order: NULL or a permutation of the rows, (n / block_q,) int32, in
// which the CUDA blocks take them; threads divides block_q and n; kSumRun
// divides tile_d.
#define AIDW_NEAR_ENTRY(NAME, T)                                                                    \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* ah, const void* cand_x,  \
                              const void* cand_y, const void* cand_z, const void* nt,               \
                              const void* order, int n, int block_q, int c_tot, int tile_d,         \
                              int threads, double tiny, void* sw, void* swz, void* md, void* hz,    \
                              void* stream) {                                                       \
    return aidw::launch_near<T>(qx, qy, ah, cand_x, cand_y, cand_z, nt, order, n, block_q, c_tot,  \
                                tile_d, threads, tiny, sw, swz, md, hz, stream);                    \
  }

AIDW_NEAR_ENTRY(aidw_near_weight_f32, float)
AIDW_NEAR_ENTRY(aidw_near_weight_f64, double)
