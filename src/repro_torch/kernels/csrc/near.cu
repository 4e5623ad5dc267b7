// Near-field half of the far-field Phase 2 of AIDW: for each query, the
// exact weight sums over its query block's near-field candidate row, with
// the raw accumulators (sum w, sum w z, min d^2, z at the first minimum)
// written out instead of a finished z, so the engine can add the far-cell
// terms (far.cu) before it divides.
//
// Replaces src/repro/kernels/aidw_grid.py:_near_weight_kernel (launched by
// aidw_grid.py:phase2_near_weights).
//
// Design: weight.cu's sweep (one thread per query, tiles streamed through
// shared memory, every thread reading the same point) over a candidate row
// per query block, with knn.cu's tile table.  Query q reads row q / block_q;
// the CUDA block's thread count divides block_q, so a CUDA block never spans
// two rows and all its threads walk the same nt[row] tiles of tile_d points.
// The tail past nt[row] * tile_d is sentinel padding (weight 0, d^2 = +inf)
// and is not read.  Each tile is summed into its own accumulators in runs
// of kSumRun points (each run left to right, then the run sums left to
// right: the plain version's run_sum order) and the tile sums are folded
// into the running totals at the tile_d boundaries, the Pallas kernel's tile
// boundaries, with no compensation.  A tile wider than kNearChunk is staged
// through shared memory in kNearChunk-point pieces without breaking its sum
// (tile_d and kNearChunk are multiples of kSumRun).  The minimum uses a
// strict `<`, which keeps the first index, as weight_tile's rule does.  No
// atomics: results are the same bits from run to run.
//
// w = exp(-ah * log(max(d^2, tiny))) with precise expf/logf, never powf and
// never fast math; d^2 through the _rn helpers of aidw_common.cuh.
//
// What bounds it on an H100: instruction issue, as for weight.cu (the same
// per-pair loop); the pairs are block_q * nt[row] * tile_d per row, and each
// candidate row is read once per CUDA block.
#include "aidw_common.cuh"

namespace aidw {

constexpr int kNearChunk = 1024;  // points staged in shared memory at a time

template <typename T>
__global__ void near_weight_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                                   const T* __restrict__ ah, const T* __restrict__ cand_x,
                                   const T* __restrict__ cand_y, const T* __restrict__ cand_z,
                                   const int* __restrict__ nt, int block_q, int c_tot, int tile_d,
                                   T tiny, T* __restrict__ sw_out, T* __restrict__ swz_out,
                                   T* __restrict__ md_out, T* __restrict__ hz_out) {
  __shared__ T sx[kNearChunk];
  __shared__ T sy[kNearChunk];
  __shared__ T sz[kNearChunk];

  const long long first_q = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long q = first_q + threadIdx.x;
  const long long row = first_q / block_q;  // the whole CUDA block lies in this row
  const T* rx = cand_x + row * c_tot;
  const T* ry = cand_y + row * c_tot;
  const T* rz = cand_z + row * c_tot;
  const long long walk = static_cast<long long>(nt[row]) * tile_d;
  const int len = walk < 0 ? 0 : (walk < c_tot ? static_cast<int>(walk) : c_tot);

  const T px = qx[q];
  const T py = qy[q];
  const T neg_ah = -ah[q];

  T sum_w = T(0), sum_wz = T(0), min_d2 = T(INFINITY), hit_z = T(0);
  for (int base = 0; base < len; base += tile_d) {
    const int cnt = min(tile_d, len - base);
    T tile_w = T(0), tile_wz = T(0);
    for (int c0 = 0; c0 < cnt; c0 += kNearChunk) {
      const int cc = min(kNearChunk, cnt - c0);
      for (int i = threadIdx.x; i < cc; i += blockDim.x) {
        sx[i] = rx[base + c0 + i];
        sy[i] = ry[base + c0 + i];
        sz[i] = rz[base + c0 + i];
      }
      __syncthreads();
      for (int j0 = 0; j0 < cc; j0 += kSumRun) {
        T run_w = T(0), run_wz = T(0);
        for (int j = j0; j < j0 + kSumRun; ++j) {
          const T d2 = sq_dist(px, py, sx[j], sy[j]);
          const T zj = sz[j];
          const T w = exp_p(mul_rn(neg_ah, log_p(d2 > tiny ? d2 : tiny)));
          run_w = add_rn(run_w, w);
          run_wz = add_rn(run_wz, mul_rn(w, zj));
          if (d2 < min_d2) {
            min_d2 = d2;
            hit_z = zj;
          }
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
  md_out[q] = min_d2;
  hz_out[q] = hit_z;
}

template <typename T>
cudaError_t launch_near(const void* qx, const void* qy, const void* ah, const void* cx, const void* cy,
                        const void* cz, const void* nt, int n, int block_q, int c_tot, int tile_d,
                        int threads, double tiny, void* sw, void* swz, void* md, void* hz,
                        void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || n % threads != 0 || block_q % threads != 0 || tile_d <= 0 ||
      tile_d % kSumRun != 0 || c_tot % tile_d != 0)
    return cudaErrorInvalidValue;
  near_weight_kernel<T><<<n / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qx), static_cast<const T*>(qy), static_cast<const T*>(ah),
      static_cast<const T*>(cx), static_cast<const T*>(cy), static_cast<const T*>(cz),
      static_cast<const int*>(nt), block_q, c_tot, tile_d, static_cast<T>(tiny),
      static_cast<T*>(sw), static_cast<T*>(swz), static_cast<T*>(md), static_cast<T*>(hz));
  return cudaGetLastError();
}

}  // namespace aidw

// sw, swz, md, hz [q] for q < n.  qx, qy, ah (= alpha / 2): (n,); cand_x,
// cand_y, cand_z: (n / block_q, c_tot) rows; nt: (n / block_q,) int32 tile
// counts; threads divides block_q and n; kSumRun divides tile_d.
#define AIDW_NEAR_ENTRY(NAME, T)                                                                    \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* ah, const void* cand_x,  \
                              const void* cand_y, const void* cand_z, const void* nt, int n,        \
                              int block_q, int c_tot, int tile_d, int threads, double tiny,         \
                              void* sw, void* swz, void* md, void* hz, void* stream) {              \
    return aidw::launch_near<T>(qx, qy, ah, cand_x, cand_y, cand_z, nt, n, block_q, c_tot, tile_d, \
                                threads, tiny, sw, swz, md, hz, stream);                            \
  }

AIDW_NEAR_ENTRY(aidw_near_weight_f32, float)
AIDW_NEAR_ENTRY(aidw_near_weight_f64, double)
