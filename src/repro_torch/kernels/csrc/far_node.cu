// Quadtree far field of AIDW's Phase 2, one level: for each query, one
// aggregate and dipole term per closed node of its query block's node table,
// count * w into sum w and z_sum * w + grad w . M into sum w z, where M =
// (mx, my) is the node's first z-moment about its centroid.
//
// Replaces src/repro/kernels/aidw_grid.py:_far_node_kernel (launched by
// aidw_grid.py:phase2_far_nodes).
//
// Design: near.cu's sweep over a node table instead of a candidate row.  One
// thread per query; query q reads row q / block_q of the level's id table
// tbl (nb, k_pad) and walks its first nt[row] tiles of tile_d ids.  The CUDA
// block's thread count divides block_q, so a CUDA block never spans two rows
// and all its threads walk the same ids.  The kernel takes the ids, not
// gathered copies of the node values: the threads of a CUDA block together
// read a chunk of ids and gather the six node values of each (centroid x/y,
// count, z-sum, mx, my) from the level's node arrays into shared memory,
// then every thread reads the same node.  A level's node arrays (1.6 MB at
// 65,536 nodes in float32) stay in L2.  An id outside [0, n_nodes] reads the
// sentinel node n_nodes, as the plain version does.
//
// Per term, as the Pallas kernel writes it, every product and sum rounded
// once (the _rn helpers; the division correctly rounded):
//   dqx = qx - cx, dqy = qy - cy, d2 = dqx*dqx + dqy*dqy,
//   w = exp(-ah * log(max(d2, tiny))),
//   grad = ((2*ah) * w) / max(d2, tiny),
//   dip = grad * (dqx*mx + dqy*my),
//   sum w += w * count, sum w z += w * z_sum + dip.
// Each tile is summed in runs of kSumRun terms (each run left to right, then
// the run sums left to right: the plain version's run_sum order) and the tile
// sums are folded into the totals at the tile_d boundaries, the Pallas
// kernel's, with no compensation and no atomics: the same bits run to run.
//
// Pad slots point at the plan's sentinel node: centroid at the coordinate
// sentinel (d2 = +inf, w = exp(-inf) = 0, w / d2 = 0), count, z-sum and
// moments 0, so a pad slot adds exactly 0 and no inf * 0 arises.
//
// w with precise expf/logf, never powf and never fast math.
//
// What bounds it on an H100: instruction issue, as for near.cu (the same
// exp/log per pair, plus a division and five more products and sums); the
// ids are read once per CUDA block and the node values from L2.
#include "aidw_common.cuh"

namespace aidw {

constexpr int kNodeChunk = 512;  // nodes staged in shared memory at a time

__device__ __forceinline__ float div_rn(float a, float b) { return __fdiv_rn(a, b); }
__device__ __forceinline__ double div_rn(double a, double b) { return __ddiv_rn(a, b); }

template <typename T>
__global__ void far_node_kernel(const T* __restrict__ qx, const T* __restrict__ qy,
                                const T* __restrict__ ah, const int* __restrict__ tbl,
                                const int* __restrict__ nt, const T* __restrict__ fx,
                                const T* __restrict__ fy, const T* __restrict__ fcnt,
                                const T* __restrict__ fzs, const T* __restrict__ fmx,
                                const T* __restrict__ fmy, int block_q, int k_pad, int tile_d,
                                int n_nodes, T tiny, T* __restrict__ sw_out,
                                T* __restrict__ swz_out) {
  __shared__ T sx[kNodeChunk];
  __shared__ T sy[kNodeChunk];
  __shared__ T sc[kNodeChunk];
  __shared__ T sz[kNodeChunk];
  __shared__ T smx[kNodeChunk];
  __shared__ T smy[kNodeChunk];

  const long long first_q = static_cast<long long>(blockIdx.x) * blockDim.x;
  const long long q = first_q + threadIdx.x;
  const long long row = first_q / block_q;  // the whole CUDA block lies in this row
  const int* ids = tbl + row * k_pad;
  const long long walk = static_cast<long long>(nt[row]) * tile_d;
  const int len = walk < 0 ? 0 : (walk < k_pad ? static_cast<int>(walk) : k_pad);

  const T px = qx[q];
  const T py = qy[q];
  const T a_half = ah[q];
  const T neg_ah = -a_half;
  const T two_ah = mul_rn(T(2), a_half);

  T sum_w = T(0), sum_wz = T(0);
  for (int base = 0; base < len; base += tile_d) {
    const int cnt = min(tile_d, len - base);
    T tile_w = T(0), tile_wz = T(0);
    for (int c0 = 0; c0 < cnt; c0 += kNodeChunk) {
      const int cc = min(kNodeChunk, cnt - c0);
      for (int i = threadIdx.x; i < cc; i += blockDim.x) {
        int id = ids[base + c0 + i];
        id = (id < 0 || id > n_nodes) ? n_nodes : id;
        sx[i] = fx[id];
        sy[i] = fy[id];
        sc[i] = fcnt[id];
        sz[i] = fzs[id];
        smx[i] = fmx[id];
        smy[i] = fmy[id];
      }
      __syncthreads();
      for (int j0 = 0; j0 < cc; j0 += kSumRun) {
        T run_w = T(0), run_wz = T(0);
        for (int j = j0; j < j0 + kSumRun; ++j) {
          const T dqx = sub_rn(px, sx[j]);
          const T dqy = sub_rn(py, sy[j]);
          const T d2 = add_rn(mul_rn(dqx, dqx), mul_rn(dqy, dqy));
          const T d2c = d2 > tiny ? d2 : tiny;
          const T w = exp_p(mul_rn(neg_ah, log_p(d2c)));
          const T grad = div_rn(mul_rn(two_ah, w), d2c);
          const T dip = mul_rn(grad, add_rn(mul_rn(dqx, smx[j]), mul_rn(dqy, smy[j])));
          run_w = add_rn(run_w, mul_rn(w, sc[j]));
          run_wz = add_rn(run_wz, add_rn(mul_rn(w, sz[j]), dip));
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
cudaError_t launch_far_node(const void* qx, const void* qy, const void* ah, const void* tbl,
                            const void* nt, const void* fx, const void* fy, const void* fcnt,
                            const void* fzs, const void* fmx, const void* fmy, int n, int block_q,
                            int k_pad, int tile_d, int n_nodes, int threads, double tiny, void* sw,
                            void* swz, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || n % threads != 0 || block_q % threads != 0 || tile_d <= 0 ||
      tile_d % kSumRun != 0 || k_pad % tile_d != 0 || n_nodes < 0)
    return cudaErrorInvalidValue;
  far_node_kernel<T><<<n / threads, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(qx), static_cast<const T*>(qy), static_cast<const T*>(ah),
      static_cast<const int*>(tbl), static_cast<const int*>(nt), static_cast<const T*>(fx),
      static_cast<const T*>(fy), static_cast<const T*>(fcnt), static_cast<const T*>(fzs),
      static_cast<const T*>(fmx), static_cast<const T*>(fmy), block_q, k_pad, tile_d, n_nodes,
      static_cast<T>(tiny), static_cast<T*>(sw), static_cast<T*>(swz));
  return cudaGetLastError();
}

}  // namespace aidw

// sw, swz [q] for q < n.  qx, qy, ah (= alpha / 2): (n,); tbl: (n / block_q,
// k_pad) int32 node ids; nt: (n / block_q,) int32 tile counts; fx, fy, fcnt,
// fzs, fmx, fmy: (n_nodes + 1,), the last the sentinel node; threads divides
// block_q and n; kSumRun divides tile_d, tile_d divides k_pad.
#define AIDW_FAR_NODE_ENTRY(NAME, T)                                                              \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* ah, const void* tbl,   \
                              const void* nt, const void* fx, const void* fy, const void* fcnt,   \
                              const void* fzs, const void* fmx, const void* fmy, int n,           \
                              int block_q, int k_pad, int tile_d, int n_nodes, int threads,       \
                              double tiny, void* sw, void* swz, void* stream) {                   \
    return aidw::launch_far_node<T>(qx, qy, ah, tbl, nt, fx, fy, fcnt, fzs, fmx, fmy, n, block_q, \
                                    k_pad, tile_d, n_nodes, threads, tiny, sw, swz, stream);      \
  }

AIDW_FAR_NODE_ENTRY(aidw_far_node_f32, float)
AIDW_FAR_NODE_ENTRY(aidw_far_node_f64, double)
