// Quadtree far field of AIDW's Phase 2, one level: for each query, one
// aggregate and dipole term per closed node of its query block's node table,
// count * w into sum w and z_sum * w + grad w . M into sum w z, where M =
// (mx, my) is the node's first z-moment about its centroid.
//
// Replaces src/repro/kernels/aidw_grid.py:_far_node_kernel (launched by
// aidw_grid.py:phase2_far_nodes).
//
// Per term, every product and sum rounded once (the _rn helpers):
//   dqx = qx - cx, dqy = qy - cy, d2 = dqx*dqx + dqy*dqy,
//   w = pow_weight(-ah, d2, tiny),
//   grad = ((2*ah) * w) / max(d2, tiny),
//   dip = grad * (dqx*mx + dqy*my),
//   sum w += w * count, sum w z += w * z_sum + dip.
// float32: w = 2^(-ah log2 max(d2, tiny)) on the special-function units
// (aidw_common.cuh: pow_weight, one MUFU.LG2 and one MUFU.EX2) and the
// division a product with rcp.approx (rcp_sfu, one MUFU.RCP): three MUFU
// ops a pair, held against the plain version within a per-query tolerance
// (kernels/aidw_grid.py: phase2_far_nodes_tolerance).  float64: precise
// exp/log and a correctly rounded division, the plain version's bits.
//
// The sum order, which fixes the bits: query q reads row q / block_q of the
// level's id table tbl (nb, k_pad).  Each tile of tile_d ids is summed in
// runs of kSumRun terms (each run left to right from 0, then the run sums
// left to right: the plain version's run_sum order) and the tile sums are
// folded into the totals at the tile_d boundaries, the Pallas kernel's,
// with no compensation and no atomics: the same bits run to run, whatever
// the launch shape.
//
// Where the walk stops: the plain version walks a row's first nt[row]
// tiles.  Given the closed counts nc (the table's ids past nc[row] are all
// the sentinel node), the kernel stops at nc[row] rounded up to a run.  A
// sentinel slot (centroid at the coordinate sentinel, count, z-sum and
// moments 0) adds exactly +0 to both sums: d2 = +inf, w = +0, grad = +0, w *
// z_sum = +0 and +0 + (-0) = +0; a run that starts at +0 is never -0, so a
// run, tile or total that adds only such runs keeps its bits.  An id outside
// [0, n_nodes] reads the sentinel node n_nodes, as the plain version does.
//
// What bounds it on an H100, the 65,536-query serving batch of aidw-pod-1m
// (2.49e8 needed pairs over the five levels): the special-function units at
// three MUFU ops a pair, and instruction issue at about 24 SASS a pair (d2
// 5, the clamp, w 3, grad 3, the dipole 4, the count 2, z 3, two shared
// loads).  The first design (precise expf/logf and a division, six 4-byte
// shared loads a pair, one thread per query, synchronous gathers, every
// slot of nt[row] tiles walked) ran 2.34 ms for the five launches.
//
// What the design does about it:
//  * w from pow_weight and grad from rcp_sfu in float32, as above;
//  * each stage of kStage ids is gathered with cp.async into the other of
//    two buffers while the current one is swept, the ids themselves one
//    stage ahead of the nodes, each node staged as {cx, cy, count, z_sum}
//    and {mx, my}: one LDS.128 and one LDS.64 a pair;
//  * S threads share a query (kernels/aidw_grid.py: far_node_launch): part
//    p sums the runs r = p, p + S, ... of each stage and writes the run sums
//    to shared memory, and part 0 folds them into the tile and the totals in
//    run order, as one thread would; a CUDA block holds blockDim.x / S
//    queries of one plan block, so all its threads walk the same ids;
//  * the walk stops at the closed nodes, as above.
#include "aidw_common.cuh"

namespace aidw {

// one stage buffer: 256 float32 or 128 float64 nodes of {cx, cy, count,
// z_sum} and {mx, my}; two buffers a CUDA block
constexpr int kNodeStageBytes = 6 * 1024;
// queries a CUDA block holds when S > 1 (the run sums' shared memory)
constexpr int kMaxSplitQueries = 128;

template <typename T>
__host__ __device__ constexpr int node_stage() {
  return kNodeStageBytes / (6 * static_cast<int>(sizeof(T)));
}

// 2 ah w / max(d2, tiny): float32 with rcp.approx (one MUFU op, 1 ulp),
// float64 correctly rounded, as the plain version divides
__device__ __forceinline__ float grad_scale(float two_ah, float w, float d2, float tiny) {
  return mul_rn(mul_rn(two_ah, w), rcp_sfu(fmaxf(d2, tiny)));
}
__device__ __forceinline__ double grad_scale(double two_ah, double w, double d2, double tiny) {
  return __ddiv_rn(mul_rn(two_ah, w), d2 > tiny ? d2 : tiny);
}

// One run of kSumRun staged nodes j0..j0 + kSumRun - 1 for one query,
// kWeightGroup at a time: the loads, d2, weights and dipoles of a group
// first, then each node's terms added to the run sums in node order.
template <typename T>
__device__ __forceinline__ void node_run(const T* sv, const T* sm, int j0, T px, T py, T neg_ah, T two_ah,
                                         T tiny, T& run_w, T& run_wz) {
  constexpr int U = kWeightGroup;
#pragma unroll
  for (int g = 0; g < kSumRun / U; ++g) {
    T cx[U], cy[U], cnt[U], zs[U], mx[U], my[U], dqx[U], dqy[U], w[U], dip[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int j = j0 + g * U + u;
      staged_vec(sv, j, cx[u], cy[u], cnt[u], zs[u]);
      staged_pair(sm, j, mx[u], my[u]);
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      dqx[u] = sub_rn(px, cx[u]);
      dqy[u] = sub_rn(py, cy[u]);
      const T d2 = add_rn(mul_rn(dqx[u], dqx[u]), mul_rn(dqy[u], dqy[u]));
      w[u] = pow_weight(neg_ah, d2, tiny);
      dip[u] = mul_rn(grad_scale(two_ah, w[u], d2, tiny), add_rn(mul_rn(dqx[u], mx[u]), mul_rn(dqy[u], my[u])));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      run_w = add_rn(run_w, mul_rn(w[u], cnt[u]));
      run_wz = add_rn(run_wz, add_rn(mul_rn(w[u], zs[u]), dip[u]));
    }
  }
}

template <typename T, int S>
__global__ void far_node_kernel(const T* __restrict__ qx, const T* __restrict__ qy, const T* __restrict__ ah,
                                const int* __restrict__ tbl, const int* __restrict__ nt,
                                const int* __restrict__ nc, const T* __restrict__ fx, const T* __restrict__ fy,
                                const T* __restrict__ fcnt, const T* __restrict__ fzs, const T* __restrict__ fmx,
                                const T* __restrict__ fmy, int block_q, int k_pad, int tile_d, int n_nodes,
                                T tiny, T* __restrict__ sw_out, T* __restrict__ swz_out) {
  constexpr int kStage = node_stage<T>();
  static_assert(kStage % kSumRun == 0, "a stage holds whole runs");
  __shared__ __align__(16) T sv[2][4 * kStage];  // {cx, cy, count, z_sum}
  __shared__ __align__(16) T sm[2][2 * kStage];  // {mx, my}
  __shared__ int sid[2][kStage];
  extern __shared__ __align__(16) unsigned char run_bytes[];  // S > 1: [run][query] {w, wz}
  T* runs = reinterpret_cast<T*>(run_bytes);

  const int nq = blockDim.x / S;  // queries of this CUDA block
  const int lane = threadIdx.x % nq;
  const int part = threadIdx.x / nq;  // warp-uniform when nq is a multiple of 32
  const long long first_q = static_cast<long long>(blockIdx.x) * nq;
  const long long q = first_q + lane;
  const long long row = first_q / block_q;  // the whole CUDA block lies in this row
  const int* ids = tbl + row * k_pad;
  const long long walk = static_cast<long long>(nt[row]) * tile_d;
  int len = walk < 0 ? 0 : (walk < k_pad ? static_cast<int>(walk) : k_pad);
  if (nc != nullptr) {
    const int closed = min(max(nc[row], 0), k_pad);
    len = min(len, (closed + kSumRun - 1) / kSumRun * kSumRun);
  }

  const T px = qx[q];
  const T py = qy[q];
  const T a_half = ah[q];
  const T neg_ah = -a_half;
  const T two_ah = mul_rn(T(2), a_half);

  // the ids of stage s, then (once they landed) its nodes, into buffer s & 1
  const auto issue_ids = [&](int s) {
    const int base = s * kStage;
    const int cnt = min(kStage, len - base);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) cp_async_elem(&sid[s & 1][i], ids + base + i);
  };
  const auto issue_nodes = [&](int s) {
    const int b = s & 1;
    const int cnt = min(kStage, len - s * kStage);
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) {
      int id = sid[b][i];
      id = (id < 0 || id > n_nodes) ? n_nodes : id;
      cp_async_elem(&sv[b][4 * i], fx + id);
      cp_async_elem(&sv[b][4 * i + 1], fy + id);
      cp_async_elem(&sv[b][4 * i + 2], fcnt + id);
      cp_async_elem(&sv[b][4 * i + 3], fzs + id);
      cp_async_elem(&sm[b][2 * i], fmx + id);
      cp_async_elem(&sm[b][2 * i + 1], fmy + id);
    }
  };

  T sum_w = T(0), sum_wz = T(0), tile_w = T(0), tile_wz = T(0);
  int tile_end = tile_d;
  // a run's sums into the tile, the tile into the totals at its end
  const auto fold = [&](T run_w, T run_wz, int end) {
    tile_w = add_rn(tile_w, run_w);
    tile_wz = add_rn(tile_wz, run_wz);
    if (end == tile_end) {
      sum_w = add_rn(sum_w, tile_w);
      sum_wz = add_rn(sum_wz, tile_wz);
      tile_w = T(0);
      tile_wz = T(0);
      tile_end += tile_d;
    }
  };

  const int n_stages = (len + kStage - 1) / kStage;
  if (n_stages > 0) {
    issue_ids(0);
    cp_async_wait_all();
    __syncthreads();
    issue_nodes(0);
    if (n_stages > 1) issue_ids(1);
  }
  for (int s = 0; s < n_stages; ++s) {
    const int base = s * kStage;
    const int n_runs = min(kStage, len - base) / kSumRun;
    cp_async_wait_all();
    __syncthreads();  // stage s and the ids of s + 1 landed; stage s - 1 swept and folded
    if (s + 1 < n_stages) issue_nodes(s + 1);  // lands while this stage is swept
    if (s + 2 < n_stages) issue_ids(s + 2);
    const T* v = sv[s & 1];
    const T* m = sm[s & 1];
    for (int r = part; r < n_runs; r += S) {
      T run_w = T(0), run_wz = T(0);
      node_run(v, m, r * kSumRun, px, py, neg_ah, two_ah, tiny, run_w, run_wz);
      if constexpr (S == 1) {
        fold(run_w, run_wz, base + (r + 1) * kSumRun);
      } else {
        runs[2 * (r * nq + lane)] = run_w;
        runs[2 * (r * nq + lane) + 1] = run_wz;
      }
    }
    if constexpr (S > 1) {
      __syncthreads();  // every part's run sums written
      if (part == 0) {
        for (int r = 0; r < n_runs; ++r)
          fold(runs[2 * (r * nq + lane)], runs[2 * (r * nq + lane) + 1], base + (r + 1) * kSumRun);
      }
    }
  }
  if (part == 0) {
    if (len > tile_end - tile_d) {  // the last tile, cut short at the closed nodes
      sum_w = add_rn(sum_w, tile_w);
      sum_wz = add_rn(sum_wz, tile_wz);
    }
    sw_out[q] = sum_w;
    swz_out[q] = sum_wz;
  }
}

template <typename T, int S>
cudaError_t launch_far_node_s(const void* qx, const void* qy, const void* ah, const void* tbl, const void* nt,
                              const void* nc, const void* fx, const void* fy, const void* fcnt, const void* fzs,
                              const void* fmx, const void* fmy, int n, int block_q, int k_pad, int tile_d,
                              int n_nodes, int threads, double tiny, void* sw, void* swz, cudaStream_t stream) {
  const int nq = threads / S;
  const size_t run_bytes = S > 1 ? static_cast<size_t>(node_stage<T>() / kSumRun) * nq * 2 * sizeof(T) : 0;
  far_node_kernel<T, S><<<n / nq, threads, run_bytes, stream>>>(
      static_cast<const T*>(qx), static_cast<const T*>(qy), static_cast<const T*>(ah), static_cast<const int*>(tbl),
      static_cast<const int*>(nt), static_cast<const int*>(nc), static_cast<const T*>(fx),
      static_cast<const T*>(fy), static_cast<const T*>(fcnt), static_cast<const T*>(fzs),
      static_cast<const T*>(fmx), static_cast<const T*>(fmy), block_q, k_pad, tile_d, n_nodes,
      static_cast<T>(tiny), static_cast<T*>(sw), static_cast<T*>(swz));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_far_node(const void* qx, const void* qy, const void* ah, const void* tbl, const void* nt,
                            const void* nc, const void* fx, const void* fy, const void* fcnt, const void* fzs,
                            const void* fmx, const void* fmy, int n, int block_q, int k_pad, int tile_d,
                            int n_nodes, int threads, int splits, double tiny, void* sw, void* swz,
                            void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || (splits != 1 && splits != 2 && splits != 4) || threads % splits != 0)
    return cudaErrorInvalidValue;
  const int nq = threads / splits;
  if (n % nq != 0 || block_q % nq != 0 || (splits > 1 && nq > kMaxSplitQueries) || tile_d <= 0 ||
      tile_d % kSumRun != 0 || k_pad % tile_d != 0 || n_nodes < 0)
    return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (splits) {
    case 1:
      return launch_far_node_s<T, 1>(qx, qy, ah, tbl, nt, nc, fx, fy, fcnt, fzs, fmx, fmy, n, block_q, k_pad,
                                     tile_d, n_nodes, threads, tiny, sw, swz, s);
    case 2:
      return launch_far_node_s<T, 2>(qx, qy, ah, tbl, nt, nc, fx, fy, fcnt, fzs, fmx, fmy, n, block_q, k_pad,
                                     tile_d, n_nodes, threads, tiny, sw, swz, s);
    default:
      return launch_far_node_s<T, 4>(qx, qy, ah, tbl, nt, nc, fx, fy, fcnt, fzs, fmx, fmy, n, block_q, k_pad,
                                     tile_d, n_nodes, threads, tiny, sw, swz, s);
  }
}

}  // namespace aidw

// sw, swz [q] for q < n.  qx, qy, ah (= alpha / 2): (n,); tbl: (n / block_q,
// k_pad) int32 node ids; nt: (n / block_q,) int32 tile counts; nc: null, or
// (n / block_q,) int32 closed counts (every id of a row past its count is
// the sentinel); fx, fy, fcnt, fzs, fmx, fmy: (n_nodes + 1,), the last the
// sentinel node; splits (S) 1, 2 or 4 threads a query, threads a multiple of
// S, threads / S queries a CUDA block dividing block_q and n (at most 128
// when S > 1); kSumRun divides tile_d, tile_d divides k_pad.
#define AIDW_FAR_NODE_ENTRY(NAME, T)                                                                           \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* ah, const void* tbl, const void* nt, \
                              const void* nc, const void* fx, const void* fy, const void* fcnt,                \
                              const void* fzs, const void* fmx, const void* fmy, int n, int block_q,           \
                              int k_pad, int tile_d, int n_nodes, int threads, int splits, double tiny,        \
                              void* sw, void* swz, void* stream) {                                             \
    return aidw::launch_far_node<T>(qx, qy, ah, tbl, nt, nc, fx, fy, fcnt, fzs, fmx, fmy, n, block_q, k_pad,  \
                                    tile_d, n_nodes, threads, splits, tiny, sw, swz, stream);                  \
  }

AIDW_FAR_NODE_ENTRY(aidw_far_node_f32, float)
AIDW_FAR_NODE_ENTRY(aidw_far_node_f64, double)
