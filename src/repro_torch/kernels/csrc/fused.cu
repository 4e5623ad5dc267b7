// Fused AIDW: both phases in one launch.
//
// Replaces src/repro/kernels/aidw_fused.py:_fused_kernel (launched by
// aidw_fused_soa, the `fused` impl).  The Pallas kernel walks the data tiles
// twice over a (query block, phase, tile) grid and hands alpha / 2 from
// phase 0 to phase 1 in VMEM scratch, so alpha never makes the round trip
// through device memory between the two passes.  Here alpha stays in a
// register between the passes, and the launch writes only z and alpha.
//
// The bits: pass 1 keeps the k smallest d^2 (a multiset: kbest_insert,
// strict `<` against the k-th best, duplicates kept, +inf and NaN never
// entering) and computes alpha with kbest_alpha, so alpha is B1's bits
// (knn.cu on the shared row) in whatever order the points come.  Pass 2
// sums the weights in weight.cu's order: each tile of tile_d points (the
// plan's block_d) from 0, left to right (aidw_common.cuh: weight_tile), the
// tile sums folded into the totals in data order, the first minimum d^2 and
// its z kept with a strict `<`; so z is the bits of weight.cu's z on B1's
// alpha.
//
// What bounds it on an H100, 65,536 queries x m = 2^20 (6.87e10 pairs a
// pass): the operations, 19 a pair over both passes (kNN: d^2 5 and the
// k-th-best compare; weight: d^2 5, the clamp, the exponent's mul, the two
// sums' adds and w z's mul, the minimum's compare, lg2 and ex2), each an
// FP32-pipe slot, 39.03 ms in float32 (78.06 ms in float64); the
// special-function units, 2 MUFU ops a float32 weight pair, 32.87 ms; and
// instruction issue, about 24 SASS a pair over both passes (kNN about 8,
// weight about 16), roughly 49 ms.  The data (12 MiB in float32) sits in
// the 50 MB L2 after the first block.  The first design (one thread a
// query, gcd(block_q, 256) threads; pass 1 one point a step with a compare
// and a branch after every d^2, two 4-byte shared loads a pair, and pass 2
// three scalar shared loads a point, both behind a barrier pair every tile
// staged with synchronous loads; 3 tile_d values of shared memory, capped
// at 48 KiB) ran at 86.55 ms, float64 430.55 ms.
//
// What the design does about it:
//  * pass 1 is knn.cu's walk: x and y staged as 16-byte aligned arrays in
//    stages of kKnnStageBytes, copied with cp.async (stage_values) into the
//    other of two buffers while the current one is swept (one barrier a
//    stage), and swept with knn_span: kKnnGroup points behind one
//    k-th-best test, their loads LDS.128 vectors;
//  * pass 2 is weight.cu's sweep: each point staged once as an {x, y, z,
//    pad} vector (aoas.cuh: stage_point), read with one LDS.128 (staged_xyz),
//    a stage holding several plan tiles (kStageBytes), weight_tile as it is;
//  * S threads of a CUDA block share a query (splits), one part each, as in
//    knn.cu and naive.cu (kernels/aidw_fused.py: fused_launch): thread t
//    takes query t % (blockDim / S) and part t / (blockDim / S), and
//    blockDim / S is a multiple of 32 when S > 1, so a warp works on one part
//    and every shared load is a broadcast.  In pass 1 part p sweeps its
//    slice of each stage, cut as knn.cu cuts it (kernels/aidw_fused.py:
//    fused_part); the parts' k-bests go through shared memory and every
//    part inserts the others', so every part holds the row's k-best and
//    alpha.  In pass 2 part p sums tiles p, p + S, ... of each round of S
//    tiles, each from 0 with the tile's own first minimum; the round's sums
//    and minima go through two alternating shared buffers, and every thread
//    folds them in tile order: the totals of one thread sweeping the row,
//    bit for bit.  S multiplies the warps of a batch that has few;
//  * one region of dynamic shared memory serves both passes, sized as the
//    largest of pass 1's two stages, the k-bests' merge and pass 2's stage
//    with its round buffers; past 48 KiB it is asked for with
//    cudaFuncSetAttribute, up to kMaxSharedBytes, so a plan tile of 4,096
//    float32 or 2,048 float64 points runs.
#include "aidw_common.cuh"
#include "aoas.cuh"

namespace aidw {

// splits (S) threads a query, blockDim.x / S queries a CUDA block; stage_d
// points a pass-2 stage, a whole number of rounds of S tiles of tile_d.
// Shared memory: pass 1 two stages of x and y (2 kKnnStageBytes); with S >
// 1 the parts' k-bests (S K values a query); pass 2 stage_d {x, y, z, pad}
// points and, with S > 1, two round buffers (8 S values a query).
template <typename T, int K>
__global__ void fused_kernel(const T* __restrict__ qx, const T* __restrict__ qy, const T* __restrict__ dx,
                             const T* __restrict__ dy, const T* __restrict__ dz, int n, int m, int tile_d,
                             int stage_d, int splits, AlphaConsts<T> consts, T eps, T tiny,
                             T* __restrict__ z_out, T* __restrict__ alpha_out) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* const smem = reinterpret_cast<T*>(smem_raw);
  const int qc = blockDim.x / splits;  // queries a CUDA block
  const int part = threadIdx.x / qc;
  const int qi = threadIdx.x - part * qc;
  const long long q = static_cast<long long>(blockIdx.x) * qc + qi;
  // a thread past the batch computes on its last query and stores nothing:
  // every thread meets the barriers
  const bool live = q < n;
  const long long qq = live ? q : n - 1;
  const T px = qx[qq];
  const T py = qy[qq];

  // ---- pass 1: knn.cu's walk, this part's slice of every stage
  constexpr int kd = kKnnStageBytes / (2 * static_cast<int>(sizeof(T)));  // points a stage
  T best[K];
#pragma unroll
  for (int j = 0; j < K; ++j) best[j] = T(INFINITY);
  // stage s of points [base, base + cnt) into its buffer
  const auto issue = [&](int s, int base) {
    T* buf = smem + (s & 1) * 2 * kd;
    const int cnt = min(kd, m - base);
    stage_values(buf, dx + base, cnt);
    stage_values(buf + kd, dy + base, cnt);
  };
  issue(0, 0);
  for (int base = 0, s = 0; base < m; base += kd, ++s) {
    const int cnt = min(kd, m - base);
    cp_async_wait_all();
    __syncthreads();  // stage s landed; every thread is done with stage s - 1
    const T* sx = smem + (s & 1) * 2 * kd;
    if (base + kd < m) issue(s + 1, base + kd);  // lands while this stage is swept
    const int per = ((cnt + splits - 1) / splits + kKnnGroup - 1) / kKnnGroup * kKnnGroup;
    const int lo = min(part * per, cnt);
    knn_span<T, K, true, false>(px, py, sx, sx + kd, lo, min(lo + per, cnt), best);
  }
  if (splits > 1) {  // every part inserts the other parts' k-bests
    T* const merge = smem;  // [part][j][qi]
    __syncthreads();        // every part is done with the stages
#pragma unroll
    for (int j = 0; j < K; ++j) merge[(part * K + j) * qc + qi] = best[j];
    __syncthreads();
    for (int p = 0; p < splits; ++p) {
      if (p == part) continue;
#pragma unroll
      for (int j = 0; j < K; ++j) kbest_insert(best, merge[(p * K + j) * qc + qi]);
    }
  }
  const T alpha = kbest_alpha(best, consts);

  // ---- pass 2: the weight sweep at alpha / 2, in weight.cu's sum order
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
  T* const sp = smem;                     // stage_d points of {x, y, z, pad}
  T* const sums = smem + 4LL * stage_d;   // S > 1: two buffers of a round's tile sums and minima
  const auto point = [sp](int j, T& x, T& y, T& z) { staged_xyz(sp, j, x, y, z); };
  for (int base = 0, r = 0; base < m; base += stage_d) {
    const int cnt = min(stage_d, m - base);
    __syncthreads();  // every thread is done with the last stage (the first time: with the k-bests)
    for (int i = threadIdx.x; i < cnt; i += blockDim.x) stage_point(sp, i, dx[base + i], dy[base + i], dz[base + i]);
    __syncthreads();
    for (int t0 = 0; t0 < cnt; t0 += splits * tile_d, ++r) {
      // this part's tile of the round from 0: 0 + its sums gives their bits
      // (a sum that starts at +0 is never -0)
      T tw = T(0), twz = T(0), tmin = T(INFINITY), thz = T(0);
      const int a = t0 + part * tile_d;
      if (a < cnt) weight_tile(px, py, neg_ah, a, min(a + tile_d, cnt), point, tiny, tw, twz, tmin, thz);
      if (splits == 1) {
        fold(tw, twz, tmin, thz);
        continue;
      }
      // the round's S tiles through shared memory, folded in tile order; the
      // buffers alternate, so a round's sums land only after every thread
      // passed the barrier that follows its reads of the round before
      T* const buf = sums + (r & 1) * 4 * splits * qc;
      buf[(4 * part) * qc + qi] = tw;
      buf[(4 * part + 1) * qc + qi] = twz;
      buf[(4 * part + 2) * qc + qi] = tmin;
      buf[(4 * part + 3) * qc + qi] = thz;
      __syncthreads();
      for (int s = 0; s < splits && t0 + s * tile_d < cnt; ++s)
        fold(buf[(4 * s) * qc + qi], buf[(4 * s + 1) * qc + qi], buf[(4 * s + 2) * qc + qi],
             buf[(4 * s + 3) * qc + qi]);
    }
  }
  if (live && part == 0) {
    z_out[q] = (min_d2 <= eps) ? hit_z : sum_wz / sum_w;
    alpha_out[q] = alpha;
  }
}

// Dynamic shared memory of a launch (bytes), and its pass-2 stage in
// points: whole rounds of splits tiles of tile_d, kStageBytes of them or
// one round where a round is larger (tests/test_torch_fused_split.py:
// fused_shared_bytes mirrors it).  Returns 0 where it exceeds
// kMaxSharedBytes.
template <typename T>
size_t shared_bytes(int tile_d, int k, int threads, int splits, int& stage_d) {
  const size_t qc = static_cast<size_t>(threads / splits);
  const size_t round_bytes = static_cast<size_t>(splits) * tile_d * 4 * sizeof(T);
  const size_t rounds = round_bytes >= kStageBytes ? 1 : kStageBytes / round_bytes;
  const size_t knn_bytes = 2 * static_cast<size_t>(kKnnStageBytes);
  const size_t merge_bytes = splits > 1 ? splits * k * qc * sizeof(T) : 0;
  const size_t weight_bytes = rounds * round_bytes + (splits > 1 ? 8 * splits * qc * sizeof(T) : 0);
  size_t smem = knn_bytes > merge_bytes ? knn_bytes : merge_bytes;
  smem = smem > weight_bytes ? smem : weight_bytes;
  if (smem > kMaxSharedBytes) return 0;
  stage_d = static_cast<int>(rounds) * splits * tile_d;
  return smem;
}

template <typename T>
cudaError_t launch(const void* qx, const void* qy, const void* dx, const void* dy, const void* dz,
                   int n, int m, int tile_d, int k, int threads, int splits, AlphaConsts<T> c, double eps,
                   double tiny, void* z, void* alpha, void* stream) {
  if (n <= 0) return cudaSuccess;
  if (threads <= 0 || threads > 1024 || tile_d <= 0 || m <= 0) return cudaErrorInvalidValue;
  if (splits <= 0 || threads % splits != 0 || (splits > 1 && threads / splits % 32 != 0))
    return cudaErrorInvalidValue;
  int stage_d = 0;
  const size_t smem = shared_bytes<T>(tile_d, k, threads, splits, stage_d);
  if (smem == 0) return cudaErrorInvalidValue;
  const int qc = threads / splits;
  const unsigned blocks = static_cast<unsigned>((static_cast<long long>(n) + qc - 1) / qc);
  const T* a = static_cast<const T*>(qx);
  const T* b = static_cast<const T*>(qy);
  const T* x = static_cast<const T*>(dx);
  const T* y = static_cast<const T*>(dy);
  const T* z_in = static_cast<const T*>(dz);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define AIDW_FUSED_CASE(KV)                                                                               \
  case KV: {                                                                                              \
    auto kernel = fused_kernel<T, KV>;                                                                    \
    if (smem > 48 * 1024) {                                                                               \
      const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,   \
                                                   static_cast<int>(smem));                               \
      if (err != cudaSuccess) return err;                                                                 \
    }                                                                                                     \
    kernel<<<blocks, threads, smem, s>>>(a, b, x, y, z_in, n, m, tile_d, stage_d, splits, c,              \
                                         static_cast<T>(eps), static_cast<T>(tiny), static_cast<T*>(z),   \
                                         static_cast<T*>(alpha));                                         \
    return cudaGetLastError();                                                                            \
  }
  switch (k) {
    AIDW_K_LIST(AIDW_FUSED_CASE)
    default:
      break;
  }
#undef AIDW_FUSED_CASE
  return cudaErrorInvalidValue;  // no instance for this k
}

}  // namespace aidw

// z[q], alpha[q] for q < n.  qx, qy: (n,); dx, dy, dz: (m,), summed in
// tiles of tile_d points.  threads a CUDA block, splits of them a query
// (kernels/aidw_fused.py: fused_launch).  The alpha constants come as
// doubles and are rounded to the dtype.
#define AIDW_FUSED_ENTRY(NAME, T)                                                                \
  extern "C" cudaError_t NAME(const void* qx, const void* qy, const void* dx, const void* dy,   \
                              const void* dz, int n, int m, int tile_d, int k, int threads,      \
                              int splits, double r_exp, double pi_over_rmax, double r_min,       \
                              double r_max, double a1, double a2, double a3, double a4,          \
                              double a5, double eps, double tiny, void* z, void* alpha,          \
                              void* stream) {                                                    \
    return aidw::launch<T>(qx, qy, dx, dy, dz, n, m, tile_d, k, threads, splits,                 \
                           aidw::make_alpha_consts<T>(r_exp, pi_over_rmax, r_min, r_max, a1, a2, \
                                                      a3, a4, a5),                               \
                           eps, tiny, z, alpha, stream);                                         \
  }

AIDW_FUSED_ENTRY(aidw_fused_f32, float)
AIDW_FUSED_ENTRY(aidw_fused_f64, double)
