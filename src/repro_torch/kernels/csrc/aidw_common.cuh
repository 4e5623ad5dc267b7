// Device-side semantics shared by the AIDW kernels: the counterpart of
// src/repro/kernels/_common.py (sq_dist_tile, merge_k_best,
// alpha_from_best, pow_weight) and of the alpha chain in
// src/repro/core/aidw.py (Eq. 2-6).
//
// Every product and sum whose rounding decides a result is written with the
// _rn intrinsics, so nvcc cannot contract it into an FMA: d^2 then has the
// same bits as the plain PyTorch version's, near-ties pick the same
// neighbours, and the exact-hit test `min d^2 <= eps` flips the same way.
// exp/log/cos/sqrt are the precise library functions (no fast math).
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace aidw {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }
__device__ __forceinline__ float sub_rn(float a, float b) { return __fsub_rn(a, b); }
__device__ __forceinline__ double sub_rn(double a, double b) { return __dsub_rn(a, b); }

__device__ __forceinline__ float exp_p(float x) { return expf(x); }
__device__ __forceinline__ double exp_p(double x) { return exp(x); }
__device__ __forceinline__ float log_p(float x) { return logf(x); }
__device__ __forceinline__ double log_p(double x) { return log(x); }
__device__ __forceinline__ float cos_p(float x) { return cosf(x); }
__device__ __forceinline__ double cos_p(double x) { return cos(x); }
__device__ __forceinline__ float sqrt_p(float x) { return sqrtf(x); }
__device__ __forceinline__ double sqrt_p(double x) { return sqrt(x); }

// The near-field and far-cell kernels sum a tile in runs of kSumRun terms,
// each run left to right from 0, then the run sums left to right: the order
// of kernels/_common.py: run_sum (SUM_RUN), so kernel and plain version give
// the same sum wherever they give the same terms.
constexpr int kSumRun = 32;

// The k values of the K-templated kernels (knn.cu, naive.cu, fused.cu): each
// `switch (k)` takes its cases from this one list, and kernels/aidw_tiled.py
// reads it as SUPPORTED_K.  A k outside it raises in the wrappers.
#define AIDW_K_LIST(X) X(1) X(2) X(3) X(4) X(5) X(6) X(7) X(8) X(9) X(10) X(11) X(12) X(13) X(14) X(15) X(16)

// d^2 = dx*dx + dy*dy, rounded after every operation.  A pad point at the
// sentinel coordinate (finfo.max / 4) overflows to +inf.
template <typename T>
__device__ __forceinline__ T sq_dist(T qx, T qy, T px, T py) {
  const T ddx = sub_rn(qx, px);
  const T ddy = sub_rn(qy, py);
  return add_rn(mul_rn(ddx, ddx), mul_rn(ddy, ddy));
}

// Constants of the alpha chain, each already rounded to T on the host the
// way the JAX package rounds it: r_exp and pi/r_max are Python floats cast
// to the dtype.
template <typename T>
struct AlphaConsts {
  T r_exp, pi_over_rmax, r_min, r_max;
  T a[5];
};

template <typename T>
AlphaConsts<T> make_alpha_consts(double r_exp, double pi_over_rmax, double r_min, double r_max,
                                 double a1, double a2, double a3, double a4, double a5) {
  AlphaConsts<T> c;
  c.r_exp = static_cast<T>(r_exp);
  c.pi_over_rmax = static_cast<T>(pi_over_rmax);
  c.r_min = static_cast<T>(r_min);
  c.r_max = static_cast<T>(r_max);
  c.a[0] = static_cast<T>(a1);
  c.a[1] = static_cast<T>(a2);
  c.a[2] = static_cast<T>(a3);
  c.a[3] = static_cast<T>(a4);
  c.a[4] = static_cast<T>(a5);
  return c;
}

// One segment of alpha_from_mu's clamped-lerp chain: each spans 0.2 in mu.
template <typename T>
__device__ __forceinline__ T lerp_segment(T alpha, T mu, T lo, T next) {
  T t = mul_rn(sub_rn(mu, lo), T(5));
  t = t < T(0) ? T(0) : (t > T(1) ? T(1) : t);
  return add_rn(mul_rn(alpha, sub_rn(T(1), t)), mul_rn(next, t));
}

// Eq. (2)-(6): r_obs -> R(S0) = r_obs / r_exp -> mu (Eq. 5) -> alpha.
template <typename T>
__device__ __forceinline__ T alpha_from_r_obs(T r_obs, const AlphaConsts<T>& c) {
  const T r_stat = r_obs / c.r_exp;
  T mu = sub_rn(T(0.5), mul_rn(T(0.5), cos_p(mul_rn(c.pi_over_rmax, sub_rn(r_stat, c.r_min)))));
  if (r_stat <= c.r_min) mu = T(0);
  if (r_stat >= c.r_max) mu = T(1);
  T alpha = lerp_segment(c.a[0], mu, T(0.1), c.a[1]);
  alpha = lerp_segment(alpha, mu, T(0.3), c.a[2]);
  alpha = lerp_segment(alpha, mu, T(0.5), c.a[3]);
  return lerp_segment(alpha, mu, T(0.7), c.a[4]);
}

// Folds v into the ascending k-best array: a branch-free insertion behind
// one strict `<` against the k-th best, so duplicates are kept, as
// merge_k_best keeps them.  Returns whether v entered.
template <typename T, int K>
__device__ __forceinline__ bool kbest_insert(T (&best)[K], T v) {
  if (!(v < best[K - 1])) return false;
#pragma unroll
  for (int s = 0; s < K; ++s) {
    const T b = best[s];
    const bool take = v < b;
    best[s] = take ? v : b;
    v = take ? b : v;
  }
  return true;
}

// alpha of a k-best set: r_obs = mean of sqrt(best), summed in ascending
// order, times 1/K in the dtype (how the reference's mean rounds), then
// Eq. (2)-(6).
template <typename T, int K>
__device__ __forceinline__ T kbest_alpha(const T (&best)[K], const AlphaConsts<T>& c) {
  T sum = sqrt_p(best[0]);
#pragma unroll
  for (int j = 1; j < K; ++j) sum = add_rn(sum, sqrt_p(best[j]));
  return alpha_from_r_obs(mul_rn(sum, T(1.0 / K)), c);
}

// One staged tile of the weight sweep (Eq. 1) for one query, with
// neg_ah = -alpha / 2: w = exp(neg_ah * log(max(d^2, tiny))), the tile's
// sum(w) and sum(w z) taken left to right and folded into the running totals
// (weight.cu's order: the tile boundaries are the plan's block_d), and the
// first minimum d^2 with its z, kept with a strict `<` across tiles.
template <typename T>
__device__ __forceinline__ void weight_tile_sums(T px, T py, T neg_ah, const T* sx, const T* sy, const T* sz,
                                            int cnt, T tiny, T& sum_w, T& sum_wz, T& min_d2, T& hit_z) {
  T tile_w = T(0), tile_wz = T(0);
  for (int j = 0; j < cnt; ++j) {
    const T d2 = sq_dist(px, py, sx[j], sy[j]);
    const T zj = sz[j];
    const T w = exp_p(mul_rn(neg_ah, log_p(d2 > tiny ? d2 : tiny)));
    tile_w = add_rn(tile_w, w);
    tile_wz = add_rn(tile_wz, mul_rn(w, zj));
    if (d2 < min_d2) {
      min_d2 = d2;
      hit_z = zj;
    }
  }
  sum_w = add_rn(sum_w, tile_w);
  sum_wz = add_rn(sum_wz, tile_wz);
}

}  // namespace aidw
