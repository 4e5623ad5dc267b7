// Device-side semantics shared by the AIDW kernels: the counterpart of
// src/repro/kernels/_common.py (sq_dist_tile, merge_k_best,
// alpha_from_best, pow_weight) and of the alpha chain in
// src/repro/core/aidw.py (Eq. 2-6).
//
// Every product and sum whose rounding decides a result is written with the
// _rn intrinsics, so nvcc cannot contract it into an FMA: d^2 then has the
// same bits as the plain PyTorch version's, near-ties pick the same
// neighbours, and the exact-hit test `min d^2 <= eps` flips the same way.
// exp/log/cos/sqrt are the precise library functions (no fast math), with
// one exception: the float32 weight of the exact sweep (pow_weight) is
// 2^(-(alpha/2) log2 d^2) on the special-function units, lg2.approx and
// ex2.approx, one MUFU op each.  Its rounding is dominated by t = (alpha/2)
// ln d^2, whose float32 rounding alone is |t| 2^-24 relative in w (|t|
// reaches 30 and more), so the units' errors (2^-22.6 absolute in log2,
// about 2 ulps in 2^x) stay at that level.  The plain PyTorch versions
// (kernels/_common.py: pow_weight) keep torch.exp/torch.log: the kernels
// are held against them at 64 ulps of z, and the far-field kernels, whose
// checks against their plain versions are bitwise, keep exp_p/log_p.
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

// The special-function units: lg2.approx.ftz.f32 (absolute error 2^-22.6
// in log2 x) and ex2.approx.ftz.f32 (about 2 ulps), one MUFU op each, no
// denormal fix-up.  ex2 of -inf is +0, of t >= 128 +inf; lg2 of +inf is +inf.
__device__ __forceinline__ float lg2_sfu(float x) {
  float y;
  asm("lg2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
__device__ __forceinline__ float ex2_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The weight of Eq. (1), with neg_ah = -alpha / 2: (max(d^2, tiny))^neg_ah.
// float32: 2^(neg_ah * log2 x) on the special-function units (see the
// header); float64: exp(neg_ah * log x) with the precise library
// functions.  The clamp keeps kernels/_common.py's semantics: a NaN d^2
// takes tiny, and a sentinel pad point (d^2 = +inf) gets log = +inf, t =
// -inf and w = +0.  Every exact weight loop (weight_tile, below) takes its
// weights from here, so all exact variants keep one set of bits.
__device__ __forceinline__ float pow_weight(float neg_ah, float d2, float tiny) {
  return ex2_sfu(mul_rn(neg_ah, lg2_sfu(d2 > tiny ? d2 : tiny)));
}
__device__ __forceinline__ double pow_weight(double neg_ah, double d2, double tiny) {
  return exp_p(mul_rn(neg_ah, log_p(d2 > tiny ? d2 : tiny)));
}

// Points a weight loop takes per step (weight_group): their loads, d^2 and
// weights are issued before the sums, so a warp has kWeightGroup
// independent chains through the two MUFU latencies.
constexpr int kWeightGroup = 4;

// U pairs of the weight sweep (Eq. 1) for one query, in point order: the U
// d^2 and weights first, then each point's weight added to the tile's
// sum(w) and sum(w z) left to right, and the first minimum d^2 with its z
// kept with a strict `<`.  The sums and the minimum see the points in the
// same order whatever U is, so the bits do not depend on it.
template <typename T, int U>
__device__ __forceinline__ void weight_group(T px, T py, T neg_ah, const T (&x)[U], const T (&y)[U],
                                             const T (&z)[U], T tiny, T& tile_w, T& tile_wz, T& min_d2,
                                             T& hit_z) {
  T d2[U], w[U];
#pragma unroll
  for (int u = 0; u < U; ++u) d2[u] = sq_dist(px, py, x[u], y[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) w[u] = pow_weight(neg_ah, d2[u], tiny);
#pragma unroll
  for (int u = 0; u < U; ++u) {
    tile_w = add_rn(tile_w, w[u]);
    tile_wz = add_rn(tile_wz, mul_rn(w[u], z[u]));
    if (d2[u] < min_d2) {
      min_d2 = d2[u];
      hit_z = z[u];
    }
  }
}

// One plan tile of the weight sweep for one query: points t0 <= j < t1,
// fetched by point(j, x, y, z), in groups of kWeightGroup and the rest one
// by one, summed into the tile's sum(w) and sum(w z), which are then folded
// into the running totals (the tile boundaries are the plan's block_d).
// The one tile loop of every exact sweep: weight.cu reads staged {x, y, z,
// pad} vectors, fused.cu SoA shared arrays, naive.cu global memory, and all
// keep one set of bits.
template <typename T, typename Point>
__device__ __forceinline__ void weight_tile(T px, T py, T neg_ah, int t0, int t1, Point point, T tiny, T& sum_w,
                                            T& sum_wz, T& min_d2, T& hit_z) {
  T tile_w = T(0), tile_wz = T(0);
  int j = t0;
  const int grp = t1 - (t1 - t0) % kWeightGroup;
  for (; j < grp; j += kWeightGroup) {
    T x[kWeightGroup], y[kWeightGroup], z[kWeightGroup];
#pragma unroll
    for (int u = 0; u < kWeightGroup; ++u) point(j + u, x[u], y[u], z[u]);
    weight_group(px, py, neg_ah, x, y, z, tiny, tile_w, tile_wz, min_d2, hit_z);
  }
  for (; j < t1; ++j) {
    T x[1], y[1], z[1];
    point(j, x[0], y[0], z[0]);
    weight_group(px, py, neg_ah, x, y, z, tiny, tile_w, tile_wz, min_d2, hit_z);
  }
  sum_w = add_rn(sum_w, tile_w);
  sum_wz = add_rn(sum_wz, tile_wz);
}

}  // namespace aidw
