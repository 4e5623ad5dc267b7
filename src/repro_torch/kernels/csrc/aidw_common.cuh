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
// one exception: the float32 weight of every exact, near and far sweep
// (pow_weight) is 2^(-(alpha/2) log2 d^2) on the special-function units,
// lg2.approx and ex2.approx, one MUFU op each.  Its rounding is dominated by
// t = (alpha/2) ln d^2, whose float32 rounding alone is |t| 2^-24 relative
// in w (|t| reaches 30 and more), so the units' errors (2^-22.6 absolute in
// log2, about 2 ulps in 2^x) stay at that level.  The plain PyTorch
// versions (kernels/_common.py: pow_weight) keep torch.exp/torch.log: the
// exact sweeps are held against them at 64 ulps of z, the near and far-cell
// sums (near.cu, far.cu) within a per-query budget derived from the terms
// (kernels/_common.py: sfu_sum_tolerance), and so are the quadtree node
// sums (far_node.cu, whose dipole also takes rcp.approx for its division).
// Float64 keeps the precise functions everywhere.
#pragma once

#include <cuda_runtime.h>
#include <float.h>
#include <math.h>

#include "aoas.cuh"

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

// A block's dynamic shared memory on sm_90 (weight.cu and knn.cu stage data
// past 48 KiB after cudaFuncSetAttribute).
constexpr size_t kMaxSharedBytes = 227 * 1024;

// Asynchronous copies from global to shared memory (sm_80 and later): 16
// bytes, or one value, a copy; cp_async_wait_all waits for the calling
// thread's copies, and a barrier after it makes every thread's visible.
__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_elem(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_elem(double* dst, const double* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_elem(int* dst, const int* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::: "memory"); }

// The padding coordinate of core/layouts.py: coord_sentinel, finfo.max / 4:
// its d^2 from any finite query overflows to +inf.
template <typename T>
__device__ __forceinline__ T coord_sentinel();
template <>
__device__ __forceinline__ float coord_sentinel<float>() { return FLT_MAX / 4; }
template <>
__device__ __forceinline__ double coord_sentinel<double>() { return DBL_MAX / 4; }

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

// The smaller of a and b, ignoring a NaN (fminf, one FMNMX; fmin in
// float64, a compare and selects): the minimum of a set is NaN only when
// every value is.
__device__ __forceinline__ float min_num(float a, float b) { return fminf(a, b); }
__device__ __forceinline__ double min_num(double a, double b) { return fmin(a, b); }

// Points a kNN loop takes per step (knn_group): their G d^2 are independent
// chains, and one test against the k-th best serves all G.
constexpr int kKnnGroup = 8;

// The minimum of G values by a pairwise tree (G a power of two), NaN only
// when every value is.
template <typename T, int G>
__device__ __forceinline__ T group_min(const T (&v)[G]) {
  T lo[G];
#pragma unroll
  for (int u = 0; u < G; ++u) lo[u] = v[u];
#pragma unroll
  for (int w = G / 2; w > 0; w /= 2) {
#pragma unroll
    for (int u = 0; u < w; ++u) lo[u] = min_num(lo[u], lo[u + w]);
  }
  return lo[0];
}

// Whether one of G values lies below t (NaN never does): the FMNMX tree's
// minimum against t in float32; G compares in float64, which has no min
// instruction (fmin takes a compare, two selects and a NaN fix-up).
template <int G>
__device__ __forceinline__ bool any_below(const float (&v)[G], float t) {
  return group_min(v) < t;
}
template <int G>
__device__ __forceinline__ bool any_below(const double (&v)[G], double t) {
  bool hit = false;
#pragma unroll
  for (int u = 0; u < G; ++u) hit |= v[u] < t;
  return hit;
}

// G pairs of the k-best walk for one query: the G d^2 and, with INSERT and
// only when one of them lies below the k-th best, each folded into the
// k-best in point order.  When none does, none could enter, so the skip
// changes nothing; past the first few tiles the warp skips together.
// With MIN it returns the group's minimum (group_min; the binned
// prefilter's bin minimum and the threshold-skip vote's tile minimum fold
// it in), else +inf.
template <typename T, int K, int G, bool INSERT, bool MIN>
__device__ __forceinline__ T knn_group(T px, T py, const T (&x)[G], const T (&y)[G], T (&best)[K]) {
  T d2[G];
#pragma unroll
  for (int u = 0; u < G; ++u) d2[u] = sq_dist(px, py, x[u], y[u]);
  const T gmin = MIN ? group_min(d2) : T(INFINITY);
  if constexpr (INSERT) {
    if (MIN ? gmin < best[K - 1] : any_below(d2, best[K - 1])) {
#pragma unroll
      for (int u = 0; u < G; ++u) kbest_insert(best, d2[u]);
    }
  }
  return gmin;
}

// G consecutive values from 16-byte aligned shared memory: G / 4 float4 or
// G / 2 double2 loads.
template <int G>
__device__ __forceinline__ void load_group(const float* s, float (&v)[G]) {
#pragma unroll
  for (int i = 0; i < G / 4; ++i) {
    const float4 p = reinterpret_cast<const float4*>(s)[i];
    v[4 * i] = p.x;
    v[4 * i + 1] = p.y;
    v[4 * i + 2] = p.z;
    v[4 * i + 3] = p.w;
  }
}
template <int G>
__device__ __forceinline__ void load_group(const double* s, double (&v)[G]) {
#pragma unroll
  for (int i = 0; i < G / 2; ++i) {
    const double2 p = reinterpret_cast<const double2*>(s)[i];
    v[2 * i] = p.x;
    v[2 * i + 1] = p.y;
  }
}

// Points a <= j < b of the staged x and y arrays sx, sy (16-byte aligned)
// for one query: with INSERT each folded into the k-best, kKnnGroup at a
// time from the first multiple of kKnnGroup (so each group is two or four
// vector loads, two groups a loop step), the edges one by one.  With MIN
// returns their minimum d^2 (+inf for none).  The k-best set (the K
// smallest values, duplicates kept) and the minimum do not depend on the
// order of the points, so neither does anything computed from them.
template <typename T, int K, bool INSERT, bool MIN>
__device__ __forceinline__ T knn_span(T px, T py, const T* sx, const T* sy, int a, int b, T (&best)[K]) {
  constexpr int G = kKnnGroup;
  T run = T(INFINITY);
  int j = a;
  const int head = min(b, (a + G - 1) / G * G);
  for (; j < head; ++j) {
    const T x[1] = {sx[j]}, y[1] = {sy[j]};
    const T v = knn_group<T, K, 1, INSERT, MIN>(px, py, x, y, best);
    if constexpr (MIN) run = min_num(run, v);
  }
#pragma unroll 2
  for (; j + G <= b; j += G) {
    T x[G], y[G];
    load_group(sx + j, x);
    load_group(sy + j, y);
    const T gmin = knn_group<T, K, G, INSERT, MIN>(px, py, x, y, best);
    if constexpr (MIN) run = min_num(run, gmin);
  }
  for (; j < b; ++j) {
    const T x[1] = {sx[j]}, y[1] = {sy[j]};
    const T v = knn_group<T, K, 1, INSERT, MIN>(px, py, x, y, best);
    if constexpr (MIN) run = min_num(run, v);
  }
  return run;
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
// rcp.approx.ftz.f32: 1/x within 1 ulp, one MUFU op; a result below
// float32's normal range (x > 2^126) is flushed to 0, 1/+inf is +0.
__device__ __forceinline__ float rcp_sfu(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The weight of Eq. (1), with neg_ah = -alpha / 2: (max(d^2, tiny))^neg_ah.
// float32: 2^(neg_ah * log2 x) on the special-function units (see the
// header); float64: exp(neg_ah * log x) with the precise library
// functions.  The clamp keeps kernels/_common.py's semantics: a NaN d^2
// takes tiny, and a sentinel pad point (d^2 = +inf) gets log = +inf, t =
// -inf and w = +0; in float32 it is fmaxf, one FMNMX, which gives the same
// value as the compare and select of float64 for every d^2, NaN included.
// Every exact, near and far weight loop (weight_tile, run_group, below;
// far_node.cu: node_run) takes its weights from here, so all exact variants
// keep one set of bits.
__device__ __forceinline__ float pow_weight(float neg_ah, float d2, float tiny) {
  return ex2_sfu(mul_rn(neg_ah, lg2_sfu(fmaxf(d2, tiny))));
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


// The run-summed sweeps of near.cu (NEAR) and far.cu read staged vectors
// {x, y, p, r}: near points {x, y, z, pad}, far cells {cent_x, cent_y,
// count, z_sum}.  A pair's terms are (w, w p) in a near sweep and (w p,
// w r) in a far-cell sweep, with w = pow_weight(neg_ah, d^2, tiny); a near
// sweep also keeps the first minimum d^2 and its p with a strict `<`.

// kWeightGroup pairs of such a sweep, j..j + U - 1: the U loads, d^2 and
// weights first, then each pair's terms added to the run sums in point
// order, so the bits do not depend on U.  NEAR tests the group's minimum
// d^2 (group_min, which skips a NaN) against the running minimum once and
// updates it point by point only when the test passes: no point of a group
// that fails it is below the minimum, so the first minimum and its p are
// those of the one-by-one rule.
template <typename T, int U, bool NEAR>
__device__ __forceinline__ void run_group(const T* s, int j, T px, T py, T neg_ah, T tiny, T& run_a, T& run_b,
                                          T& min_d2, T& hit_z) {
  T x[U], y[U], p[U], r[U], d2[U], w[U];
#pragma unroll
  for (int u = 0; u < U; ++u) staged_vec(s, j + u, x[u], y[u], p[u], r[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) d2[u] = sq_dist(px, py, x[u], y[u]);
#pragma unroll
  for (int u = 0; u < U; ++u) w[u] = pow_weight(neg_ah, d2[u], tiny);
  if constexpr (NEAR) {
    if (group_min(d2) < min_d2) {
#pragma unroll
      for (int u = 0; u < U; ++u) {
        if (d2[u] < min_d2) {
          min_d2 = d2[u];
          hit_z = p[u];
        }
      }
    }
  }
#pragma unroll
  for (int u = 0; u < U; ++u) {
    run_a = add_rn(run_a, NEAR ? w[u] : mul_rn(w[u], p[u]));
    run_b = add_rn(run_b, mul_rn(w[u], NEAR ? p[u] : r[u]));
  }
}

// Staged vectors a <= j < b (a run boundary, b - a a multiple of kSumRun)
// summed into a tile's sums in runs of kSumRun (each run from 0, left to
// right, then added to the tile sum): kernels/_common.py: run_sum's order.
template <typename T, bool NEAR>
__device__ __forceinline__ void run_span(const T* s, int a, int b, T px, T py, T neg_ah, T tiny, T& tile_a,
                                         T& tile_b, T& min_d2, T& hit_z) {
  for (int j0 = a; j0 < b; j0 += kSumRun) {
    T run_a = T(0), run_b = T(0);
#pragma unroll
    for (int g = 0; g < kSumRun / kWeightGroup; ++g)
      run_group<T, kWeightGroup, NEAR>(s, j0 + g * kWeightGroup, px, py, neg_ah, tiny, run_a, run_b, min_d2, hit_z);
    tile_a = add_rn(tile_a, run_a);
    tile_b = add_rn(tile_b, run_b);
  }
}

// One stage of such a sweep: the cnt staged vectors of points base..base +
// cnt - 1 of the row (base and cnt multiples of kSumRun), the tile sums
// carried across stages and folded into the totals at every multiple of
// tile_d (the plan tile, a multiple of kSumRun), then restarted from 0.
template <typename T, bool NEAR>
__device__ __forceinline__ void run_stage(const T* s, int base, int cnt, int tile_d, T px, T py, T neg_ah, T tiny,
                                          T& tile_a, T& tile_b, T& sum_a, T& sum_b, T& min_d2, T& hit_z) {
  for (int t = 0; t < cnt;) {
    const int tile_end = ((base + t) / tile_d + 1) * tile_d - base;
    const int end = min(cnt, tile_end);
    run_span<T, NEAR>(s, t, end, px, py, neg_ah, tiny, tile_a, tile_b, min_d2, hit_z);
    t = end;
    if (end == tile_end) {
      sum_a = add_rn(sum_a, tile_a);
      sum_b = add_rn(sum_b, tile_b);
      tile_a = T(0);
      tile_b = T(0);
    }
  }
}

}  // namespace aidw
