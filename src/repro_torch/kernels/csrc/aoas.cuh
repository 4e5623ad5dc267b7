// Loads of one point of the AoaS layout (src/repro/core/layouts.py:
// soa_to_aoas): an (m, 4) array of (x, y, z, 0) structs, 16 bytes a point
// in float32 and 32 in float64.  A float32 point is one 16-byte float4
// load; a float64 point is two 16-byte double2 loads (double4's alignment
// variants depend on the toolkit version, so it is avoided).  The wrappers
// refuse a tensor whose base is not aligned to the struct size.
#pragma once

#include <cuda_runtime.h>

namespace aidw {

__device__ __forceinline__ void load_xy(const float* __restrict__ d, long long i, float& x, float& y) {
  const float4 p = reinterpret_cast<const float4*>(d)[i];
  x = p.x;
  y = p.y;
}

__device__ __forceinline__ void load_xy(const double* __restrict__ d, long long i, double& x, double& y) {
  const double2 p = reinterpret_cast<const double2*>(d)[2 * i];
  x = p.x;
  y = p.y;
}

__device__ __forceinline__ void load_xyz(const float* __restrict__ d, long long i, float& x, float& y,
                                         float& z) {
  const float4 p = reinterpret_cast<const float4*>(d)[i];
  x = p.x;
  y = p.y;
  z = p.z;
}

__device__ __forceinline__ void load_xyz(const double* __restrict__ d, long long i, double& x, double& y,
                                         double& z) {
  const double2* s = reinterpret_cast<const double2*>(d) + 2 * i;
  const double2 a = s[0];
  const double2 b = s[1];
  x = a.x;
  y = a.y;
  z = b.x;
}

// A point staged in shared memory in the same {x, y, z, pad} layout: one
// 16-byte vector access in float32, two in float64.  stage_point writes one
// from SoA values; stage_struct copies one AoaS struct as it is.
__device__ __forceinline__ void stage_point(float* s, int i, float x, float y, float z) {
  reinterpret_cast<float4*>(s)[i] = make_float4(x, y, z, 0.0f);
}

__device__ __forceinline__ void stage_point(double* s, int i, double x, double y, double z) {
  double2* p = reinterpret_cast<double2*>(s) + 2 * i;
  p[0] = make_double2(x, y);
  p[1] = make_double2(z, 0.0);
}

__device__ __forceinline__ void stage_struct(float* s, int i, const float* __restrict__ d, long long j) {
  reinterpret_cast<float4*>(s)[i] = reinterpret_cast<const float4*>(d)[j];
}

__device__ __forceinline__ void stage_struct(double* s, int i, const double* __restrict__ d, long long j) {
  const double2* src = reinterpret_cast<const double2*>(d) + 2 * j;
  double2* p = reinterpret_cast<double2*>(s) + 2 * i;
  p[0] = src[0];
  p[1] = src[1];
}

// Four values staged as one vector (the near and far-cell sweeps: {x, y,
// z, pad} or {cent_x, cent_y, count, z_sum}): one 16-byte access in
// float32, two in float64.
__device__ __forceinline__ void stage_vec(float* s, int i, float a, float b, float c, float d) {
  reinterpret_cast<float4*>(s)[i] = make_float4(a, b, c, d);
}

__device__ __forceinline__ void stage_vec(double* s, int i, double a, double b, double c, double d) {
  double2* p = reinterpret_cast<double2*>(s) + 2 * i;
  p[0] = make_double2(a, b);
  p[1] = make_double2(c, d);
}

__device__ __forceinline__ void staged_vec(const float* s, int i, float& a, float& b, float& c, float& d) {
  const float4 p = reinterpret_cast<const float4*>(s)[i];
  a = p.x;
  b = p.y;
  c = p.z;
  d = p.w;
}

__device__ __forceinline__ void staged_vec(const double* s, int i, double& a, double& b, double& c, double& d) {
  const double2* p = reinterpret_cast<const double2*>(s) + 2 * i;
  const double2 u = p[0];
  const double2 v = p[1];
  a = u.x;
  b = u.y;
  c = v.x;
  d = v.y;
}

// A staged pair {a, b}: one 8-byte (float2) or 16-byte (double2) load.
__device__ __forceinline__ void staged_pair(const float* s, int i, float& a, float& b) {
  const float2 p = reinterpret_cast<const float2*>(s)[i];
  a = p.x;
  b = p.y;
}

__device__ __forceinline__ void staged_pair(const double* s, int i, double& a, double& b) {
  const double2 p = reinterpret_cast<const double2*>(s)[i];
  a = p.x;
  b = p.y;
}

__device__ __forceinline__ void staged_xyz(const float* s, int i, float& x, float& y, float& z) {
  const float4 p = reinterpret_cast<const float4*>(s)[i];
  x = p.x;
  y = p.y;
  z = p.z;
}

__device__ __forceinline__ void staged_xyz(const double* s, int i, double& x, double& y, double& z) {
  const double2* p = reinterpret_cast<const double2*>(s) + 2 * i;
  const double2 a = p[0];
  const double2 b = p[1];
  x = a.x;
  y = a.y;
  z = b.x;
}

}  // namespace aidw
