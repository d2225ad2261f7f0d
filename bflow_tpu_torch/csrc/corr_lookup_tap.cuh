// One bilinear tap of a query's correlation map, shared by the lookup
// kernels: corr_lookup_q8.cu (int8 volumes) reads the tap from device
// memory; corr_lookup_fwd.cu and corr_lookup_bwd.cu (f32 and bf16) blend
// the corners of a patch staged in shared memory with the same blend().
//
// grid_sample(align_corners=True) semantics with zero padding, in map
// pixels: a corner outside the (hl, wl) map contributes zero. Validity is
// decided in float before any float->int conversion, so far-away
// coordinates (random-init flows reach hundreds of pixels) never convert
// an out-of-range value. The blend runs in f32 in the plain version's
// operation order (x-blend per row, then y), each operation rounded on its
// own: no fused multiply-add, so the kernels and their plain versions
// agree bit for bit.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace corr_tap {

__device__ __forceinline__ float load_f32(const float* p) { return __ldg(p); }
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ float load_f32(const int8_t* p) {
  return (float)__ldg(reinterpret_cast<const signed char*>(p));
}

// the four corners (row y0: v00, v01; row y0+1: v10, v11) blended at the
// fractions (fx, fy)
__device__ __forceinline__ float blend(float v00, float v01, float v10,
                                       float v11, float fx, float fy) {
  const float gx = __fsub_rn(1.f, fx), gy = __fsub_rn(1.f, fy);
  const float top = __fadd_rn(__fmul_rn(v00, gx), __fmul_rn(v01, fx));
  const float bot = __fadd_rn(__fmul_rn(v10, gx), __fmul_rn(v11, fx));
  return __fadd_rn(__fmul_rn(top, gy), __fmul_rn(bot, fy));
}

// the map m (hl, wl) sampled at (x, y)
template <typename T>
__device__ __forceinline__ float bilinear(const T* __restrict__ m, int hl,
                                         int wl, float x, float y) {
  const float x0 = floorf(x);
  const float y0 = floorf(y);
  const float fx = x - x0;
  const float fy = y - y0;

  // corner validity in float: x0 and x0+1 against [0, wl-1]
  const float wmax = (float)(wl - 1), hmax = (float)(hl - 1);
  const bool vx0 = x0 >= 0.f && x0 <= wmax;
  const bool vx1 = x0 >= -1.f && x0 <= wmax - 1.f;
  const bool vy0 = y0 >= 0.f && y0 <= hmax;
  const bool vy1 = y0 >= -1.f && y0 <= hmax - 1.f;

  float v00 = 0.f, v01 = 0.f, v10 = 0.f, v11 = 0.f;
  if ((vx0 || vx1) && (vy0 || vy1)) {
    // both values lie in [-1, w-1] here, so the conversion is exact
    const int ix = (int)x0;
    const int iy = (int)y0;
    if (vy0) {
      const T* row = m + (int64_t)iy * wl;
      if (vx0) v00 = load_f32(row + ix);
      if (vx1) v01 = load_f32(row + ix + 1);
    }
    if (vy1) {
      const T* row = m + (int64_t)(iy + 1) * wl;
      if (vx0) v10 = load_f32(row + ix);
      if (vx1) v11 = load_f32(row + ix + 1);
    }
  }
  return blend(v00, v01, v10, v11, fx, fy);
}

}  // namespace corr_tap
