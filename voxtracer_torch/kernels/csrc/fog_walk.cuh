// The atmosphere march of one ray: the body of K1 (fog_march.cu), which K9
// (path_trace.cu) runs twice a bounce as a device function. fog_march.cu's
// note says what it computes and why it is written so; this header holds
// the one copy of its arithmetic.

#pragma once

#include <cuda_runtime.h>

namespace voxt {

constexpr int kFogMaxSteps = 256;  // fog.MAX_STEPS

// The segment fractions a = s / n and 1 - a for s = 0..n_steps, the same
// for every ray: each block computes them once into shared memory (the
// same float expressions, so the same bits). The caller synchronizes the
// block before the first march.
__device__ __forceinline__ void fog_fractions(float* frac_a, float* frac_b,
                                              int n_steps) {
  const float nf = (float)n_steps;
  for (int s = threadIdx.x; s <= n_steps; s += blockDim.x) {
    const float a = (float)s / nf;
    frac_a[s] = a;
    frac_b[s] = 1.0f - a;
  }
}

// One ray's march. begin() intersects the shell and the planet and returns
// false once the result is known; step() marches one segment, far to near,
// and returns false once it is. The result is (code, t): code 0 miss /
// 1 planet / 2 scatter. A segment's near end is carried over as the next
// segment's far end, so no segment divides.
struct FogWalk {
  // launch-wide
  const float* frac_a;  // shared: frac_a[s] = (float)s / n_steps
  const float* frac_b;  // shared: frac_b[s] = 1.0f - frac_a[s]
  int n_steps;
  float planet_r, planet_r2, fog_r2, fog_factor;
  // the ray in flight
  int s;
  bool surf;
  float px, pyr, pz, dx, dy, dz, t0, t1, density_scaled, y, t_s0;
  // the result
  int code;
  float t;

  __device__ __forceinline__ bool done(int c, float tt) {
    code = c;
    t = tt;
    return false;
  }

  __device__ __forceinline__ bool begin(float ox, float oy, float oz,
                                        float dir_x, float dir_y, float dir_z,
                                        float density, float y0) {
    px = ox;
    pz = oz;
    dx = dir_x;
    dy = dir_y;
    dz = dir_z;
    pyr = oy + planet_r;
    const float pp = px * px + pyr * pyr + pz * pz;
    const float b = 2.0f * (px * dx + pyr * dy + pz * dz);
    const float c = pp - fog_r2;
    const float det = b * b - 4.0f * c;
    const float sq = sqrtf(fmaxf(det, 0.0f));
    t0 = fmaxf((-b - sq) / 2.0f, 0.0f);
    t1 = (-b + sq) / 2.0f;
    const bool valid = (det >= 0.0f) && (t1 >= 0.0f);

    const float c_pl = pp - planet_r2;
    const float det_pl = b * b - 4.0f * c_pl;
    const float sq_pl = sqrtf(fmaxf(det_pl, 0.0f));
    const float t0_pl = (-b - sq_pl) / 2.0f;
    surf = valid && (det_pl >= 0.0f) && (t0_pl > 0.0f);
    if (surf) t1 = t0_pl;

    if (!valid || n_steps == 0) return done(surf ? 1 : 0, surf ? t1 : 0.0f);
    const float nf = (float)n_steps;
    density_scaled = (t1 - t0) / nf * density;
    y = y0;
    s = 0;
    t_s0 = frac_a[0] * t0 + frac_b[0] * t1;
    return true;
  }

  __device__ __forceinline__ bool step() {
    const float t_s1 = frac_a[s + 1] * t0 + frac_b[s + 1] * t1;
    const float sx = px + dx * t_s1;
    const float sy = pyr + dy * t_s1;
    const float sz = pz + dz * t_s1;
    const float alt = sqrtf(sx * sx + sy * sy + sz * sz) - planet_r;
    const float d_seg = density_scaled * expf(-alt * fog_factor);
    if (y < d_seg) {
      const float frac = d_seg > 0.0f ? y / fmaxf(d_seg, 1e-30f) : 0.0f;
      return done(2, frac * t_s0 + (1.0f - frac) * t_s1);
    }
    y = y - d_seg;
    t_s0 = t_s1;
    if (++s < n_steps) return true;
    return done(surf ? 1 : 0, surf ? t1 : 0.0f);
  }
};

}  // namespace voxt
