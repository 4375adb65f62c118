// The atmosphere march of one ray: the body of K1 (fog_march.cu), which K9
// (path_trace.cu) runs twice a bounce in its march stages. fog_march.cu's
// note says what it computes and why it is written so; this header holds
// the one copy of its arithmetic, and the test that settles a march
// without marching it when it provably does not scatter.

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

// One ray's march. setup() intersects the shell and the planet and returns
// false once the result is known by the shell alone; scatter_free() is the
// test below, and settle() then gives the result without a march; step()
// marches one segment, far to near, and returns false once the result is
// known. The result is (code, t): code 0 miss / 1 planet / 2 scatter. A
// segment's near end is carried over as the next segment's far end, so
// no segment divides.
//
// The scatter-free test (scatter_free()). The march scatters at segment s
// iff y_s < d_s, where y_0 = y0, y_{s+1} = fl(y_s - d_s) and d_s =
// fl(density_scaled * expf(fl(-alt_s * fog_factor))) for the float32
// altitude alt_s at the segment's near end t_{s+1}. If it scatters at no
// segment, its result is (surf ? 1 : 0, surf ? t1 : 0), which setup()
// already holds. Claim: if density_scaled >= 0 and y0 (1 - 2^-15) > D for
// an upper bound D >= sum_s d_s, no segment scatters. Proof: let u = 2^-24.
// While none has scattered, y_s >= d_s >= 0, so the exact y_s - d_s lies
// in [0, y_s] and its rounding loses at most u y_s <= u y0 (y never grows:
// rounding is monotone); by induction y_s >= y0 - sum_{j<s} d_j - s u y0,
// so y_s - d_s >= y0 (1 - n u) - D > 0 for n <= 256 (n u = 2^-16). NaN
// anywhere fails the comparisons, so such a lane marches.
//
// D, in double from the walker's own float32 values: let P = (px, pyr,
// pz), d = (dx, dy, dz) and t_k = t1 - k (t1 - t0) / n, k = 1..n, the
// segment ends. (1) Float error of alt: the march's float32 s = P + t d,
// its norm and the difference with planet_r each round; with its t off
// the exact t_k by a few ulps, alt_s >= |P + t_k d| - planet_r - M for M
// = 2^-19 (|P| + t1 |d| + planet_r), nearly three times the sum of
// those roundings (under 11.5 u (|P| + t1 |d| + planet_r): 6 u t1 |d|
// for t, 2 u per term of s, 2.5 u |s| for the norm, u (|s| + planet_r)
// for the difference). (2) Two lower bounds
// on |P + t d| over [t0, t1]: its least value, at the clamped closest
// point (the flat bound, n terms of one size), and, since the norm is
// convex, the tangent at t = 0, |P| + t mu with mu = d.P / |P|, which
// makes the n terms a geometric series with the closed form below.
// D takes the smaller sum. (3) Rounding of exp's argument (relative u, so
// a factor exp(u |arg|) with |arg| <= fog_factor max |alt|), expf's
// error (2 ulps on the card, less on the host), the product's and
// double's own: the factor (1 + 2^-20) and exp(2^-23 max |arg|). (4) If
// an argument could near expf's overflow (above 64) the lane marches: an
// infinite d_s would scatter whatever its density.
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

  __device__ __forceinline__ bool setup(float ox, float oy, float oz,
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

    if (!valid || n_steps == 0) return settle();
    const float nf = (float)n_steps;
    density_scaled = (t1 - t0) / nf * density;
    y = y0;
    s = 0;
    t_s0 = frac_a[0] * t0 + frac_b[0] * t1;
    return true;
  }

  // After a setup() that returned true: the bound D of the proof above
  // (NaN or infinite where none holds).
  __device__ __forceinline__ double scatter_bound() const {
    const double none = nan("");
    if (!(density_scaled >= 0.0f)) return none;
    const double Px = px, Py = pyr, Pz = pz, Dx = dx, Dy = dy, Dz = dz;
    const double T0 = t0, T1 = t1, R = planet_r, ff = fog_factor;
    const double n = (double)n_steps;
    const double pn = sqrt(Px * Px + Py * Py + Pz * Pz);
    const double dd = Dx * Dx + Dy * Dy + Dz * Dz;
    const double M = 0x1p-19 * (pn + T1 * sqrt(dd) + R);
    const double pd = Px * Dx + Py * Dy + Pz * Dz;
    // the flat bound: the least altitude over [t0, t1]
    const double tc = fmin(fmax(dd > 0.0 ? -pd / dd : 0.0, T0), T1);
    const double cx = Px + Dx * tc, cy = Py + Dy * tc, cz = Pz + Dz * tc;
    const double a_min = sqrt(cx * cx + cy * cy + cz * cz) - R - M;
    const double a_max = pn + T1 * sqrt(dd) - R + M;
    const double arg_max = ff * fmax(fabs(a_min), fabs(a_max));
    if (!(-ff * a_min <= 64.0)) return none;
    double G = n * exp(-ff * a_min);
    // the tangent bound: sum_{k=1..n} exp(-ff (A + mu t_k)), A = |P| - R
    // - M, t_k = T1 - k delta: exp(lead) sum_k exp(x k) with lead =
    // -ff (A + mu T1) and x = ff mu delta
    if (pn > 0.0) {
      const double mu = pd / pn;
      const double x = ff * mu * ((T1 - T0) / n);
      const double lead = -ff * (pn - R - M + mu * T1);
      const double geo = x == 0.0 ? n * exp(lead)
                                  : exp(lead + x) * (expm1(n * x) / expm1(x));
      if (geo < G) G = geo;
    }
    return (double)density_scaled * G * (1.0 + 0x1p-20) *
           exp(0x1p-23 * arg_max);
  }

  // After a setup() that returned true: whether the march provably
  // scatters at no segment.
  __device__ __forceinline__ bool scatter_free() const {
    return (double)y * (1.0 - 0x1p-15) > scatter_bound();
  }

  // The result of a march that scatters at no segment: false.
  __device__ __forceinline__ bool settle() {
    return done(surf ? 1 : 0, surf ? t1 : 0.0f);
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
    return settle();
  }
};

}  // namespace voxt
