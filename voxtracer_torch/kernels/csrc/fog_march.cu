// K1: the atmosphere march (planet surface + exponential fog free path).
//
// Replaces: voxtracer/kernels/pallas/fog.py, _fog_kernel (the Pallas TPU
// kernel behind fog_march). Same arithmetic, expression for expression,
// as the plain version fog_march_plain in voxtracer_torch/kernels/fog.py;
// built with --fmad=false so that every product and sum rounds on its own
// as it does there.
//
// Per ray: intersect the fog shell and the planet sphere, clip the far end
// t1 at the planet, then march n_steps segments from far to near, spending
// the free path y0 against (t1-t0)/n * density * exp(-alt * FOG_FACTOR).
// Out: code 0 miss / 1 planet / 2 scatter, and t.
//
// What bounds it on the card: arithmetic. Each segment is a sqrt, an exp
// and ~20 flops, 64 segments per ray, against 40 bytes read and 8 written.
// Design: one thread per ray, the whole march in registers, so device
// memory sees each input once and each output once; a ray stops marching
// at its scatter event (nothing after it changes the result), and rays
// that miss the shell skip the march. Ragged batches are masked by the
// thread index: no padding to tiles.

#include <cuda_runtime.h>

namespace {

__global__ void fog_march_kernel(const float* __restrict__ start,
                                 const float* __restrict__ dir,
                                 const float* __restrict__ density,
                                 const float* __restrict__ y0,
                                 int* __restrict__ code_out,
                                 float* __restrict__ t_out,
                                 int n, int n_steps, float planet_r,
                                 float planet_r2, float fog_r2,
                                 float fog_factor) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float px = start[3 * i], py = start[3 * i + 1], pz = start[3 * i + 2];
  const float dx = dir[3 * i], dy = dir[3 * i + 1], dz = dir[3 * i + 2];

  const float pyr = py + planet_r;
  const float pp = px * px + pyr * pyr + pz * pz;
  const float b = 2.0f * (px * dx + pyr * dy + pz * dz);
  const float c = pp - fog_r2;
  const float det = b * b - 4.0f * c;
  const float sq = sqrtf(fmaxf(det, 0.0f));
  const float t0 = fmaxf((-b - sq) / 2.0f, 0.0f);
  float t1 = (-b + sq) / 2.0f;
  const bool valid = (det >= 0.0f) && (t1 >= 0.0f);

  const float c_pl = pp - planet_r2;
  const float det_pl = b * b - 4.0f * c_pl;
  const float sq_pl = sqrtf(fmaxf(det_pl, 0.0f));
  const float t0_pl = (-b - sq_pl) / 2.0f;
  const bool surf = valid && (det_pl >= 0.0f) && (t0_pl > 0.0f);
  if (surf) t1 = t0_pl;

  bool found = false;
  float t_sc = 0.0f;
  if (valid) {
    const float nf = (float)n_steps;
    const float density_scaled = (t1 - t0) / nf * density[i];
    float y = y0[i];
    for (int s = 0; s < n_steps && !found; ++s) {
      const float a1 = (float)(s + 1) / nf;
      const float a0 = (float)s / nf;
      const float t_s0 = a0 * t0 + (1.0f - a0) * t1;
      const float t_s1 = a1 * t0 + (1.0f - a1) * t1;
      const float sx = px + dx * t_s1;
      const float sy = pyr + dy * t_s1;
      const float sz = pz + dz * t_s1;
      const float alt = sqrtf(sx * sx + sy * sy + sz * sz) - planet_r;
      const float d_seg = density_scaled * expf(-alt * fog_factor);
      if (y < d_seg) {
        const float frac = d_seg > 0.0f ? y / fmaxf(d_seg, 1e-30f) : 0.0f;
        t_sc = frac * t_s0 + (1.0f - frac) * t_s1;
        found = true;
      } else {
        y = y - d_seg;
      }
    }
  }
  code_out[i] = found ? 2 : (surf ? 1 : 0);
  t_out[i] = found ? t_sc : (surf ? t1 : 0.0f);
}

}  // namespace

extern "C" int voxt_fog_march(const void* start, const void* dir,
                              const void* density, const void* y0,
                              void* code, void* t, int n, int n_steps,
                              float planet_r, float planet_r2, float fog_r2,
                              float fog_factor, void* stream) {
  if (n <= 0) return 0;
  const int threads = 256;
  const int blocks = (n + threads - 1) / threads;
  fog_march_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)start, (const float*)dir, (const float*)density,
      (const float*)y0, (int*)code, (float*)t, n, n_steps, planet_r,
      planet_r2, fog_r2, fog_factor);
  return (int)cudaGetLastError();
}
