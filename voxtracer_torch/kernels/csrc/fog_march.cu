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
// Out: code 0 miss / 1 planet / 2 scatter, and t; an inactive lane (the
// optional `active` mask) gets code 0 and t 0.
//
// What bounds it on the card: arithmetic. Each segment is an IEEE sqrt,
// an IEEE exp and ~20 flops, up to 64 segments per ray, against 41 bytes
// read and 8 written.
//
// Design: one thread per ray at a time, the whole march in registers, on
// a persistent grid (lanes.cuh): warps scan the lanes, write the outputs
// of inactive lanes themselves and march only active rays, refilling
// threads whose rays have scattered or left the shell; a thread marches up
// to kSteps segments between two looks at its warp. The segment fractions
// a = s / n and 1 - a are the same for every ray: each block computes them
// once into shared memory for s = 0..n_steps (the same float expressions,
// so the same bits), and a segment's near end is carried over as the next
// segment's far end, so no segment divides.

#include <cuda_runtime.h>

#include "lanes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kMaxSteps = 256;  // fog.MAX_STEPS
constexpr int kSteps = 16;  // segments between two looks at idle threads

struct FogRay {
  // launch-wide
  const float* __restrict__ origin;
  const float* __restrict__ dir;
  const float* __restrict__ density;
  const float* __restrict__ y0;
  int* __restrict__ code_out;
  float* __restrict__ t_out;
  const float* frac_a;  // shared: frac_a[s] = (float)s / n_steps
  const float* frac_b;  // shared: frac_b[s] = 1.0f - frac_a[s]
  int n_steps;
  float planet_r, planet_r2, fog_r2, fog_factor;
  // the ray in flight
  int i, s;
  bool surf;
  float px, pyr, pz, dx, dy, dz, t0, t1, density_scaled, y, t_s0;

  __device__ __forceinline__ void skip(int base, unsigned lanes) {
    const int lane = threadIdx.x & 31;
    if ((lanes >> lane) & 1u) {
      code_out[base + lane] = 0;
      t_out[base + lane] = 0.0f;
    }
  }

  __device__ __forceinline__ void finish(int code, float t) {
    code_out[i] = code;
    t_out[i] = t;
  }

  __device__ __forceinline__ bool start(int lane_index) {
    i = lane_index;
    px = __ldg(origin + 3 * i);
    const float py = __ldg(origin + 3 * i + 1);
    pz = __ldg(origin + 3 * i + 2);
    dx = __ldg(dir + 3 * i);
    dy = __ldg(dir + 3 * i + 1);
    dz = __ldg(dir + 3 * i + 2);

    pyr = py + planet_r;
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

    if (!valid || n_steps == 0) {
      finish(surf ? 1 : 0, surf ? t1 : 0.0f);
      return false;
    }
    const float nf = (float)n_steps;
    density_scaled = (t1 - t0) / nf * __ldg(density + i);
    y = __ldg(y0 + i);
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
      finish(2, frac * t_s0 + (1.0f - frac) * t_s1);
      return false;
    }
    y = y - d_seg;
    t_s0 = t_s1;
    if (++s < n_steps) return true;
    finish(surf ? 1 : 0, surf ? t1 : 0.0f);
    return false;
  }
};

__global__ void __launch_bounds__(kThreads)
    fog_march_kernel(voxt::LaneArgs lanes, const float* __restrict__ start,
                     const float* __restrict__ dir,
                     const float* __restrict__ density,
                     const float* __restrict__ y0, int* __restrict__ code_out,
                     float* __restrict__ t_out, int n_steps, float planet_r,
                     float planet_r2, float fog_r2, float fog_factor) {
  __shared__ float frac_a[kMaxSteps + 1];
  __shared__ float frac_b[kMaxSteps + 1];
  __shared__ int queue[kThreads / 32 * voxt::kQueue];
  const float nf = (float)n_steps;
  for (int s = threadIdx.x; s <= n_steps; s += blockDim.x) {
    const float a = (float)s / nf;
    frac_a[s] = a;
    frac_b[s] = 1.0f - a;
  }
  __syncthreads();

  FogRay ray;
  ray.origin = start;
  ray.dir = dir;
  ray.density = density;
  ray.y0 = y0;
  ray.code_out = code_out;
  ray.t_out = t_out;
  ray.frac_a = frac_a;
  ray.frac_b = frac_b;
  ray.n_steps = n_steps;
  ray.planet_r = planet_r;
  ray.planet_r2 = planet_r2;
  ray.fog_r2 = fog_r2;
  ray.fog_factor = fog_factor;
  voxt::run_lanes<kSteps>(
      lanes, queue + (threadIdx.x >> 5) * voxt::kQueue, ray);
}

}  // namespace

extern "C" int voxt_fog_march(const void* start, const void* dir,
                              const void* density, const void* y0,
                              const void* active, void* code, void* t, int n,
                              int n_steps, float planet_r, float planet_r2,
                              float fog_r2, float fog_factor, void* counter,
                              int static_pct, int chunk, int refill,
                              void* stream) {
  if (n <= 0) return 0;
  if (!voxt::valid_fetch(static_pct, chunk, refill))
    return (int)cudaErrorInvalidValue;
  if (n_steps < 0 || n_steps > kMaxSteps) return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err =
      voxt::persistent_blocks(fog_march_kernel, kThreads, 0, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  const voxt::LaneArgs lanes{
      (int*)counter, (const bool*)active, n,
      voxt::lanes_per_warp(n, blocks, kThreads, static_pct), chunk, refill};
  fog_march_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      lanes, (const float*)start, (const float*)dir, (const float*)density,
      (const float*)y0, (int*)code, (float*)t, n_steps, planet_r, planet_r2,
      fog_r2, fog_factor);
  return (int)cudaGetLastError();
}
