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
// Design: one thread per ray at a time, the whole march in registers
// (the walker in fog_walk.cuh, which K9 shares), on a persistent grid
// (lanes.cuh): warps scan the lanes, write the outputs of inactive lanes
// themselves and march only active rays, refilling threads whose rays
// have scattered or left the shell; a thread marches up to kSteps
// segments between two looks at its warp. The segment fractions
// a = s / n and 1 - a are the same for every ray: each block computes them
// once into shared memory for s = 0..n_steps (the same float expressions,
// so the same bits), and a segment's near end is carried over as the next
// segment's far end, so no segment divides. Before it marches, a ray
// takes fog_walk.cuh's scatter-free test (a bound on the sum of its
// segment densities, in double, against its free path): a march the test
// proves never scatters returns the march's own result at once, so no
// output bit changes.
// With a `work` pointer, the kernel counts the marches the test settled
// and the segments marched (a warp's sums, one atomic each), for the
// bound of the launch's own work.

#include <cuda_runtime.h>

#include "fog_walk.cuh"
#include "lanes.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kSteps = 16;  // segments between two looks at idle threads

// the lane-fetch face of the march (lanes.cuh): inputs of lane i from
// device memory, its outputs written back
struct FogRay {
  const float* __restrict__ origin;
  const float* __restrict__ dir;
  const float* __restrict__ density;
  const float* __restrict__ y0;
  int* __restrict__ code_out;
  float* __restrict__ t_out;
  voxt::FogWalk w;
  int i;
  unsigned settled, segs;  // this thread's counts

  __device__ __forceinline__ void skip(int base, unsigned lanes) {
    const int lane = threadIdx.x & 31;
    if ((lanes >> lane) & 1u) {
      code_out[base + lane] = 0;
      t_out[base + lane] = 0.0f;
    }
  }

  __device__ __forceinline__ bool finish() {
    code_out[i] = w.code;
    t_out[i] = w.t;
    return false;
  }

  __device__ __forceinline__ bool start(int lane_index) {
    i = lane_index;
    if (!w.setup(__ldg(origin + 3 * i), __ldg(origin + 3 * i + 1),
                 __ldg(origin + 3 * i + 2), __ldg(dir + 3 * i),
                 __ldg(dir + 3 * i + 1), __ldg(dir + 3 * i + 2),
                 __ldg(density + i), __ldg(y0 + i)))
      return finish();
    if (!w.scatter_free()) return true;
    ++settled;
    w.settle();
    return finish();
  }

  __device__ __forceinline__ bool step() {
    ++segs;
    return w.step() || finish();
  }
};

__global__ void __launch_bounds__(kThreads)
    fog_march_kernel(voxt::LaneArgs lanes, const float* __restrict__ start,
                     const float* __restrict__ dir,
                     const float* __restrict__ density,
                     const float* __restrict__ y0, int* __restrict__ code_out,
                     float* __restrict__ t_out, int n_steps, float planet_r,
                     float planet_r2, float fog_r2, float fog_factor,
                     unsigned long long* __restrict__ work) {
  __shared__ float frac_a[voxt::kFogMaxSteps + 1];
  __shared__ float frac_b[voxt::kFogMaxSteps + 1];
  __shared__ int queue[kThreads / 32 * voxt::kQueue];
  voxt::fog_fractions(frac_a, frac_b, n_steps);
  __syncthreads();

  FogRay ray;
  ray.origin = start;
  ray.dir = dir;
  ray.density = density;
  ray.y0 = y0;
  ray.code_out = code_out;
  ray.t_out = t_out;
  ray.w.frac_a = frac_a;
  ray.w.frac_b = frac_b;
  ray.w.n_steps = n_steps;
  ray.w.planet_r = planet_r;
  ray.w.planet_r2 = planet_r2;
  ray.w.fog_r2 = fog_r2;
  ray.w.fog_factor = fog_factor;
  ray.settled = ray.segs = 0u;
  voxt::run_lanes<kSteps>(
      lanes, queue + (threadIdx.x >> 5) * voxt::kQueue, ray);
  if (work == nullptr) return;
  unsigned v[2] = {ray.settled, ray.segs};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      v[k] += __shfl_xor_sync(voxt::kFullMask, v[k], o);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < 2; ++k)
      if (v[k] != 0u) atomicAdd(work + k, (unsigned long long)v[k]);
}

}  // namespace

extern "C" int voxt_fog_march(const void* start, const void* dir,
                              const void* density, const void* y0,
                              const void* active, void* code, void* t, int n,
                              int n_steps, float planet_r, float planet_r2,
                              float fog_r2, float fog_factor, void* counter,
                              int static_pct, int chunk, int refill,
                              void* work, void* stream) {
  if (n <= 0) return 0;
  if (!voxt::valid_fetch(static_pct, chunk, refill))
    return (int)cudaErrorInvalidValue;
  if (n_steps < 0 || n_steps > voxt::kFogMaxSteps) return (int)cudaErrorInvalidValue;
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
      fog_r2, fog_factor, (unsigned long long*)work);
  return (int)cudaGetLastError();
}
