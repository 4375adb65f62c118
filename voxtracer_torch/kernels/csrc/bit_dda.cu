// K8: the hierarchical bit-grid DDA, ray casts through the packed
// occupancy pyramid of world/bitgrid.py.
//
// Replaces: voxtracer/kernels/bitdda.py, bitgrid_raycast (a jnp
// while_loop on the TPU, no Pallas kernel). Same results, bit for bit, as
// bitgrid_raycast_plain in voxtracer_torch/kernels/bitdda.py; built with
// --fmad=false (the cell of a crossing point, floor(o + dm * t), must
// round the product and the sum apart).
//
// What it computes, per ray, in the mirrored space where every direction
// component is positive: from the world-box entry, at each cell of the
// current level (region 128^3, brick 8^3, voxel) test its occupancy bit;
// descend into an occupied region or brick; at an occupied voxel record
// the hit (skipping t == 0 when asked); otherwise step to the next cell of
// the level through its nearest exit plane (x before y before z on a tie)
// and ascend to the coarsest boundary crossed.
//
// What bounds it on the card: dependent word loads (one a step, from the
// 64 B top bitmap, a 512 B region row or a 64 B brick row) and divergence
// between rays of a warp. At 1024^3 the bricks take 128 MiB, beyond the
// 50 MB L2.
//
// Repair: the cells of the axes not stepped are floor(o + dm * m) but
// never below the current cell; the reference lets a rounding step a ray
// back, and a ray through an edge of two equal crossing t's then cycles
// between two cells forever (bitdda.py's module doc).
//
// Design: the walk is a resumable walker (bit_walk.cuh, begin/step, its
// state in registers), which K9 runs too for its bit-grid engine. Here it
// runs on a persistent grid (lanes.cuh, as K2 and K4): warps scan the
// lanes, write the outputs of inactive lanes themselves, and hand only
// active rays to threads, refilling the threads whose rays are done, so a
// warp's short rays do not idle behind its longest. The first form (one
// thread a ray) held every warp to its longest ray. The reference
// carries the region and brick rows it descended into and picks a word by
// a tree of selects (TPU mechanism); here the word is loaded from the
// region or brick the ray is in, which is that row (a ray leaves a brick
// or region only by ascending to its level). The launch-wide pointers
// stay in the kernel's parameters (__grid_constant__), not in registers.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_walk.cuh"
#include "lanes.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 8;  // steps between two looks at the warp's idle threads

struct DdaArgs {
  voxt::BitGrid grid;
  const float* start;
  const float* dir;
  const float* distance;
  bool* hit_out;
  float* t_out;
  float* normal_out;
  int* voxel_out;
};

// the walk's inputs of lane i from device memory, its outputs written back
struct DdaIo {
  const DdaArgs& a;  // the kernel's parameters, no registers
  int i;

  __device__ __forceinline__ float origin(int k) const {
    return __ldg(a.start + 3 * i + k);
  }
  __device__ __forceinline__ float dir(int k) const {
    return __ldg(a.dir + 3 * i + k);
  }
  __device__ __forceinline__ float distance() const {
    return __ldg(a.distance + i);
  }
  __device__ __forceinline__ void finish(bool hit, float t,
                                         const float* normal, const int* vox) {
    a.hit_out[i] = hit;
    a.t_out[i] = t;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.normal_out[3 * i + k] = normal[k];
      a.voxel_out[3 * i + k] = vox[k];
    }
  }
};

// the lane-fetch face of the walk (lanes.cuh)
struct DdaRay {
  voxt::BitWalk<DdaIo> w;

  __device__ __forceinline__ void skip(int base, unsigned lanes) {
    const DdaArgs& a = w.io.a;
    const int lane = threadIdx.x & 31;
    if ((lanes >> lane) & 1u) {
      a.hit_out[base + lane] = false;
      a.t_out[base + lane] = 0.0f;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int e = lane + 32 * r;  // element of the 32 lanes' (32, 3) rows
      if ((lanes >> (e / 3)) & 1u) {
        a.normal_out[3 * base + e] = 0.0f;
        a.voxel_out[3 * base + e] = 0;
      }
    }
  }

  __device__ __forceinline__ bool start(int lane_index) {
    w.io.i = lane_index;
    return w.begin();
  }

  __device__ __forceinline__ bool step() { return w.step(); }
};

__global__ void __launch_bounds__(kThreads)
    bit_dda_kernel(voxt::LaneArgs lanes, __grid_constant__ const DdaArgs a) {
  __shared__ int ring[kThreads / 32 * voxt::kQueue];
  DdaRay ray{voxt::BitWalk<DdaIo>{a.grid, DdaIo{a, 0}}};
  voxt::run_lanes<kSteps>(lanes, ring + (threadIdx.x >> 5) * voxt::kQueue,
                          ray);
}

}  // namespace

extern "C" int voxt_bit_dda(const void* top, int top_words,
                            const void* regions, const void* bricks, int size,
                            const void* start, const void* dir,
                            const void* distance, const void* active,
                            int skip_t0, void* hit, void* t, void* normal,
                            void* voxel, int n, void* counter, int static_pct,
                            int chunk, int refill, void* stream) {
  if (n <= 0) return 0;
  if (size < 128 || (size & (size - 1)) != 0 ||
      !voxt::valid_fetch(static_pct, chunk, refill))
    return (int)cudaErrorInvalidValue;
  int blocks = 0;
  cudaError_t err =
      voxt::persistent_blocks(bit_dda_kernel, kThreads, 0, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  const voxt::LaneArgs lanes{
      (int*)counter, (const bool*)active, n,
      voxt::lanes_per_warp(n, blocks, kThreads, static_pct), chunk, refill};
  const DdaArgs a{{(const unsigned*)top, (const unsigned*)regions,
                   (const unsigned*)bricks, top_words, size, skip_t0},
                  (const float*)start, (const float*)dir,
                  (const float*)distance, (bool*)hit, (float*)t,
                  (float*)normal, (int*)voxel};
  bit_dda_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(lanes, a);
  return (int)cudaGetLastError();
}
