// K2: ray casts through the sparse voxel octree's node table.
//
// Replaces: voxtracer/kernels/traverse.py, svo_raycast / _svo_cast_body
// (a jnp while_loop on the TPU, no Pallas kernel). Same algorithm and the
// same float operations as svo_raycast_plain in
// voxtracer_torch/kernels/traverse.py, so the five outputs agree bit for
// bit; built with --fmad=false so no product is fused into a sum.
//
// Algorithm (raytrace.wgsl:68-180): mirror the ray so every direction
// component is positive; keep the subvoxel bits of every level in three
// packed bit-words (bit m of word a = the level-(m+1) cell's half along
// axis a, so the cell offset at level h is word & ~((1<<h)-1)); a node
// stack of height+1 ints; pop by height; skip hits at t == 0 when asked;
// the distance cap is advisory (the pop test is an equality against the
// capped cell end, as in the reference).
//
// What bounds it on the card: dependent gathers and divergence. Every
// descend step reads one 32-byte node row whose address depends on the
// previous read, a ray takes tens to hundreds of steps, and rays of one
// warp take very different step counts. The table is small against the
// 50 MB L2 (187,832 rows = 6 MB at 1024^3).
//
// Design: one thread per ray at a time (the walker in svo_walk.cuh, which
// K9 shares), on a persistent grid (lanes.cuh): warps scan the lanes,
// write the outputs of inactive lanes themselves, and hand only active
// rays to threads, refilling threads whose rays are done; a thread takes up to kSteps steps between two
// looks at its warp. Per-level geometry is recomputed from the three
// bit-words (~20 flops) instead of being stacked, so the only per-level
// state is the node stack, which lives in shared memory laid out
// [level][thread]: the slot of level l of thread x is at
// l * blockDim.x + x, so a warp touches 32 consecutive banks whatever
// levels its threads are at, and nothing goes to local memory (ptxas: 0
// bytes of stack frame). Node rows are read through the read-only path.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"
#include "svo_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kSteps = 8;  // steps between two looks at the warp's idle threads

// the walk's inputs of lane i from device memory, its outputs written back
struct SvoIo {
  const float* __restrict__ origin_in;
  const float* __restrict__ dir_in;
  const float* __restrict__ distance_in;
  bool* __restrict__ hit_out;
  float* __restrict__ t_out;
  int* __restrict__ node_out;
  float* __restrict__ normal_out;
  int* __restrict__ voxel_out;
  int i;

  __device__ __forceinline__ float origin(int a) const {
    return __ldg(origin_in + 3 * i + a);
  }
  __device__ __forceinline__ float dir(int a) const {
    return __ldg(dir_in + 3 * i + a);
  }
  __device__ __forceinline__ float distance() const {
    return __ldg(distance_in + i);
  }
  __device__ __forceinline__ void finish(bool hit, float t, int node,
                                         const float* normal,
                                         const int* vox) {
    hit_out[i] = hit;
    t_out[i] = t;
    node_out[i] = node;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      normal_out[3 * i + a] = normal[a];
      voxel_out[3 * i + a] = vox[a];
    }
  }
};

// the lane-fetch face of the walk (lanes.cuh)
struct SvoRay {
  voxt::SvoWalk<SvoIo> w;

  __device__ __forceinline__ void skip(int base, unsigned lanes) {
    const int lane = threadIdx.x & 31;
    if ((lanes >> lane) & 1u) {
      w.io.hit_out[base + lane] = false;
      w.io.t_out[base + lane] = 0.0f;
      w.io.node_out[base + lane] = -1;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int e = lane + 32 * r;  // element of the 32 lanes' (32, 3) rows
      if ((lanes >> (e / 3)) & 1u) {
        w.io.normal_out[3 * base + e] = 0.0f;
        w.io.voxel_out[3 * base + e] = 0;
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
    svo_cast_kernel(voxt::LaneArgs lanes, const int* __restrict__ table,
                    int root, int H, const float* __restrict__ start,
                    const float* __restrict__ dir,
                    const float* __restrict__ distance, int skip_t0,
                    bool* __restrict__ hit_out, float* __restrict__ t_out,
                    int* __restrict__ node_out,
                    float* __restrict__ normal_out,
                    int* __restrict__ voxel_out) {
  extern __shared__ int smem[];
  const int warps = blockDim.x >> 5;
  SvoRay ray;
  ray.w.table = table;
  ray.w.stk = smem + warps * voxt::kQueue + threadIdx.x;
  ray.w.stride = blockDim.x;
  ray.w.root = root;
  ray.w.H = H;
  ray.w.skip_t0 = skip_t0;
  ray.w.io.origin_in = start;
  ray.w.io.dir_in = dir;
  ray.w.io.distance_in = distance;
  ray.w.io.hit_out = hit_out;
  ray.w.io.t_out = t_out;
  ray.w.io.node_out = node_out;
  ray.w.io.normal_out = normal_out;
  ray.w.io.voxel_out = voxel_out;
  voxt::run_lanes<kSteps>(
      lanes, smem + (threadIdx.x >> 5) * voxt::kQueue, ray);
}

}  // namespace

extern "C" int voxt_svo_cast(const void* table, int root, int height,
                             const void* start, const void* dir,
                             const void* distance, const void* active,
                             int skip_t0, void* hit, void* t, void* node,
                             void* normal, void* voxel, int n, void* counter,
                             int static_pct, int chunk, int refill,
                             void* stream) {
  if (n <= 0) return 0;
  if (!voxt::valid_fetch(static_pct, chunk, refill))
    return (int)cudaErrorInvalidValue;
  const size_t smem =
      (size_t)(kThreads / 32 * voxt::kQueue + (height + 1) * kThreads) *
      sizeof(int);
  int blocks = 0;
  cudaError_t err =
      voxt::persistent_blocks(svo_cast_kernel, kThreads, smem, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  const voxt::LaneArgs lanes{
      (int*)counter, (const bool*)active, n,
      voxt::lanes_per_warp(n, blocks, kThreads, static_pct), chunk, refill};
  svo_cast_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      lanes, (const int*)table, root, height, (const float*)start,
      (const float*)dir, (const float*)distance, skip_t0, (bool*)hit,
      (float*)t, (int*)node, (float*)normal, (int*)voxel);
  return (int)cudaGetLastError();
}
