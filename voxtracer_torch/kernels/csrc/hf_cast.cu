// K4: ray casts against the terrain heightfield, a walk over the 2-D
// max-mip quadtree of the columns.
//
// Replaces: voxtracer/kernels/heightfield.py, hf_raycast (_hf_init,
// _hf_body, _hf_finalize: jnp while_loops on the TPU, no Pallas kernel).
// Same algorithm and the same float operations as hf_raycast_plain in
// voxtracer_torch/kernels/heightfield.py, so the four outputs agree bit
// for bit; built with --fmad=false so no product is fused into a sum.
//
// Algorithm: mirror the ray so every direction component is positive
// (s0 = flip ? bound - start : start, inv = 1 / max(|d|, EPS)); cap an
// ascending ray where it clears the terrain's maximum; resolve a start
// inside solid in closed form; descend from the root by strict midplane
// picks; then walk cells (level L, mirrored column cx, cz): read the
// cell's maximum height, test whether the ray is below it inside the
// cell ("dip"); at column level a dip into [0, h) is the hit; above it a
// dip descends tile_log levels, no dip advances to the x or z neighbour
// (x first on ties), and leaving the tile coarsens tile_log levels. Every
// crossing t is (integer plane * 2^L - s0) * inv, the same float at every
// level, and hits come only from the column test, so the schedule of
// cells cannot change an output bit.
//
// What bounds it on the card: the instructions a warp issues per step
// and how many of its lanes a step keeps busy, not the bytes: a step
// reads 4 bytes and does ~40 float operations (two exits 8, dip 6,
// column test 10, descend 10 a level, advance 6). Steps a ray takes vary
// widely (on the smoke's 1024^3 sets 17-29 a walking lane on average, at
// most 208-277), and of the steps of its camera rays 72% advance inside
// the tile, 17% descend and 8% coarsen. So a warp's lanes leave many of
// its step slots idle, and sparse casts end on a few long rays (PERF.md).
// What the design does:
// - One path a step. Every lane computes the three successors (the child
//   a dip descends to, the neighbour in the tile, the parent cell past
//   the tile's edge) and selects one, so a warp whose lanes descend,
//   advance and coarsen runs one path instead of three in turn, and the
//   child's midplane picks overlap the height's load. Only a hit or a
//   miss branches.
// - A cheaper step. tile_log is a template parameter (1, 2, 3), so no
//   step divides; 2^L comes from exponent bits; a level's constants
//   (grid size, row start and shift, cell size) and the cell's two exit
//   planes are computed once a step with no division or 64-bit index
//   (the wrapper checks the pack's size); the launch-wide pointers stay
//   in the kernel's parameters (__grid_constant__), not in registers.
// - One thread per ray at a time (the walker in hf_walk.cuh, which K9
//   shares) on the persistent grid of lanes.cuh (inactive lanes written
//   coalesced by the warp, active lanes queued and handed to idle
//   threads), 8 blocks of 128 an SM. All ray state is
//   in registers: no stack, since the quadtree walk recomputes a cell
//   from (L, cx, cz). The terrain maximum is read from device memory (no
//   host read per cast).
// Tried and not kept (PERF.md): the coarsest rows in shared memory (as
// fast as L1), a neighbour's height loaded a step ahead, the height read
// as soon as the cell is entered, 10-12 blocks an SM (the register cap
// spills), other kSteps and lane-fetch settings.

#include <cuda_runtime.h>
#include <stdint.h>

#include "hf_walk.cuh"
#include "lanes.cuh"

namespace {

constexpr int kSteps = 8;  // steps between two looks at the warp's idle threads
constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;  // blocks an SM holds: at most 64 registers

struct HfArgs {
  voxt::HfPack pack;
  const float* origin;
  const float* dir;
  const float* distance;
  const float* t_min;
  bool* hit_out;
  float* t_out;
  float* normal_out;
  int* voxel_out;
};

// the walk's inputs of lane i from device memory, its outputs written back
struct HfIo {
  const HfArgs& a;  // the kernel's parameters, no registers
  int i;

  __device__ __forceinline__ float origin(int k) const {
    return __ldg(a.origin + 3 * i + k);
  }
  __device__ __forceinline__ float dir(int k) const {
    return __ldg(a.dir + 3 * i + k);
  }
  __device__ __forceinline__ float distance() const {
    return __ldg(a.distance + i);
  }
  __device__ __forceinline__ float t_min(float t0) const {
    return a.t_min != nullptr ? fmaxf(t0, __ldg(a.t_min + i)) : t0;
  }
  __device__ __forceinline__ void finish(bool hit, float t,
                                         const float* normal, int vx, int vy,
                                         int vz) {
    a.hit_out[i] = hit;
    a.t_out[i] = t;
    const int vox[3] = {vx, vy, vz};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.normal_out[3 * i + k] = normal[k];
      a.voxel_out[3 * i + k] = vox[k];
    }
  }
};

// the lane-fetch face of the walk (lanes.cuh)
template <int TL>
struct HfRay {
  voxt::HfWalk<TL, HfIo> w;

  __device__ __forceinline__ void skip(int base, unsigned lanes) {
    const HfArgs& a = w.io.a;
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

template <int TL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    hf_cast_kernel(voxt::LaneArgs lanes, __grid_constant__ const HfArgs a) {
  extern __shared__ int smem[];
  __shared__ int s_rows[voxt::kHfMaxLevels];
  if ((int)threadIdx.x < a.pack.levels)
    s_rows[threadIdx.x] = __ldg(a.pack.row_start + threadIdx.x);
  __syncthreads();
  HfRay<TL> ray{{a.pack, s_rows, HfIo{a, 0}}};
  voxt::run_lanes<kSteps>(lanes, smem + (threadIdx.x >> 5) * voxt::kQueue,
                          ray);
}

template <int TL>
int launch(const HfArgs& a, int n, void* counter, const void* active,
           int static_pct, int chunk, int refill, cudaStream_t stream) {
  auto kernel = hf_cast_kernel<TL>;
  const size_t smem = (size_t)(kThreads / 32 * voxt::kQueue) * sizeof(int);
  int blocks = 0;
  cudaError_t err =
      voxt::persistent_blocks(kernel, kThreads, smem, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  const voxt::LaneArgs lanes{
      (int*)counter, (const bool*)active, n,
      voxt::lanes_per_warp(n, blocks, kThreads, static_pct), chunk, refill};
  kernel<<<blocks, kThreads, smem, stream>>>(lanes, a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int voxt_hf_cast(const void* tiles, int tile_log, int levels,
                            const void* row_starts, int height,
                            const void* hmax_w, const void* start,
                            const void* dir, const void* distance,
                            const void* active, const void* t_min, int skip_t0,
                            int init_desc, void* hit, void* t, void* normal,
                            void* voxel, int n, void* counter, int static_pct,
                            int chunk, int refill, void* stream) {
  if (n <= 0) return 0;
  if (!voxt::valid_fetch(static_pct, chunk, refill) || levels < 1 ||
      levels > voxt::kHfMaxLevels || tile_log < 1 || tile_log > 3 ||
      height < 1 || height > 30 || init_desc < 0)
    return (int)cudaErrorInvalidValue;
  HfArgs a;
  a.pack.tiles = (const float*)tiles;
  a.pack.row_start = (const int*)row_starts;
  a.pack.hmax_w = (const float*)hmax_w;
  a.pack.levels = levels;
  a.pack.H = height;
  a.pack.skip_t0 = skip_t0;
  a.pack.lstart = voxt::hf_start_level(height, tile_log, init_desc);
  a.origin = (const float*)start;
  a.dir = (const float*)dir;
  a.distance = (const float*)distance;
  a.t_min = (const float*)t_min;
  a.hit_out = (bool*)hit;
  a.t_out = (float*)t;
  a.normal_out = (float*)normal;
  a.voxel_out = (int*)voxel;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (tile_log) {
    case 1:
      return launch<1>(a, n, counter, active, static_pct, chunk, refill, s);
    case 2:
      return launch<2>(a, n, counter, active, static_pct, chunk, refill, s);
    default:
      return launch<3>(a, n, counter, active, static_pct, chunk, refill, s);
  }
}
