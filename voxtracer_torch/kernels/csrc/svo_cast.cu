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
// Design: one thread per ray at a time, on a persistent grid
// (lanes.cuh): warps scan the lanes, write the outputs of inactive lanes
// themselves, and hand only active rays to threads, refilling threads
// whose rays are done; a thread takes up to kSteps steps between two
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

namespace {

constexpr float kEps = 1.0e-6f;  // raytrace.wgsl:53
constexpr int kThreads = 128;
constexpr int kSteps = 8;  // steps between two looks at the warp's idle threads

struct SvoRay {
  // launch-wide
  const int* __restrict__ table;
  const float* __restrict__ origin;
  const float* __restrict__ dir;
  const float* __restrict__ distance;
  bool* __restrict__ hit_out;
  float* __restrict__ t_out;
  int* __restrict__ node_out;
  float* __restrict__ normal_out;
  int* __restrict__ voxel_out;
  int* stk;  // this thread's node stack: level l at stk[l * stride]
  int stride, root, H, skip_t0;
  // the ray in flight
  int i, h, axis, mirror, pos;
  int words[3];
  float s0[3], inv[3];
  float dist, t;

  __device__ __forceinline__ void skip(int base, unsigned lanes) {
    const int lane = threadIdx.x & 31;
    if ((lanes >> lane) & 1u) {
      hit_out[base + lane] = false;
      t_out[base + lane] = 0.0f;
      node_out[base + lane] = -1;
    }
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      const int e = lane + 32 * r;  // element of the 32 lanes' (32, 3) rows
      if ((lanes >> (e / 3)) & 1u) {
        normal_out[3 * base + e] = 0.0f;
        voxel_out[3 * base + e] = 0;
      }
    }
  }

  __device__ __forceinline__ void finish(bool hit, float hit_t, int hit_node,
                                         int hit_axis, const int* vox) {
    hit_out[i] = hit;
    t_out[i] = hit_t;
    node_out[i] = hit_node;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float sgn = ((pos >> a) & 1) ? 1.0f
                                         : (((mirror >> a) & 1) ? -1.0f : 0.0f);
      normal_out[3 * i + a] = (hit_axis == a ? -sgn : 0.0f) * (hit ? 1.0f : 0.0f);
      voxel_out[3 * i + a] = vox[a];
    }
  }

  __device__ __forceinline__ bool start(int lane_index) {
    i = lane_index;
    const float bound = (float)(1 << H);
    mirror = 0;
    pos = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float d = __ldg(dir + 3 * i + a);
      const float s = __ldg(origin + 3 * i + a);
      const bool flip = d < 0.0f;
      pos |= (int)(d > 0.0f) << a;
      mirror |= (int)flip << a;
      inv[a] = 1.0f / fmaxf(fabsf(d), kEps);
      s0[a] = flip ? bound - s : s;
    }
    dist = __ldg(distance + i);

    float enter[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) enter[a] = -s0[a] * inv[a];
    t = fmaxf(fmaxf(fmaxf(enter[0], enter[1]), enter[2]), 0.0f);
    axis = enter[0] == t ? 0 : (enter[1] == t ? 1 : (enter[2] == t ? 2 : 3));

    float tend_root = fminf(fminf((bound - s0[0]) * inv[0],
                                  (bound - s0[1]) * inv[1]),
                            (bound - s0[2]) * inv[2]);
    tend_root = fminf(tend_root, dist);
    const float half_root = (float)(1 << (H - 1));
#pragma unroll
    for (int a = 0; a < 3; ++a)
      words[a] = (int)(((half_root - s0[a]) * inv[a]) < t) << (H - 1);

    if (!(root >= 0 && tend_root >= t)) {
      const int vox[3] = {0, 0, 0};
      finish(false, 0.0f, -1, 3, vox);
      return false;
    }
    for (int l = 0; l < H; ++l) stk[l * stride] = -1;
    stk[H * stride] = root;
    h = H - 1;
    return true;
  }

  __device__ __forceinline__ bool step() {
    const bool descend = stk[h * stride] == -1;
    const int low_mask = (1 << h) - 1;
    int off_i[3];
    float tmid[3], tend_ax[3];
    const float cell = ldexpf(1.0f, h);  // 2^h exactly
    const float mid = cell * 0.5f;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      off_i[a] = words[a] & ~low_mask;
      const float offset = (float)off_i[a];
      tmid[a] = (offset + mid - s0[a]) * inv[a];
      tend_ax[a] = (offset + cell - s0[a]) * inv[a];
    }
    const float tend =
        fminf(fminf(fminf(tend_ax[0], tend_ax[1]), tend_ax[2]), dist);

    if (descend) {
      // the child octant of the parent cell (one node-row read)
      const int parent = stk[(h + 1 <= H ? h + 1 : H) * stride];
      int child_idx = 0;
#pragma unroll
      for (int a = 0; a < 3; ++a) child_idx |= ((words[a] >> h) & 1) << a;
      child_idx ^= mirror;
      const int child = parent >= 0 ? __ldg(table + parent * 8 + child_idx) : -1;
      if (child == -1) {
        h += 1;  // pop
      } else if (h == 0) {
        if (skip_t0 && t == 0.0f) {
          h += 1;  // camera inside a solid: skip the hit at t == 0
        } else {
          int vox[3];
#pragma unroll
          for (int a = 0; a < 3; ++a)
            vox[a] = ((mirror >> a) & 1) ? (1 << H) - off_i[a] - 1 : off_i[a];
          finish(true, t, child, axis, vox);
          return false;
        }
      } else {
        // push: the child's subvoxel bits (tmid < t) go to word bit h-1
        const int bit = 1 << (h - 1);
#pragma unroll
        for (int a = 0; a < 3; ++a)
          words[a] = (words[a] & ~bit) | (tmid[a] < t ? bit : 0);
        stk[h * stride] = child;
        stk[(h - 1) * stride] = -1;
        h -= 1;
      }
    } else {
      // advance: the next midplane crossing, or leave the cell
      const int hm1 = h - 1 > 0 ? h - 1 : 0;
      float t_next[3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
        t_next[a] = ((words[a] >> hm1) & 1) ? tend : tmid[a];
      const float m = fminf(fminf(t_next[0], t_next[1]), t_next[2]);
      if (m == tend) {
        h += 1;  // pop
      } else {
        const int ax = t_next[0] == m ? 0 : (t_next[1] == m ? 1 : 2);
#pragma unroll
        for (int a = 0; a < 3; ++a)
          if (a == ax) words[a] |= 1 << hm1;
        t = m;
        axis = ax;
        stk[hm1 * stride] = -1;
        h -= 1;
      }
    }
    if (h <= H) return true;
    const int vox[3] = {0, 0, 0};
    finish(false, 0.0f, -1, 3, vox);
    return false;
  }
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
  ray.table = table;
  ray.origin = start;
  ray.dir = dir;
  ray.distance = distance;
  ray.hit_out = hit_out;
  ray.t_out = t_out;
  ray.node_out = node_out;
  ray.normal_out = normal_out;
  ray.voxel_out = voxel_out;
  ray.stk = smem + warps * voxt::kQueue + threadIdx.x;
  ray.stride = blockDim.x;
  ray.root = root;
  ray.H = H;
  ray.skip_t0 = skip_t0;
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
