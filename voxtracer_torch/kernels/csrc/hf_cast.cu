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
// crossing t is (integer plane - s0) * inv, the same float at every
// level, and hits come only from the column test, so the schedule of
// cells cannot change an output bit.
//
// What bounds it on the card: dependent reads and divergence, as K2. A
// step reads ONE float whose address depends on the previous step; rays
// of a warp take different step counts. The TPU version gathers a whole
// 64-float row per step and walks several cells on it, because its
// gather is serialized per row; a thread here reads just its float, the
// row's other floats staying in L1/L2 for its next steps in the tile.
// Per step: 4 bytes read and ~40 float operations (counted below: two
// exits 8, dip 6, column test 10, descend 10 a level, advance 6).
//
// Design: one thread per ray at a time on the persistent grid of
// lanes.cuh (inactive lanes written coalesced by the warp, active lanes
// queued and handed to idle threads). All state is in registers: no
// stack, since the quadtree walk recomputes a cell from (L, cx, cz).
// The pack's row starts are copied from device memory to shared memory
// once a block; the terrain maximum is read from device memory (no host
// read per cast).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

constexpr float kEps = 1.0e-6f;  // raytrace.wgsl:53
constexpr int kThreads = 128;
constexpr int kSteps = 8;  // steps between two looks at the warp's idle threads
constexpr int kMaxLevels = 16;

struct HfPack {
  const float* tiles;
  const int* row_start;  // device memory: first row of level i * tl
  int levels, tl, H, skip_t0, init_desc;
};

struct HfRay {
  // launch-wide
  const float* __restrict__ tiles;
  const int* rows;  // row start per level / tl, in shared memory
  const float* __restrict__ origin;
  const float* __restrict__ dir;
  const float* __restrict__ distance;
  const float* __restrict__ t_min;
  bool* __restrict__ hit_out;
  float* __restrict__ t_out;
  float* __restrict__ normal_out;
  int* __restrict__ voxel_out;
  float hmax_w;
  int tl, H, skip_t0, lstart;
  // the ray in flight
  int i, axis, mirror, pos, L, cx, cz;
  float s0[3], inv[3];
  float ddy, dist, tend, t;

  __device__ __forceinline__ void skip(int base, unsigned lanes) {
    const int lane = threadIdx.x & 31;
    if ((lanes >> lane) & 1u) {
      hit_out[base + lane] = false;
      t_out[base + lane] = 0.0f;
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

  __device__ __forceinline__ void finish(bool hit, float hit_t, int hit_axis,
                                         int vx, int vy, int vz) {
    hit_out[i] = hit;
    t_out[i] = hit_t;
    const int vox[3] = {vx, vy, vz};
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float sgn = ((pos >> a) & 1) ? 1.0f
                                         : (((mirror >> a) & 1) ? -1.0f : 0.0f);
      normal_out[3 * i + a] = (hit_axis == a ? -sgn : 0.0f) * (hit ? 1.0f : 0.0f);
      voxel_out[3 * i + a] = vox[a];
    }
  }

  __device__ __forceinline__ bool miss() {
    finish(false, 0.0f, 3, 0, 0, 0);
    return false;
  }

  // a mirrored integer-valued coordinate back in the world's frame
  __device__ __forceinline__ int unmirror(float vm, int a) const {
    const float bound = (float)(1 << H);
    return (int)(((mirror >> a) & 1) ? (bound - 1.0f) - vm : vm);
  }

  // the float at (row, slot) of the pack
  __device__ __forceinline__ float height_at(int level_i, int dp, int ux,
                                             int uz) const {
    const int ts = 1 << tl;
    const long long row = rows[level_i] + (long long)(ux >> tl) * dp + (uz >> tl);
    return __ldg(tiles + row * (ts * ts) + (ux & (ts - 1)) * ts + (uz & (ts - 1)));
  }

  __device__ __forceinline__ bool start(int lane_index) {
    i = lane_index;
    const int n = 1 << H;
    const float bound = (float)n;
    mirror = 0;
    pos = 0;
    float dd[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float d = __ldg(dir + 3 * i + a);
      const float s = __ldg(origin + 3 * i + a);
      const bool flip = d < 0.0f;
      pos |= (int)(d > 0.0f) << a;
      mirror |= (int)flip << a;
      dd[a] = fmaxf(fabsf(d), kEps);
      inv[a] = 1.0f / dd[a];
      s0[a] = flip ? bound - s : s;
    }
    ddy = dd[1];
    dist = __ldg(distance + i);
    if (!((mirror >> 1) & 1)) {
      // ascending: no hit once y clears the terrain's maximum
      const float t_clear = (hmax_w + 2.0f - s0[1]) * inv[1];
      dist = fminf(dist, fmaxf(t_clear, 0.0f));
    }

    float enter[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) enter[a] = -s0[a] * inv[a];
    float t0 = fmaxf(fmaxf(fmaxf(enter[0], enter[1]), enter[2]), 0.0f);
    const int axis0 =
        enter[0] == t0 ? 0 : (enter[1] == t0 ? 1 : (enter[2] == t0 ? 2 : 3));
    if (t_min != nullptr) t0 = fmaxf(t0, __ldg(t_min + i));
    tend = fminf(fminf((bound - s0[0]) * inv[0], (bound - s0[1]) * inv[1]),
                 (bound - s0[2]) * inv[2]);
    if (!(fminf(tend, dist) >= t0)) return miss();

    const int dp0 = max(n >> tl, 1);
    // occupancy at t = 0+: the mirrored floor of the start
    bool inside0 = false;
    int v0[3] = {0, 0, 0};
    if (t0 == 0.0f) {
      bool inb = true;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        v0[a] = unmirror(floorf(s0[a]), a);
        inb = inb && v0[a] >= 0 && v0[a] < n;
      }
      inside0 = inb && (float)v0[1] < height_at(0, dp0, v0[0], v0[2]);
    }

    if (inside0) {
      if (!skip_t0) {
        finish(true, 0.0f, axis0, v0[0], v0[1], v0[2]);
        return false;
      }
      // the hit at t == 0 is skipped: the next unit-plane crossing is
      // the hit if that voxel is solid too, else the walk resumes there
      float npl[3], t_ax[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        npl[a] = floorf(s0[a]) + 1.0f;
        t_ax[a] = (npl[a] - s0[a]) * inv[a];
      }
      const float t_n = fminf(fminf(t_ax[0], t_ax[1]), t_ax[2]);
      const int n_axis = t_ax[0] == t_n ? 0 : (t_ax[1] == t_n ? 1 : 2);
      float vox_m[3];
      int vox_n[3];
      bool inb_n = true;
#pragma unroll
      for (int a = 0; a < 3; ++a) {
        const float pm = s0[a] + dd[a] * t_n;
        vox_m[a] = a == n_axis ? npl[a] : floorf(pm);
        vox_n[a] = unmirror(vox_m[a], a);
        inb_n = inb_n && vox_n[a] >= 0 && vox_n[a] < n;
      }
      const bool n_solid =
          inb_n && (float)vox_n[1] < height_at(0, dp0, vox_n[0], vox_n[2]);
      if (n_solid) {
        if (!(t_n <= dist)) return miss();
        finish(true, t_n, n_axis, vox_n[0], vox_n[1], vox_n[2]);
        return false;
      }
      if (t_n > dist || !inb_n) return miss();
      t = t_n;
      axis = n_axis;
      L = 0;
      cx = (int)vox_m[0];
      cz = (int)vox_m[2];
      return true;
    }

    // root descent by strict midplane picks to the start level
    cx = 0;
    cz = 0;
    for (int lvl = H; lvl > lstart; --lvl) {
      const float half = ldexpf(1.0f, lvl - 1);
      const float tbx = ((float)(2 * cx + 1) * half - s0[0]) * inv[0];
      const float tbz = ((float)(2 * cz + 1) * half - s0[2]) * inv[2];
      cx = 2 * cx + (int)(tbx < t0);
      cz = 2 * cz + (int)(tbz < t0);
    }
    t = t0;
    axis = axis0;
    L = lstart;
    return true;
  }

  __device__ __forceinline__ bool step() {
    const int n = 1 << H;
    const float bound = (float)n;
    const int dc = n >> L;  // child grid dim
    const int dp = max(dc >> tl, 1);
    const float cell = ldexpf(1.0f, L);  // 2^L exactly
    const float tox = ((float)(cx + 1) * cell - s0[0]) * inv[0];
    const float toz = ((float)(cz + 1) * cell - s0[2]) * inv[2];
    const float t_exit = fminf(tox, toz);

    // the cell's max height: one float of its parent's row
    const int ucx = (mirror & 1) ? dc - 1 - cx : cx;
    const int ucz = ((mirror >> 2) & 1) ? dc - 1 - cz : cz;
    const float maxh = height_at(L / tl, dp, ucx, ucz);

    // where the ray crosses the plane y == maxh, and whether it is below
    // it somewhere in [t, t_exit) (strict: a graze stays above)
    const bool desc_y = (mirror >> 1) & 1;
    const float mplane = desc_y ? bound - maxh : maxh;
    const float t_m = (mplane - s0[1]) * inv[1];
    const bool dip = (desc_y ? t_m < t_exit : t < t_m) && maxh > 0.0f;

    bool col_hit = false;
    if (L == 0) {
      // column test: entry into the solid span [0, h)
      const float t_solid = desc_y ? fmaxf(t, t_m) : t;
      const bool in_col = desc_y ? t_solid < t_exit : dip;
      col_hit = dip && in_col && t_solid < tend;
      // a lane that starts exactly on a boundary was placed in the cell
      // behind it: its t == 0 record is the skipped leaf
      if (skip_t0) col_hit = col_hit && t_solid != 0.0f;
      if (col_hit) {
        if (t_solid > dist) return miss();
        const bool top_face = desc_y && t_m > t;  // entered through y == h
        const float pm_y = s0[1] + ddy * t_solid;
        const float y_m = floorf(pm_y);
        const float y_e = desc_y ? bound - 1.0f - y_m : y_m;
        const float top = maxh - 1.0f;
        const float y_vox =
            top_face ? top : fminf(fmaxf(y_e, 0.0f), fmaxf(top, 0.0f));
        finish(true, t_solid, top_face ? 1 : axis, ucx, (int)y_vox, ucz);
        return false;
      }
    } else if (dip) {
      // descend tl levels by chained strict midplane picks
      float sub = cell;
      for (int k = 0; k < tl; ++k) {
        sub = sub * 0.5f;
        const float tbx = ((float)(2 * cx + 1) * sub - s0[0]) * inv[0];
        const float tbz = ((float)(2 * cz + 1) * sub - s0[2]) * inv[2];
        cx = 2 * cx + (int)(tbx < t);
        cz = 2 * cz + (int)(tbz < t);
      }
      L -= tl;
      return true;
    }

    // advance (no dip, or a column not entered): x before z on ties;
    // leaving the tile coarsens tl levels onto the neighbour cell
    const bool ax_x = tox <= toz;
    const int acx = cx + (int)ax_x;
    const int acz = cz + (int)!ax_x;
    if (acx >= dc || acz >= dc) return miss();
    if (t_exit > dist || t_exit >= tend) return miss();
    if ((acx >> tl) == (cx >> tl) && (acz >> tl) == (cz >> tl)) {
      cx = acx;
      cz = acz;
    } else {
      L += tl;
      cx = acx >> tl;
      cz = acz >> tl;
    }
    t = t_exit;
    axis = ax_x ? 0 : 2;
    return true;
  }
};

__global__ void __launch_bounds__(kThreads)
    hf_cast_kernel(voxt::LaneArgs lanes, HfPack pack,
                   const float* __restrict__ hmax_w,
                   const float* __restrict__ start,
                   const float* __restrict__ dir,
                   const float* __restrict__ distance,
                   const float* __restrict__ t_min, bool* __restrict__ hit_out,
                   float* __restrict__ t_out, float* __restrict__ normal_out,
                   int* __restrict__ voxel_out) {
  extern __shared__ int smem[];
  __shared__ int s_rows[kMaxLevels];
  if ((int)threadIdx.x < pack.levels)
    s_rows[threadIdx.x] = __ldg(pack.row_start + threadIdx.x);
  __syncthreads();
  HfRay ray;
  ray.tiles = pack.tiles;
  ray.rows = s_rows;
  ray.origin = start;
  ray.dir = dir;
  ray.distance = distance;
  ray.t_min = t_min;
  ray.hit_out = hit_out;
  ray.t_out = t_out;
  ray.normal_out = normal_out;
  ray.voxel_out = voxel_out;
  ray.hmax_w = __ldg(hmax_w);
  ray.tl = pack.tl;
  ray.H = pack.H;
  ray.skip_t0 = pack.skip_t0;
  // the coarsest walk level (the largest multiple of tl <= H - 1), lowered
  // init_desc tile levels when asked
  const int ltop = pack.H <= 1 ? 0 : pack.tl * ((pack.H - 1) / pack.tl);
  ray.lstart = max(ltop - pack.tl * pack.init_desc, 0);
  voxt::run_lanes<kSteps>(
      lanes, smem + (threadIdx.x >> 5) * voxt::kQueue, ray);
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
      levels > kMaxLevels || tile_log < 1 || height < 1 || height > 30 ||
      init_desc < 0)
    return (int)cudaErrorInvalidValue;
  HfPack pack;
  pack.tiles = (const float*)tiles;
  pack.row_start = (const int*)row_starts;
  pack.levels = levels;
  pack.tl = tile_log;
  pack.H = height;
  pack.skip_t0 = skip_t0;
  pack.init_desc = init_desc;
  const size_t smem = (size_t)(kThreads / 32 * voxt::kQueue) * sizeof(int);
  int blocks = 0;
  cudaError_t err =
      voxt::persistent_blocks(hf_cast_kernel, kThreads, smem, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  const voxt::LaneArgs lanes{
      (int*)counter, (const bool*)active, n,
      voxt::lanes_per_warp(n, blocks, kThreads, static_pct), chunk, refill};
  hf_cast_kernel<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      lanes, pack, (const float*)hmax_w, (const float*)start,
      (const float*)dir, (const float*)distance, (const float*)t_min,
      (bool*)hit, (float*)t, (float*)normal, (int*)voxel);
  return (int)cudaGetLastError();
}
