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
// - One thread per ray at a time on the persistent grid of lanes.cuh
//   (inactive lanes written coalesced by the warp, active lanes queued
//   and handed to idle threads), 8 blocks of 128 an SM. All ray state is
//   in registers: no stack, since the quadtree walk recomputes a cell
//   from (L, cx, cz). The terrain maximum is read from device memory (no
//   host read per cast).
// Tried and not kept (PERF.md): the coarsest rows in shared memory (as
// fast as L1), a neighbour's height loaded a step ahead, the height read
// as soon as the cell is entered, 10-12 blocks an SM (the register cap
// spills), other kSteps and lane-fetch settings.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanes.cuh"

namespace {

constexpr float kEps = 1.0e-6f;  // raytrace.wgsl:53
constexpr int kSteps = 8;  // steps between two looks at the warp's idle threads
constexpr int kMaxLevels = 16;
constexpr int kThreads = 128;
constexpr int kMinBlocks = 8;  // blocks an SM holds: at most 64 registers

// 2^e as a float, exactly, from its exponent bits (0 <= e < 128)
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

struct HfArgs {
  const float* tiles;
  const int* row_start;  // device memory: first row of level i * tl
  const float* hmax_w;
  const float* origin;
  const float* dir;
  const float* distance;
  const float* t_min;
  bool* hit_out;
  float* t_out;
  float* normal_out;
  int* voxel_out;
  int levels, H, skip_t0, lstart;
};

template <int TL>
struct HfRay {
  static constexpr int TS = 1 << TL;
  const HfArgs& a;  // launch-wide: the kernel's parameters, no registers
  const int* rows;  // row start per level index, in shared memory
  // the ray in flight: lane i; bits: entry axis (2), mirror (3), d > 0 (3)
  int i, bits;
  int li, cx, cz;  // level index (L = li * TL) and mirrored cell
  float s0[3], inv[3];
  float dist, tend, t;
  // the level's constants and the current cell's exit planes
  int dc, row0, row_shift;
  float cell, tox, toz;

  __device__ __forceinline__ int axis() const { return bits & 3; }
  __device__ __forceinline__ bool flipped(int k) const {
    return (bits >> (2 + k)) & 1;
  }

  __device__ __forceinline__ void skip(int base, unsigned lanes) {
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

  __device__ __forceinline__ void finish(bool hit, float hit_t, int hit_axis,
                                         int vx, int vy, int vz) {
    a.hit_out[i] = hit;
    a.t_out[i] = hit_t;
    const int vox[3] = {vx, vy, vz};
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float sgn = ((bits >> (5 + k)) & 1) ? 1.0f
                                                : (flipped(k) ? -1.0f : 0.0f);
      a.normal_out[3 * i + k] =
          (hit_axis == k ? -sgn : 0.0f) * (hit ? 1.0f : 0.0f);
      a.voxel_out[3 * i + k] = vox[k];
    }
  }

  __device__ __forceinline__ bool miss() {
    finish(false, 0.0f, 3, 0, 0, 0);
    return false;
  }

  // a mirrored integer-valued coordinate back in the world's frame
  __device__ __forceinline__ int unmirror(float vm, int k) const {
    const float bound = (float)(1 << a.H);
    return (int)(flipped(k) ? (bound - 1.0f) - vm : vm);
  }

  // the float at un-mirrored cell (ux, uz) of the level whose first row is
  // `first` and whose rows per side are 2^shift; 32-bit indices (the
  // wrapper checks the pack's size)
  __device__ __forceinline__ float height_at(int first, int shift, int ux,
                                             int uz) const {
    const int row = first + ((ux >> TL) << shift) + (uz >> TL);
    return __ldg(a.tiles + (row << (2 * TL)) + ((ux & (TS - 1)) << TL) +
                 (uz & (TS - 1)));
  }

  // the constants of level index li and the exits of cell (cx, cz)
  __device__ __forceinline__ void enter_level() {
    const int L = li * TL;
    dc = (1 << a.H) >> L;  // child grid dim
    row0 = rows[li];
    row_shift = max(a.H - L - TL, 0);  // log2 of max(dc >> TL, 1)
    cell = pow2f(L);  // 2^L exactly
    tox = ((float)(cx + 1) * cell - s0[0]) * inv[0];
    toz = ((float)(cz + 1) * cell - s0[2]) * inv[2];
  }

  __device__ __forceinline__ bool start(int lane_index) {
    i = lane_index;
    const int n = 1 << a.H;
    const float bound = (float)n;
    int mirror = 0, pos = 0;
    float dd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = __ldg(a.dir + 3 * i + k);
      const float s = __ldg(a.origin + 3 * i + k);
      const bool flip = d < 0.0f;
      pos |= (int)(d > 0.0f) << k;
      mirror |= (int)flip << k;
      dd[k] = fmaxf(fabsf(d), kEps);
      inv[k] = 1.0f / dd[k];
      s0[k] = flip ? bound - s : s;
    }
    bits = (mirror << 2) | (pos << 5);
    dist = __ldg(a.distance + i);
    if (!(mirror & 2)) {
      // ascending: no hit once y clears the terrain's maximum
      const float t_clear = (__ldg(a.hmax_w) + 2.0f - s0[1]) * inv[1];
      dist = fminf(dist, fmaxf(t_clear, 0.0f));
    }

    float enter[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) enter[k] = -s0[k] * inv[k];
    // +0.0 where the latest entry is -0.0 (a start on the mirrored low
    // face), as XLA's max gives it
    const float e = fmaxf(fmaxf(enter[0], enter[1]), enter[2]);
    float t0 = e > 0.0f ? e : 0.0f;
    const int axis0 =
        enter[0] == t0 ? 0 : (enter[1] == t0 ? 1 : (enter[2] == t0 ? 2 : 3));
    if (a.t_min != nullptr) t0 = fmaxf(t0, __ldg(a.t_min + i));
    tend = fminf(fminf((bound - s0[0]) * inv[0], (bound - s0[1]) * inv[1]),
                 (bound - s0[2]) * inv[2]);
    if (!(fminf(tend, dist) >= t0)) return miss();

    const int shift0 = max(a.H - TL, 0);
    // occupancy at t = 0+: the mirrored floor of the start
    bool inside0 = false;
    int v0[3] = {0, 0, 0};
    if (t0 == 0.0f) {
      bool inb = true;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        v0[k] = unmirror(floorf(s0[k]), k);
        inb = inb && v0[k] >= 0 && v0[k] < n;
      }
      inside0 = inb && (float)v0[1] < height_at(rows[0], shift0, v0[0], v0[2]);
    }

    if (inside0) {
      if (!a.skip_t0) {
        finish(true, 0.0f, axis0, v0[0], v0[1], v0[2]);
        return false;
      }
      // the hit at t == 0 is skipped: the next unit-plane crossing is
      // the hit if that voxel is solid too, else the walk resumes there
      float npl[3], t_ax[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        npl[k] = floorf(s0[k]) + 1.0f;
        t_ax[k] = (npl[k] - s0[k]) * inv[k];
      }
      const float t_n = fminf(fminf(t_ax[0], t_ax[1]), t_ax[2]);
      const int n_axis = t_ax[0] == t_n ? 0 : (t_ax[1] == t_n ? 1 : 2);
      float vox_m[3];
      int vox_n[3];
      bool inb_n = true;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float pm = s0[k] + dd[k] * t_n;
        vox_m[k] = k == n_axis ? npl[k] : floorf(pm);
        vox_n[k] = unmirror(vox_m[k], k);
        inb_n = inb_n && vox_n[k] >= 0 && vox_n[k] < n;
      }
      const bool n_solid =
          inb_n &&
          (float)vox_n[1] < height_at(rows[0], shift0, vox_n[0], vox_n[2]);
      if (n_solid) {
        if (!(t_n <= dist)) return miss();
        finish(true, t_n, n_axis, vox_n[0], vox_n[1], vox_n[2]);
        return false;
      }
      if (t_n > dist || !inb_n) return miss();
      t = t_n;
      bits |= n_axis;
      li = 0;
      cx = (int)vox_m[0];
      cz = (int)vox_m[2];
      enter_level();
      return true;
    }

    // root descent by strict midplane picks to the start level
    cx = 0;
    cz = 0;
    for (int lvl = a.H; lvl > a.lstart; --lvl) {
      const float half = pow2f(lvl - 1);
      const float tbx = ((float)(2 * cx + 1) * half - s0[0]) * inv[0];
      const float tbz = ((float)(2 * cz + 1) * half - s0[2]) * inv[2];
      cx = 2 * cx + (int)(tbx < t0);
      cz = 2 * cz + (int)(tbz < t0);
    }
    t = t0;
    bits |= axis0 & 3;  // 3: no entry plane, never a hit's axis
    li = a.lstart / TL;
    enter_level();
    return true;
  }

  // One cell. Every lane computes the three successors (the child a dip
  // descends to, the neighbour in the tile, the parent cell past the
  // tile's edge) and selects one, so a warp runs one path whatever its
  // lanes' cases; the child's midplane picks and the neighbour depend only
  // on the cell, so they overlap the height's load. Only a hit or a miss
  // branches.
  __device__ __forceinline__ bool step() {
    const float t_exit = fminf(tox, toz);

    // the cell's max height: one float of its parent's row
    const int ucx = flipped(0) ? dc - 1 - cx : cx;
    const int ucz = flipped(2) ? dc - 1 - cz : cz;
    const float maxh = height_at(row0, row_shift, ucx, ucz);

    // the child a dip above column level descends to: TL chained strict
    // midplane picks
    int ccx = cx, ccz = cz;
    float sub = cell;
#pragma unroll
    for (int k = 0; k < TL; ++k) {
      sub = sub * 0.5f;
      const float tbx = ((float)(2 * ccx + 1) * sub - s0[0]) * inv[0];
      const float tbz = ((float)(2 * ccz + 1) * sub - s0[2]) * inv[2];
      ccx = 2 * ccx + (int)(tbx < t);
      ccz = 2 * ccz + (int)(tbz < t);
    }
    // the neighbour an advance enters: x before z on ties
    const bool ax_x = tox <= toz;
    const int acx = cx + (int)ax_x;
    const int acz = cz + (int)!ax_x;

    // where the ray crosses the plane y == maxh, and whether it is below
    // it somewhere in [t, t_exit) (strict: a graze stays above)
    const bool desc_y = flipped(1);
    const float bound = (float)(1 << a.H);
    const float mplane = desc_y ? bound - maxh : maxh;
    const float t_m = (mplane - s0[1]) * inv[1];
    const bool dip = (desc_y ? t_m < t_exit : t < t_m) && maxh > 0.0f;

    if (li == 0) {
      // column test: entry into the solid span [0, h)
      const float t_solid = desc_y ? fmaxf(t, t_m) : t;
      const bool in_col = desc_y ? t_solid < t_exit : dip;
      bool col_hit = dip && in_col && t_solid < tend;
      // a lane that starts exactly on a boundary was placed in the cell
      // behind it: its t == 0 record is the skipped leaf
      if (a.skip_t0) col_hit = col_hit && t_solid != 0.0f;
      if (col_hit) {
        if (t_solid > dist) return miss();
        const bool top_face = desc_y && t_m > t;  // entered through y == h
        const float ddy = fmaxf(fabsf(__ldg(a.dir + 3 * i + 1)), kEps);
        const float pm_y = s0[1] + ddy * t_solid;
        const float y_m = floorf(pm_y);
        const float y_e = desc_y ? bound - 1.0f - y_m : y_m;
        const float top = maxh - 1.0f;
        const float y_vox =
            top_face ? top : fminf(fmaxf(y_e, 0.0f), fmaxf(top, 0.0f));
        finish(true, t_solid, top_face ? 1 : axis(), ucx, (int)y_vox, ucz);
        return false;
      }
    }
    const bool desc = dip && li > 0;
    if (!desc && (acx >= dc || acz >= dc || t_exit > dist || t_exit >= tend))
      return miss();

    // advance (no dip, or a column not entered): to the neighbour, or
    // coarsen TL levels onto it when it lies past the tile's edge
    const bool in_tile = ((ax_x ? acx : acz) & (TS - 1)) != 0;
    if (!desc) {
      t = t_exit;
      bits = (bits & ~3) | (ax_x ? 0 : 2);
    }
    cx = desc ? ccx : (in_tile ? acx : acx >> TL);
    cz = desc ? ccz : (in_tile ? acz : acz >> TL);
    li += desc ? -1 : (in_tile ? 0 : 1);
    enter_level();
    return true;
  }
};

template <int TL>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    hf_cast_kernel(voxt::LaneArgs lanes, __grid_constant__ const HfArgs a) {
  extern __shared__ int smem[];
  __shared__ int s_rows[kMaxLevels];
  if ((int)threadIdx.x < a.levels)
    s_rows[threadIdx.x] = __ldg(a.row_start + threadIdx.x);
  __syncthreads();
  HfRay<TL> ray{a, s_rows};
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
      levels > kMaxLevels || tile_log < 1 || tile_log > 3 || height < 1 ||
      height > 30 || init_desc < 0)
    return (int)cudaErrorInvalidValue;
  HfArgs a;
  a.tiles = (const float*)tiles;
  a.row_start = (const int*)row_starts;
  a.hmax_w = (const float*)hmax_w;
  a.origin = (const float*)start;
  a.dir = (const float*)dir;
  a.distance = (const float*)distance;
  a.t_min = (const float*)t_min;
  a.hit_out = (bool*)hit;
  a.t_out = (float*)t;
  a.normal_out = (float*)normal;
  a.voxel_out = (int*)voxel;
  a.levels = levels;
  a.H = height;
  a.skip_t0 = skip_t0;
  // the coarsest walk level (the largest multiple of tile_log <= H - 1),
  // lowered init_desc tile levels when asked
  const int ltop = height <= 1 ? 0 : tile_log * ((height - 1) / tile_log);
  a.lstart = ltop > tile_log * init_desc ? ltop - tile_log * init_desc : 0;
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
