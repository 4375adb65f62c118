// The heightfield walk of one ray: the body of K4 (hf_cast.cu), which K9
// (path_trace.cu) runs as a device function for the heightfield engines'
// casts. hf_cast.cu's note says what it computes and why it is written so;
// this header holds the one copy of its arithmetic.

#pragma once

#include <cuda_runtime.h>

namespace voxt {

constexpr float kHfEps = 1.0e-6f;  // raytrace.wgsl:53
constexpr int kHfMaxLevels = 16;

// 2^e as a float, exactly, from its exponent bits (0 <= e < 128)
__device__ __forceinline__ float pow2f(int e) {
  return __int_as_float((e + 127) << 23);
}

// the pack and the walk's launch-wide settings
struct HfPack {
  const float* tiles;
  const int* row_start;  // device memory: first row of level i * tl
  const float* hmax_w;
  int levels, H, skip_t0, lstart;
};

// The walk of one ray over the max-mip quadtree. Io gives the ray and
// takes the result:
//   float origin(int k), dir(int k), distance(): the ray and its strict
//       cap;
//   float t_min(float t0): the walk's start, t0 or a later resume;
//   void finish(bool hit, float t, const float* normal, int vx, int vy,
//       int vz): the outputs.
// begin() sets the ray up and returns false once it has finished; step()
// walks one cell and returns false once it has. `rows` holds the row start
// of each level index (in shared memory).
template <int TL, class Io>
struct HfWalk {
  static constexpr int TS = 1 << TL;
  const HfPack& a;  // launch-wide: the kernel's parameters, no registers
  const int* rows;
  Io io;
  // the ray in flight; bits: entry axis (2), mirror (3), d > 0 (3)
  int bits;
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

  __device__ __forceinline__ bool finish(bool hit, float hit_t, int hit_axis,
                                         int vx, int vy, int vz) {
    float normal[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float sgn = ((bits >> (5 + k)) & 1) ? 1.0f
                                                : (flipped(k) ? -1.0f : 0.0f);
      normal[k] = (hit_axis == k ? -sgn : 0.0f) * (hit ? 1.0f : 0.0f);
    }
    io.finish(hit, hit_t, normal, vx, vy, vz);
    return false;
  }

  __device__ __forceinline__ bool miss() {
    return finish(false, 0.0f, 3, 0, 0, 0);
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

  __device__ __forceinline__ bool begin() {
    const int n = 1 << a.H;
    const float bound = (float)n;
    int mirror = 0, pos = 0;
    float dd[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = io.dir(k);
      const float s = io.origin(k);
      const bool flip = d < 0.0f;
      pos |= (int)(d > 0.0f) << k;
      mirror |= (int)flip << k;
      dd[k] = fmaxf(fabsf(d), kHfEps);
      inv[k] = 1.0f / dd[k];
      s0[k] = flip ? bound - s : s;
    }
    bits = (mirror << 2) | (pos << 5);
    dist = io.distance();
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
    t0 = io.t_min(t0);
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
      if (!a.skip_t0) return finish(true, 0.0f, axis0, v0[0], v0[1], v0[2]);
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
        return finish(true, t_n, n_axis, vox_n[0], vox_n[1], vox_n[2]);
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
        const float ddy = fmaxf(fabsf(io.dir(1)), kHfEps);
        const float pm_y = s0[1] + ddy * t_solid;
        const float y_m = floorf(pm_y);
        const float y_e = desc_y ? bound - 1.0f - y_m : y_m;
        const float top = maxh - 1.0f;
        const float y_vox =
            top_face ? top : fminf(fmaxf(y_e, 0.0f), fmaxf(top, 0.0f));
        return finish(true, t_solid, top_face ? 1 : axis(), ucx, (int)y_vox,
                      ucz);
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

// The coarsest walk level (the largest multiple of tile_log <= H - 1),
// lowered init_desc tile levels.
inline int hf_start_level(int height, int tile_log, int init_desc) {
  const int ltop = height <= 1 ? 0 : tile_log * ((height - 1) / tile_log);
  return ltop > tile_log * init_desc ? ltop - tile_log * init_desc : 0;
}

}  // namespace voxt
