// The bit-grid walk of one ray: the body of K8 (bit_dda.cu), which K9
// (path_trace.cu) runs as a device function for the bit-grid engine's
// casts. bit_dda.cu's note says what it computes and why it is written so;
// this header holds the one copy of its arithmetic.

#pragma once

#include <cuda_runtime.h>

namespace voxt {

constexpr float kBitEps = 1.0e-6f;  // raytrace.wgsl:53

// The packed occupancy pyramid of world/bitgrid.py (uint32 words) and the
// walk's launch-wide settings
struct BitGrid {
  const unsigned* top;      // a bit a 128^3 region
  const unsigned* regions;  // nr^3 rows of 128 words: a bit a 8^3 brick
  const unsigned* bricks;   // nb^3 rows of 16 words: a bit a voxel
  int top_words, n, skip_t0;
};

// floor(x) clamped to the grid [0, n), clamped in float first
__device__ __forceinline__ int bit_cell(float x, int n) {
  return (int)fminf(fmaxf(floorf(x), 0.0f), (float)(n - 1));
}

// The walk of one ray down the pyramid. Io gives the ray and takes the
// result:
//   float origin(int k), dir(int k), distance(): the ray and its strict
//       cap;
//   void finish(bool hit, float t, const float* normal, const int* voxel):
//       the four outputs.
// begin() sets the ray up and returns false once it has finished; step()
// tests one cell and descends into it or steps past it, and returns false
// once the ray has finished. All of its state lives in registers: the
// level, the entry or step axis, the direction's signs, the cell, and the
// mirrored ray. The word a step tests is read from the region or brick
// row the ray is in. Tried on the card and not kept (PERF.md section 6):
// the level, axis and signs packed in one int (fewer registers, more
// operations a step: slower on every set), the normal's signs read again
// from io.dir() at the end (slower), and the last word read kept to skip
// a read when the next cell shares it (more registers than it saved).
template <class Io>
struct BitWalk {
  const BitGrid& g;  // launch-wide: the kernel's parameters, no registers
  Io io;
  // the ray in flight
  int lvl, axis;  // the level (2 region, 1 brick, 0 voxel); 3: no axis
  bool flip[3], pos[3];  // d < 0 (the mirrored axes), d > 0
  int v[3];       // the voxel the ray is in, mirrored
  float o[3], dm[3], inv[3];
  float t, t_exit;

  __device__ __forceinline__ bool finish(bool hit, float hit_t, int hit_axis,
                                         const int* vox) {
    float normal[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float sgn = pos[k] ? 1.0f : (flip[k] ? -1.0f : 0.0f);
      normal[k] = (hit_axis == k ? -sgn : 0.0f) * (hit ? 1.0f : 0.0f);
    }
    io.finish(hit, hit_t, normal, vox);
    return false;
  }

  __device__ __forceinline__ bool miss() {
    const int vox[3] = {0, 0, 0};
    return finish(false, 0.0f, 3, vox);
  }

  __device__ __forceinline__ bool begin() {
    const int n = g.n;
    const float bound = (float)n;
    float enter[3], ex[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      const float d = io.dir(k);
      flip[k] = d < 0.0f;
      pos[k] = d > 0.0f;
      dm[k] = fmaxf(fabsf(d), kBitEps);
      inv[k] = 1.0f / dm[k];
      const float s = io.origin(k);
      o[k] = d < 0.0f ? bound - s : s;
      enter[k] = -o[k] * inv[k];
      ex[k] = (bound - o[k]) * inv[k];
    }
    const float t0 = fmaxf(fmaxf(fmaxf(enter[0], enter[1]), enter[2]), 0.0f);
    t_exit = fminf(fminf(fminf(ex[0], ex[1]), ex[2]), io.distance());
    axis = enter[0] == t0 ? 0 : (enter[1] == t0 ? 1 : (enter[2] == t0 ? 2 : 3));
    if (!(t0 > 0.0f)) axis = 3;
    if (!(t_exit >= t0)) return miss();
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = bit_cell(o[k] + dm[k] * t0, n);
    t = t0;
    lvl = 2;  // the walk starts at the region level
    return true;
  }

  __device__ __forceinline__ bool step() {
    const int n = g.n;
    const int s = lvl == 2 ? 128 : (lvl == 1 ? 8 : 1);
    int c[3], cw[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = v[k] & ~(s - 1);
      cw[k] = flip[k] ? n - c[k] - s : c[k];
    }
    // the cell's occupancy bit: one word of the level's array
    unsigned word;
    int bit;
    if (lvl == 2) {
      const int nr = n >> 7;
      bit = ((cw[0] >> 7) * nr + (cw[1] >> 7)) * nr + (cw[2] >> 7);
      word = (bit >> 5) < g.top_words ? __ldg(g.top + (bit >> 5)) : 0u;
    } else if (lvl == 1) {
      const int nr = n >> 7;
      const int ridx = ((cw[0] >> 7) * nr + (cw[1] >> 7)) * nr + (cw[2] >> 7);
      bit = (((cw[2] >> 3) & 15) * 16 + ((cw[1] >> 3) & 15)) * 16 +
            ((cw[0] >> 3) & 15);
      word = __ldg(g.regions + (size_t)ridx * 128 + (bit >> 5));
    } else {
      const int nb = n >> 3;
      const int bidx = ((cw[0] >> 3) * nb + (cw[1] >> 3)) * nb + (cw[2] >> 3);
      bit = ((cw[2] & 7) * 8 + (cw[1] & 7)) * 8 + (cw[0] & 7);
      word = __ldg(g.bricks + (size_t)bidx * 16 + (bit >> 5));
    }
    const bool occ = (word >> (bit & 31)) & 1u;
    bool is_hit = occ && lvl == 0;
    bool skip = false;
    if (g.skip_t0) {
      skip = is_hit && t == 0.0f;
      is_hit = is_hit && t != 0.0f;
    }
    if (is_hit) {
      int hv[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) hv[k] = flip[k] ? n - v[k] - 1 : v[k];
      return finish(true, t, axis, hv);
    }
    if (occ && lvl > 0 && !skip) {  // descend
      lvl -= 1;
      return true;
    }
    // advance to the next cell of this level through its nearest exit
    // plane (x before y before z on a tie), ascending to the coarsest
    // boundary crossed
    float tn[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) tn[k] = ((float)(c[k] + s) - o[k]) * inv[k];
    const float m = fminf(fminf(tn[0], tn[1]), tn[2]);
    const int step_axis = tn[0] == m ? 0 : (tn[1] == m ? 1 : 2);
    bool out = m > t_exit;
    bool reg_crossed = false, brick_crossed = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // a cell index never decreases in the mirrored space (a rounding
      // down of o + dm * m must not step the ray back: bit_dda.cu's note)
      const int va =
          k == step_axis ? c[k] + s : max(bit_cell(o[k] + dm[k] * m, n), v[k]);
      out = out || va >= n;
      reg_crossed = reg_crossed || (va >> 7) != (v[k] >> 7);
      brick_crossed = brick_crossed || (va >> 3) != (v[k] >> 3);
      v[k] = va;
    }
    lvl = reg_crossed ? 2 : (brick_crossed ? max(lvl, 1) : lvl);
    axis = step_axis;
    t = m;
    if (out) return miss();
    return true;
  }
};

}  // namespace voxt
