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
// Design (simple first): one thread a ray. The reference carries the
// region and brick rows it descended into and picks a word by a tree of
// selects (TPU mechanism); here the word is loaded from the region or
// brick the ray is in, which is that row: a ray leaves a brick or region
// only by ascending to its level.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kEps = 1.0e-6f;  // raytrace.wgsl:53

struct DdaArgs {
  const unsigned* top;
  const unsigned* regions;
  const unsigned* bricks;
  const float* start;
  const float* dir;
  const float* distance;
  const bool* active;
  int top_words, n, skip_t0, lanes;
  bool* hit_out;
  float* t_out;
  float* normal_out;
  int* voxel_out;
};

__device__ __forceinline__ int cell_of(float x, int n) {
  return (int)fminf(fmaxf(floorf(x), 0.0f), (float)(n - 1));
}

__global__ void __launch_bounds__(kThreads) bit_dda_kernel(const DdaArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.lanes) return;
  const int n = a.n, nr = n >> 7, nb = n >> 3;
  const float bound = (float)n;
  float d[3], o[3], dm[3], inv[3], sgn[3];
  bool flip[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] = a.dir[3 * i + c];
    flip[c] = d[c] < 0.0f;
    sgn[c] = d[c] > 0.0f ? 1.0f : (d[c] < 0.0f ? -1.0f : 0.0f);
    dm[c] = fmaxf(fabsf(d[c]), kEps);
    inv[c] = 1.0f / dm[c];
    const float s = a.start[3 * i + c];
    o[c] = flip[c] ? bound - s : s;
  }
  float enter[3], ex[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    enter[c] = -o[c] * inv[c];
    ex[c] = (bound - o[c]) * inv[c];
  }
  const float t0 = fmaxf(fmaxf(fmaxf(enter[0], enter[1]), enter[2]), 0.0f);
  const float t_exit =
      fminf(fminf(fminf(ex[0], ex[1]), ex[2]), a.distance[i]);
  int axis = enter[0] == t0 ? 0 : (enter[1] == t0 ? 1 : (enter[2] == t0 ? 2 : 3));
  if (!(t0 > 0.0f)) axis = 3;
  int v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) v[c] = cell_of(o[c] + dm[c] * t0, n);
  bool alive = t_exit >= t0;
  if (a.active != nullptr) alive = alive && a.active[i];

  bool hit = false;
  float hit_t = 0.0f;
  int hit_axis = 3;
  int hv[3] = {0, 0, 0};
  int lvl = 2;
  float t = t0;
  while (alive) {
    const int s = lvl == 2 ? 128 : (lvl == 1 ? 8 : 1);
    int c[3], cw[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      c[k] = v[k] & ~(s - 1);
      cw[k] = flip[k] ? n - c[k] - s : c[k];
    }
    bool occ;
    if (lvl == 2) {
      const int ridx = ((cw[0] >> 7) * nr + (cw[1] >> 7)) * nr + (cw[2] >> 7);
      const int wi = ridx >> 5;
      const unsigned word = wi < a.top_words ? __ldg(a.top + wi) : 0u;
      occ = (word >> (ridx & 31)) & 1u;
    } else if (lvl == 1) {
      const int ridx = ((cw[0] >> 7) * nr + (cw[1] >> 7)) * nr + (cw[2] >> 7);
      const int cbit = (((cw[2] >> 3) & 15) * 16 + ((cw[1] >> 3) & 15)) * 16 +
                       ((cw[0] >> 3) & 15);
      const unsigned word =
          __ldg(a.regions + (int64_t)ridx * 128 + (cbit >> 5));
      occ = (word >> (cbit & 31)) & 1u;
    } else {
      const int bidx = ((cw[0] >> 3) * nb + (cw[1] >> 3)) * nb + (cw[2] >> 3);
      const int vbit = ((cw[2] & 7) * 8 + (cw[1] & 7)) * 8 + (cw[0] & 7);
      const unsigned word =
          __ldg(a.bricks + (int64_t)bidx * 16 + (vbit >> 5));
      occ = (word >> (vbit & 31)) & 1u;
    }
    bool is_hit = occ && lvl == 0;
    bool skip = false;
    if (a.skip_t0) {
      skip = is_hit && t == 0.0f;
      is_hit = is_hit && t != 0.0f;
    }
    if (is_hit) {
      hit = true;
      hit_t = t;
      hit_axis = axis;
#pragma unroll
      for (int k = 0; k < 3; ++k) hv[k] = flip[k] ? n - v[k] - 1 : v[k];
      break;
    }
    if (occ && lvl > 0 && !skip) {  // descend
      lvl -= 1;
      continue;
    }
    // advance to the next cell of this level
    float tn[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) tn[k] = ((float)(c[k] + s) - o[k]) * inv[k];
    const float m = fminf(fminf(tn[0], tn[1]), tn[2]);
    const int step_axis = tn[0] == m ? 0 : (tn[1] == m ? 1 : 2);
    int va[3];
    bool out = m > t_exit;
    bool reg_crossed = false, brick_crossed = false;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      // a cell index never decreases in the mirrored space (a rounding
      // down of o + dm * m must not step the ray back: module doc)
      va[k] = k == step_axis ? c[k] + s : max(cell_of(o[k] + dm[k] * m, n), v[k]);
      out = out || va[k] >= n;
      reg_crossed = reg_crossed || (va[k] >> 7) != (v[k] >> 7);
      brick_crossed = brick_crossed || (va[k] >> 3) != (v[k] >> 3);
    }
    lvl = reg_crossed ? 2 : (brick_crossed ? (lvl > 1 ? lvl : 1) : lvl);
#pragma unroll
    for (int k = 0; k < 3; ++k) v[k] = va[k];
    t = m;
    axis = step_axis;
    if (out) alive = false;
  }
  a.hit_out[i] = hit;
  a.t_out[i] = hit_t;
  const float hitf = hit ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.normal_out[3 * i + k] = (hit_axis == k ? -sgn[k] : 0.0f) * hitf;
    a.voxel_out[3 * i + k] = hv[k];
  }
}

}  // namespace

extern "C" int voxt_bit_dda(const void* top, int top_words,
                            const void* regions, const void* bricks, int size,
                            const void* start, const void* dir,
                            const void* distance, const void* active,
                            int skip_t0, void* hit, void* t, void* normal,
                            void* voxel, int n, void* stream) {
  if (n <= 0) return 0;
  if (size < 128 || (size & (size - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  const DdaArgs a{(const unsigned*)top,    (const unsigned*)regions,
                  (const unsigned*)bricks, (const float*)start,
                  (const float*)dir,       (const float*)distance,
                  (const bool*)active,     top_words,
                  size,                    skip_t0,
                  n,                       (bool*)hit,
                  (float*)t,               (float*)normal,
                  (int*)voxel};
  bit_dda_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                   (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
