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
// What bounds it on the card: dependent gathers. Every descend step reads
// one 32-byte node row whose address depends on the previous read, and a
// ray takes hundreds of steps. Design: one thread per ray; all per-level
// geometry is recomputed from the three bit-words (~20 flops) instead of
// being stacked per level, so the only per-level state is the node stack
// (at most 16 ints, local memory) and each step costs one row read. The
// table is small against the 50 MB L2 (187,832 rows = 6 MB at 1024^3).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1.0e-6f;  // raytrace.wgsl:53
constexpr int kMaxStack = 16;    // height <= 15

__global__ void svo_cast_kernel(const int* __restrict__ table, int root,
                                int H, const float* __restrict__ start,
                                const float* __restrict__ dir,
                                const float* __restrict__ distance,
                                const bool* __restrict__ active, int skip_t0,
                                bool* __restrict__ hit_out,
                                float* __restrict__ t_out,
                                int* __restrict__ node_out,
                                float* __restrict__ normal_out,
                                int* __restrict__ voxel_out, int n) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  const float bound = (float)(1 << H);
  float s0[3], inv[3], sgn[3];
  int mirror = 0;
  for (int a = 0; a < 3; ++a) {
    const float d = dir[3 * i + a];
    const float s = start[3 * i + a];
    const bool flip = d < 0.0f;
    sgn[a] = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
    mirror |= (int)flip << a;
    inv[a] = 1.0f / fmaxf(fabsf(d), kEps);
    s0[a] = flip ? bound - s : s;
  }
  const float dist = distance[i];

  float enter[3];
  for (int a = 0; a < 3; ++a) enter[a] = -s0[a] * inv[a];
  float t = fmaxf(fmaxf(fmaxf(enter[0], enter[1]), enter[2]), 0.0f);
  int axis = enter[0] == t ? 0 : (enter[1] == t ? 1 : (enter[2] == t ? 2 : 3));

  float tend_root = fminf(fminf((bound - s0[0]) * inv[0],
                                (bound - s0[1]) * inv[1]),
                          (bound - s0[2]) * inv[2]);
  tend_root = fminf(tend_root, dist);
  const float half_root = (float)(1 << (H - 1));
  int words[3];
  for (int a = 0; a < 3; ++a)
    words[a] = (int)(((half_root - s0[a]) * inv[a]) < t) << (H - 1);

  bool alive = root >= 0 && tend_root >= t;
  if (active != nullptr) alive = alive && active[i];

  int stk[kMaxStack];
  for (int l = 0; l <= H; ++l) stk[l] = -1;
  stk[H] = root;
  int h = H - 1;

  bool hit = false;
  float hit_t = 0.0f;
  int hit_node = -1, hit_axis = 3;
  int vox[3] = {0, 0, 0};

  while (alive) {
    const bool descend = stk[h] == -1;
    const int low_mask = (1 << h) - 1;
    int off_i[3];
    float tmid[3], tend_ax[3];
    const float cell = ldexpf(1.0f, h);  // 2^h exactly
    const float mid = cell * 0.5f;
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
      const int parent = stk[h + 1 <= H ? h + 1 : H];
      int child_idx = 0;
      for (int a = 0; a < 3; ++a) child_idx |= ((words[a] >> h) & 1) << a;
      child_idx ^= mirror;
      const int child = parent >= 0 ? table[parent * 8 + child_idx] : -1;
      if (child == -1) {
        h += 1;  // pop
      } else if (h == 0) {
        if (skip_t0 && t == 0.0f) {
          h += 1;  // camera inside a solid: skip the hit at t == 0
        } else {
          hit = true;
          hit_t = t;
          hit_node = child;
          hit_axis = axis;
          for (int a = 0; a < 3; ++a)
            vox[a] = ((mirror >> a) & 1) ? (1 << H) - off_i[a] - 1 : off_i[a];
          break;
        }
      } else {
        // push: the child's subvoxel bits (tmid < t) go to word bit h-1
        const int bit = 1 << (h - 1);
        for (int a = 0; a < 3; ++a)
          words[a] = (words[a] & ~bit) | (tmid[a] < t ? bit : 0);
        stk[h] = child;
        stk[h - 1] = -1;
        h -= 1;
      }
    } else {
      // advance: the next midplane crossing, or leave the cell
      const int hm1 = h - 1 > 0 ? h - 1 : 0;
      float t_next[3];
      for (int a = 0; a < 3; ++a)
        t_next[a] = ((words[a] >> hm1) & 1) ? tend : tmid[a];
      const float m = fminf(fminf(t_next[0], t_next[1]), t_next[2]);
      if (m == tend) {
        h += 1;  // pop
      } else {
        const int ax = t_next[0] == m ? 0 : (t_next[1] == m ? 1 : 2);
        words[ax] |= 1 << hm1;
        t = m;
        axis = ax;
        stk[hm1] = -1;
        h -= 1;
      }
    }
    alive = h <= H;
  }

  hit_out[i] = hit;
  t_out[i] = hit_t;
  node_out[i] = hit_node;
  for (int a = 0; a < 3; ++a) {
    normal_out[3 * i + a] = (hit_axis == a ? -sgn[a] : 0.0f) * (hit ? 1.0f : 0.0f);
    voxel_out[3 * i + a] = vox[a];
  }
}

}  // namespace

extern "C" int voxt_svo_cast(const void* table, int root, int height,
                             const void* start, const void* dir,
                             const void* distance, const void* active,
                             int skip_t0, void* hit, void* t, void* node,
                             void* normal, void* voxel, int n, void* stream) {
  if (n <= 0) return 0;
  const int threads = 128;
  const int blocks = (n + threads - 1) / threads;
  svo_cast_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int*)table, root, height, (const float*)start, (const float*)dir,
      (const float*)distance, (const bool*)active, skip_t0, (bool*)hit,
      (float*)t, (int*)node, (float*)normal, (int*)voxel, n);
  return (int)cudaGetLastError();
}
