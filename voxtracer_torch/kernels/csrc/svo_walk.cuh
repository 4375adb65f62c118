// The SVO walk of one ray: the body of K2 (svo_cast.cu), which K9
// (path_trace.cu) runs as a device function for the SVO engine's casts
// and the edited heightfield's re-casts. svo_cast.cu's note says what it
// computes and why it is written so; this header holds the one copy of its
// arithmetic.

#pragma once

#include <cuda_runtime.h>

namespace voxt {

constexpr float kSvoEps = 1.0e-6f;  // raytrace.wgsl:53

// The walk of one ray through the node table. Io gives the ray and takes
// the result:
//   float origin(int a), dir(int a), distance(): the ray and its advisory
//       cap;
//   void finish(bool hit, float t, int node, const float* normal,
//       const int* voxel): the five outputs.
// begin() sets the ray up and returns false once it has finished; step()
// takes one loop step and returns false once it has. The node stack lives
// where `stk` points, level l at stk[l * stride].
template <class Io>
struct SvoWalk {
  // launch-wide
  const int* __restrict__ table;
  int* stk;
  int stride, root, H, skip_t0;
  Io io;
  // the ray in flight
  int h, axis, mirror, pos;
  int words[3];
  float s0[3], inv[3];
  float dist, t;

  __device__ __forceinline__ bool finish(bool hit, float hit_t, int hit_node,
                                         int hit_axis, const int* vox) {
    float normal[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float sgn = ((pos >> a) & 1) ? 1.0f
                                         : (((mirror >> a) & 1) ? -1.0f : 0.0f);
      normal[a] = (hit_axis == a ? -sgn : 0.0f) * (hit ? 1.0f : 0.0f);
    }
    io.finish(hit, hit_t, hit_node, normal, vox);
    return false;
  }

  __device__ __forceinline__ bool miss() {
    const int vox[3] = {0, 0, 0};
    return finish(false, 0.0f, -1, 3, vox);
  }

  __device__ __forceinline__ bool begin() {
    const float bound = (float)(1 << H);
    mirror = 0;
    pos = 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const float d = io.dir(a);
      const float s = io.origin(a);
      const bool flip = d < 0.0f;
      pos |= (int)(d > 0.0f) << a;
      mirror |= (int)flip << a;
      inv[a] = 1.0f / fmaxf(fabsf(d), kSvoEps);
      s0[a] = flip ? bound - s : s;
    }
    dist = io.distance();

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

    if (!(root >= 0 && tend_root >= t)) return miss();
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
          return finish(true, t, child, axis, vox);
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
    return miss();
  }
};

}  // namespace voxt
