// K9: the path integrator's bounce loop, one thread a path.
//
// Replaces: voxtracer/kernels/integrator.py, trace_paths (the jnp bounce
// loop at :212-560 with its compaction unwind; on the TPU a wavefront of
// XLA ops around the Pallas fog march, no kernel of its own). Same
// arithmetic, operation for operation, as the masked loop
// trace_paths_plain in voxtracer_torch/kernels/integrator.py: every float
// operation in its order, rounded in float32 on its own (built with
// --fmad=false; square roots and divisions correctly rounded; logf, sinf,
// cosf and expf the libdevice functions torch's CUDA ops call), the
// constants folded by the wrapper exactly as the plain version folds them.
// So radiance and the returned RNG state equal the masked loop's in every
// lane.
//
// Per bounce of a path (the module doc of integrator.py): the planet cast
// (a free path, K1's march, a scatter direction); the world cast capped
// at the fog event (K4's walk on the heightfield engine, K2's on the SVO
// engine, K4's then a slab test against the edit boxes and K2's re-cast
// on the edited heightfield), the nearer event winning by t <= cap, or on
// bounce 0 the given primary hit; the sun disk on bounce 0; next-event
// estimation (sample_sun, the facing test, the planet cast toward the
// sun, the shadow cast for live, facing lanes the planet left open); the
// emissive rule; the cosine-hemisphere bounce; Russian roulette. The
// walks are the device functions of fog_walk.cuh, svo_walk.cuh and
// hf_walk.cuh, the bodies of K1, K2 and K4.
//
// Draws: each bounce draws 11 random3 whatever the masks say (planet 3,
// sun 2, planet 3, hemisphere 2, roulette 1). The masked loop runs N
// bounces, N the last bounce any path lives through, plus one; a path
// that ends after bounce j here has drawn 11 (j + 1) times. So each path
// records j, the kernel takes the batch's largest j (one atomic a warp),
// and a second, small pass (path_burn_kernel) advances each path's state
// by the 11 (N - j - 1) draws it skipped, and by `extra_draws` more (3
// with the fused bounce/NEE, whose returned state carries one more planet
// draw).
//
// What bounds it on the card: the walks' dependent loads and their
// divergence, as for K1, K2 and K4 alone: a path is 2 fog marches (up to
// fog_steps segments, an IEEE sqrt and exp each) and 1-3 walks (tens to
// hundreds of steps) a bounce, and the paths of a warp live 1 to 24
// bounces. The bytes are few (a path reads 52 bytes and writes 28, the
// pack or the node table stays in L2).
//
// Design: one thread a path, the path's state (position, direction,
// throughput, radiance, RNG state: 16 words) in registers across its
// bounces; each walk runs to its end inside the bounce, so only one
// walker's state is live at a time. Threads claim paths through the
// persistent lane fetch of lanes.cuh, one bounce a step: a thread whose
// path ends takes the next one at the next look at its warp, so a warp
// does not wait on its longest path. The SVO walks keep their node stack
// in shared memory laid out [level][thread] as K2 does; the heightfield's
// row starts and the fog march's segment fractions are per block in
// shared memory. No host read: the burn pass reads N on the card.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fog_walk.cuh"
#include "hf_walk.cuh"
#include "lanes.cuh"
#include "svo_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBounceDraws = 11;
constexpr int kBurnThreads = 256;
enum Engine { kHf = 0, kSvo = 1, kEdited = 2 };
constexpr int kSvoMaxHeight = 15;  // traverse.MAX_HEIGHT

// float32 constants in the order of integrator.py's _K9_CONSTS, each the
// float the plain version rounds its Python expression to
struct PathConsts {
  float far, nee_near, cos_sun, sun_span, pi, sun_weight, sun_color, brdf,
      brdf_pi, rr, rr_scale, emissive, eps, planet_r, planet_r2, fog_r2,
      fog_factor;
  float ground[4], fog[4];
};

struct PathArgs {
  PathConsts c;
  voxt::HfPack hf;
  const int* table;
  int root, height;
  const float* boxes;  // (n_boxes, 2, 3) [lo, hi) of the edited engine
  int n_boxes;
  const float* trgb;  // (3,) terrain colour
  const float* sun;   // (3,) unit sun direction
  const float* pos;
  const float* dir;
  const float* light;
  const float* density;
  const unsigned* state_in;
  const bool* p_hit;  // bounce 0's primary hits, or nullptr
  const float* p_t;
  const float* p_normal;
  const float* p_rgb;
  float* color_out;
  unsigned* state_out;
  int* last;      // each path's last bounce
  int* max_last;  // the batch's largest, 0 at launch
  // the run's work, 0 at launch: heightfield walk steps, SVO walk steps,
  // fog segments, bounces
  unsigned long long* work;
  int max_bounces, fog_steps;
};

__device__ __forceinline__ void pcg3d(unsigned* s) {
  unsigned x = s[0] * 1664525u + 1013904223u;
  unsigned y = s[1] * 1664525u + 1013904223u;
  unsigned z = s[2] * 1664525u + 1013904223u;
  x += y * z;
  y += x * z;
  z += y * x;
  x ^= x >> 16;
  y ^= y >> 16;
  z ^= z >> 16;
  x += y * z;
  y += x * z;
  z += y * x;
  s[0] = x;
  s[1] = y;
  s[2] = z;
}

// rng.random3: advance, then the top 16 bits over 65536
__device__ __forceinline__ void random3(unsigned* s, float* r) {
  pcg3d(s);
#pragma unroll
  for (int k = 0; k < 3; ++k) r[k] = (float)(s[k] >> 16) / 65536.0f;
}

// torch.clamp_min on the card: NaN passes, else the larger
__device__ __forceinline__ float clamp_min(float v, float lo) {
  return v != v ? v : fmaxf(v, lo);
}

__device__ __forceinline__ float dot3(const float* a, const float* b) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}

__device__ __forceinline__ void cross3(const float* a, const float* b,
                                       float* out) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

__device__ __forceinline__ void normalize3(float* a) {
  const float len = sqrtf(dot3(a, a));
#pragma unroll
  for (int k = 0; k < 3; ++k) a[k] = a[k] / len;
}

// A walk's ray and result, in registers (the Io of svo_walk.cuh and
// hf_walk.cuh)
struct RayIo {
  float o[3], dv[3], dist;
  bool hit;
  float t;
  int node;
  float normal[3];

  __device__ __forceinline__ float origin(int k) const { return o[k]; }
  __device__ __forceinline__ float dir(int k) const { return dv[k]; }
  __device__ __forceinline__ float distance() const { return dist; }
  __device__ __forceinline__ float t_min(float t0) const { return t0; }
  __device__ __forceinline__ void finish(bool h, float tt, int nd,
                                         const float* n, const int*) {
    hit = h;
    t = tt;
    node = nd;
#pragma unroll
    for (int k = 0; k < 3; ++k) normal[k] = n[k];
  }
  __device__ __forceinline__ void finish(bool h, float tt, const float* n,
                                         int, int, int) {
    finish(h, tt, -1, n, nullptr);
  }
};

__device__ __forceinline__ RayIo ray_io(const float* p, const float* d,
                                        float dist) {
  RayIo io;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    io.o[k] = p[k];
    io.dv[k] = d[k];
  }
  io.dist = dist;
  return io;
}

// The world casts of engine E (tile log TL for the heightfield engines)
template <int E, int TL>
struct World {
  const PathArgs& a;
  const int* rows;  // the pack's row starts, in shared memory
  int* stk;         // this thread's SVO node stack, level l at l * blockDim.x
  unsigned hf_steps, svo_steps;  // this thread's walk steps

  __device__ __forceinline__ RayIo svo(const float* p, const float* d,
                                       float dist) {
    voxt::SvoWalk<RayIo> w;
    w.table = a.table;
    w.stk = stk;
    w.stride = blockDim.x;
    w.root = a.root;
    w.H = a.height;
    w.skip_t0 = 1;
    w.io = ray_io(p, d, dist);
    if (w.begin())
      do {
        ++svo_steps;
      } while (w.step());
    return w.io;
  }

  __device__ __forceinline__ RayIo hf(const float* p, const float* d,
                                      float dist) {
    voxt::HfWalk<TL, RayIo> w{a.hf, rows, ray_io(p, d, dist)};
    if (w.begin())
      do {
        ++hf_steps;
      } while (w.step());
    return w.io;
  }

  // the leaf's albedo (traverse.leaf_rgb): float bits in columns 0..2
  __device__ __forceinline__ float leaf(int node, int k) const {
    return node >= 0 ? __int_as_float(__ldg(a.table + node * 8 + k)) : 0.0f;
  }

  // hf_raycast_edited: whether the ray reaches some edit box no later
  // than the pre-edit walk's result (hit1, t1)
  __device__ __forceinline__ bool affected(const float* p, const float* d,
                                           bool hit1, float t1) const {
    const float inf = __int_as_float(0x7f800000);
    bool any = false;
    for (int b = 0; b < a.n_boxes; ++b) {
      const float* lo = a.boxes + 6 * b;
      const float* hi = lo + 3;
      float t_en = -inf, t_ex = inf;
      bool par_ok = true;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const bool par = fabsf(d[k]) < a.c.eps;
        const float inv = 1.0f / (par ? a.c.eps : d[k]);
        const float l = __ldg(lo + k), h = __ldg(hi + k);
        const float ta = (l - p[k]) * inv;
        const float tb = (h - p[k]) * inv;
        const float mn = par ? -inf : fminf(ta, tb);
        const float mx = par ? inf : fmaxf(ta, tb);
        t_en = fmaxf(t_en, mn);
        t_ex = fminf(t_ex, mx);
        par_ok = par_ok && (!par || (p[k] >= l && p[k] <= h));
      }
      const bool reaches = t_en <= t_ex && t_ex >= 0.0f && par_ok;
      any = any || (reaches && (!hit1 || fmaxf(t_en, 0.0f) <= t1 + 2.0f));
    }
    return any;
  }

  // the bounce cast capped at `cap`: hit, t, normal and albedo
  __device__ __forceinline__ RayIo cast(const float* p, const float* d,
                                        float cap, float* rgb) {
    RayIo r;
    if (E == kSvo) {
      r = svo(p, d, cap);
#pragma unroll
      for (int k = 0; k < 3; ++k) rgb[k] = leaf(r.node, k);
      return r;
    }
    r = hf(p, d, cap);
#pragma unroll
    for (int k = 0; k < 3; ++k) rgb[k] = __ldg(a.trgb + k);
    if (E == kEdited && affected(p, d, r.hit, r.t)) {
      // re-cast lanes shade by their own leaf
      r = svo(p, d, cap);
      if (r.hit) {
#pragma unroll
        for (int k = 0; k < 3; ++k) rgb[k] = leaf(r.node, k);
      }
    }
    return r;
  }

  // the NEE shadow cast toward the sun: whether the world blocks it
  __device__ __forceinline__ bool occluded(const float* p, const float* d) {
    if (E == kSvo) {
      // two stages as the plain version: capped at NEE_NEAR, then the
      // full cast for the lanes it left open
      if (svo(p, d, a.c.nee_near).hit) return true;
      return svo(p, d, a.c.far).hit;
    }
    const RayIo r = hf(p, d, a.c.far);
    if (E == kEdited && affected(p, d, r.hit, r.t)) return svo(p, d, a.c.far).hit;
    return r.hit;
  }
};

// One path a thread (the lane-fetch face, lanes.cuh): start loads a path,
// step runs one bounce.
template <int E, int TL>
struct PathRay {
  const PathArgs& a;
  World<E, TL> world;
  voxt::FogWalk fog;  // the march's launch-wide part
  int max_last;       // the largest last bounce of this thread's paths
  unsigned fog_segs, bounces;  // this thread's march segments and bounces
  // the path in flight
  int i, bounce;
  float pos[3], d[3], light[3], color[3], density;
  unsigned st[3];

  __device__ __forceinline__ void skip(int, unsigned) {}  // no masked lanes

  __device__ __forceinline__ bool start(int lane_index) {
    i = lane_index;
    bounce = 0;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      pos[k] = __ldg(a.pos + 3 * i + k);
      d[k] = __ldg(a.dir + 3 * i + k);
      light[k] = __ldg(a.light + 3 * i + k);
      color[k] = 0.0f;
      st[k] = __ldg(a.state_in + 3 * i + k);
    }
    density = __ldg(a.density + i);
    return true;
  }

  __device__ __forceinline__ bool finish() {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.color_out[3 * i + k] = color[k];
      a.state_out[3 * i + k] = st[k];
    }
    a.last[i] = bounce - 1;
    max_last = max(max_last, bounce - 1);
    return false;
  }

  // K1's march of (p, dv) with free path y0: code 0 miss / 1 planet /
  // 2 fog, and t
  __device__ __forceinline__ int march(const float* p, const float* dv,
                                       float y0, float* t) {
    voxt::FogWalk w = fog;
    if (w.begin(p[0], p[1], p[2], dv[0], dv[1], dv[2], density, y0))
      do {
        ++fog_segs;
      } while (w.step());
    *t = w.t;
    return w.code;
  }

  // sampling.cos_hemisphere around n from its two draws r1, r2
  __device__ __forceinline__ void hemisphere(const float* r1, const float* r2,
                                             const float* n,
                                             float* out) const {
    const float r = sqrtf(r1[0]);
    const float angle = r1[1] * 2.0f * a.c.pi;
    const float px = r * cosf(angle);
    const float py = r * sinf(angle);
    float b[3], t[3], disk[3];
    cross3(r2, n, b);
    normalize3(b);
    cross3(b, n, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) disk[k] = t[k] * px + b[k] * py;
    const float d2 = dot3(disk, disk);
    const float up = sqrtf(clamp_min(1.0f - d2, 0.0f));
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = disk[k] + n[k] * up;
  }

  // sampling.sample_sun: a direction in the sun cone (2 draws)
  __device__ __forceinline__ void sample_sun(const float* sun, float* out) {
    float r[3], r2[3];
    random3(st, r);
    const float z = r[0] * a.c.sun_span + a.c.cos_sun;
    const float angle = r[1] * 2.0f * a.c.pi;
    const float s = sqrtf(clamp_min(1.0f - z * z, 0.0f));
    const float px = cosf(angle) * s;
    const float py = sinf(angle) * s;
    random3(st, r2);
    float b[3], t[3];
    cross3(r2, sun, b);
    normalize3(b);
    cross3(b, sun, t);
#pragma unroll
    for (int k = 0; k < 3; ++k) out[k] = t[k] * px + b[k] * py + sun[k] * z;
  }

  __device__ __forceinline__ bool step() {
    const PathConsts& c = a.c;
    float sun[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) sun[k] = __ldg(a.sun + k);

    // the planet cast along d (atmosphere.raycast_planet: 3 draws)
    float r[3], r1[3], r2[3];
    random3(st, r);
    float pt;
    const int code = march(pos, d, -logf(1.0f - r[0]), &pt);
    random3(st, r1);
    random3(st, r2);
    float p_normal[3] = {0.0f, 0.0f, 0.0f};
    if (code == 1) {
      const float po[3] = {pos[0] + 0.0f, pos[1] + c.planet_r, pos[2] + 0.0f};
#pragma unroll
      for (int k = 0; k < 3; ++k) p_normal[k] = po[k] + d[k] * pt;
      normalize3(p_normal);
    } else if (code == 2) {
      hemisphere(r1, r2, d, p_normal);
    }
    const bool p_hit = code > 0;
    const float cap = p_hit ? pt : c.far;

    // the world, capped at the fog event; bounce 0 may take the primary
    RayIo w;
    float w_rgb[3];
    if (bounce == 0 && a.p_hit != nullptr) {
      w.hit = a.p_hit[i];
      w.t = __ldg(a.p_t + i);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        w.normal[k] = __ldg(a.p_normal + 3 * i + k);
        w_rgb[k] = __ldg(a.p_rgb + 3 * i + k);
      }
    } else {
      w = world.cast(pos, d, cap, w_rgb);
    }
    const bool use_svo = w.hit && w.t <= cap;
    const bool hit_any = p_hit || use_svo;
    float rgba[4], normal[3];
    const float* p_rgba = code == 1 ? c.ground : c.fog;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      rgba[k] = use_svo ? w_rgb[k] : (p_hit ? p_rgba[k] : 0.0f);
      normal[k] = use_svo ? w.normal[k] : p_normal[k];
    }
    rgba[3] = use_svo ? 1.0f : (p_hit ? p_rgba[3] : 0.0f);
    const float t_hit = use_svo ? w.t : pt;

    // a primary ray that misses sees the sun disk
    if (bounce == 0) {
      const bool sun_disk = dot3(d, sun) > c.cos_sun;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        color[k] = color[k] + (!hit_any && sun_disk ? light[k] * c.sun_color
                                                    : 0.0f);
    }
    if (hit_any) {
#pragma unroll
      for (int k = 0; k < 3; ++k) pos[k] = pos[k] + d[k] * t_hit;
    }

    // next-event estimation toward the sun
    float sdir[3];
    sample_sun(sun, sdir);
    const bool facing = dot3(sdir, normal) > 0.0f;
    random3(st, r);
    bool sp_hit = false;
    if (hit_any && facing) {
      float t_unused;
      sp_hit = march(pos, sdir, -logf(1.0f - r[0]), &t_unused) > 0;
    }
    pcg3d(st);  // the sun planet cast's scatter direction (unused)
    pcg3d(st);
    const bool nee_act = hit_any && facing && !sp_hit;
    const bool sun_visible = !sp_hit && !(nee_act && world.occluded(pos, sdir));
    if (hit_any && facing && sun_visible) {
      const float wgt = dot3(normal, sdir) * 2.0f * c.pi * c.sun_weight;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float nee = c.sun_color * rgba[k] * c.brdf * wgt;
        color[k] = color[k] + light[k] * nee;
      }
    }

    // emissive (pure-white placed blocks)
    const bool emissive =
        rgba[0] == 1.0f && rgba[1] == 1.0f && rgba[2] == 1.0f && rgba[3] == 1.0f;
    if (hit_any && emissive) {
#pragma unroll
      for (int k = 0; k < 3; ++k)
        color[k] = color[k] + light[k] * c.emissive * rgba[k] * rgba[3];
    }

    // the indirect bounce
    random3(st, r1);
    random3(st, r2);
    if (hit_any) {
      float ind[3];
      hemisphere(r1, r2, normal, ind);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        light[k] = light[k] * rgba[k] * c.brdf_pi;
        d[k] = ind[k];
      }
    }

    // Russian roulette
    random3(st, r);
    const bool rr_active =
        hit_any && light[0] < c.rr && light[1] < c.rr && light[2] < c.rr;
    const bool survive = r[0] < c.rr;
    if (rr_active && survive) {
#pragma unroll
      for (int k = 0; k < 3; ++k) light[k] = light[k] * c.rr_scale;
    }
    const bool alive = hit_any && (!rr_active || survive);
    ++bounce;
    ++bounces;
    if (alive && bounce < a.max_bounces) return true;
    return finish();
  }
};

template <int E, int TL>
__global__ void __launch_bounds__(kThreads)
    path_trace_kernel(voxt::LaneArgs lanes, __grid_constant__ const PathArgs a) {
  extern __shared__ int smem[];
  __shared__ float frac_a[voxt::kFogMaxSteps + 1];
  __shared__ float frac_b[voxt::kFogMaxSteps + 1];
  __shared__ int s_rows[voxt::kHfMaxLevels];
  voxt::fog_fractions(frac_a, frac_b, a.fog_steps);
  if (E != kSvo && (int)threadIdx.x < a.hf.levels)
    s_rows[threadIdx.x] = __ldg(a.hf.row_start + threadIdx.x);
  __syncthreads();
  const int warps = blockDim.x >> 5;
  PathRay<E, TL> path{a, World<E, TL>{a, s_rows,
                                      smem + warps * voxt::kQueue +
                                          threadIdx.x}};
  path.fog.frac_a = frac_a;
  path.fog.frac_b = frac_b;
  path.fog.n_steps = a.fog_steps;
  path.fog.planet_r = a.c.planet_r;
  path.fog.planet_r2 = a.c.planet_r2;
  path.fog.fog_r2 = a.c.fog_r2;
  path.fog.fog_factor = a.c.fog_factor;
  path.max_last = 0;
  voxt::run_lanes<1>(lanes, smem + (threadIdx.x >> 5) * voxt::kQueue, path);
  // the batch's last bounce and the run's work: one atomic each a warp
  int m = path.max_last;
  unsigned work[4] = {path.world.hf_steps, path.world.svo_steps,
                      path.fog_segs, path.bounces};
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    m = max(m, __shfl_xor_sync(voxt::kFullMask, m, o));
#pragma unroll
    for (int k = 0; k < 4; ++k)
      work[k] += __shfl_xor_sync(voxt::kFullMask, work[k], o);
  }
  if ((threadIdx.x & 31) == 0) {
    atomicMax(a.max_last, m);
#pragma unroll
    for (int k = 0; k < 4; ++k)
      atomicAdd(a.work + k, (unsigned long long)work[k]);
  }
}

// The draws the masked loop makes after a path has ended: 11 a bounce up
// to the batch's last, and `extra` more.
__global__ void __launch_bounds__(kBurnThreads)
    path_burn_kernel(const int* __restrict__ last,
                     const int* __restrict__ max_last,
                     unsigned* __restrict__ state, int n, int extra) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const int draws = kBounceDraws * (*max_last - last[i]) + extra;
  unsigned s[3] = {state[3 * i], state[3 * i + 1], state[3 * i + 2]};
  for (int j = 0; j < draws; ++j) pcg3d(s);
  state[3 * i] = s[0];
  state[3 * i + 1] = s[1];
  state[3 * i + 2] = s[2];
}

template <int E, int TL>
int launch(const PathArgs& a, int n, void* counter, int static_pct,
           int chunk, int refill, int extra, cudaStream_t stream) {
  auto kernel = path_trace_kernel<E, TL>;
  const size_t smem =
      (size_t)(kThreads / 32 * voxt::kQueue +
               (E == kHf ? 0 : (a.height + 1) * kThreads)) *
      sizeof(int);
  int blocks = 0;
  cudaError_t err = voxt::persistent_blocks(kernel, kThreads, smem, n, &blocks);
  if (err != cudaSuccess) return (int)err;
  const voxt::LaneArgs lanes{
      (int*)counter, nullptr, n,
      voxt::lanes_per_warp(n, blocks, kThreads, static_pct), chunk, refill};
  kernel<<<blocks, kThreads, smem, stream>>>(lanes, a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto burn = path_burn_kernel;
  burn<<<(n + kBurnThreads - 1) / kBurnThreads, kBurnThreads, 0, stream>>>(
      a.last, a.max_last, a.state_out, n, extra);
  return (int)cudaGetLastError();
}

template <int E>
int launch_tl(const PathArgs& a, int tile_log, int n, void* counter,
              int static_pct, int chunk, int refill, int extra,
              cudaStream_t s) {
  switch (tile_log) {
    case 1:
      return launch<E, 1>(a, n, counter, static_pct, chunk, refill, extra, s);
    case 2:
      return launch<E, 2>(a, n, counter, static_pct, chunk, refill, extra, s);
    default:
      return launch<E, 3>(a, n, counter, static_pct, chunk, refill, extra, s);
  }
}

}  // namespace

extern "C" int voxt_path_trace(
    const void* consts, int n_consts, int engine, const void* tiles,
    int tile_log, int levels, const void* row_starts, const void* hmax_w,
    const void* table, int root, int height, const void* boxes, int n_boxes,
    const void* trgb, const void* sun, const void* pos, const void* dir,
    const void* light, const void* density, const void* state_in,
    const void* p_hit, const void* p_t, const void* p_normal,
    const void* p_rgb, void* color, void* state_out, void* last,
    void* max_last, void* work, int n, int max_bounces, int fog_steps,
    int extra_draws, void* counter, int static_pct, int chunk, int refill,
    void* stream) {
  if (n <= 0) return 0;
  const bool hf = engine == kHf || engine == kEdited;
  if (n_consts * sizeof(float) != sizeof(PathConsts) || engine < kHf ||
      engine > kEdited || !voxt::valid_fetch(static_pct, chunk, refill) ||
      height < 1 || max_bounces < 1 || fog_steps < 0 ||
      fog_steps > voxt::kFogMaxSteps || extra_draws < 0 ||
      (engine != kHf && height > kSvoMaxHeight) ||
      (hf && (levels < 1 || levels > voxt::kHfMaxLevels || tile_log < 1 ||
              tile_log > 3 || height > 30)) ||
      (engine == kEdited && n_boxes < 1))
    return (int)cudaErrorInvalidValue;
  PathArgs a;
  const float* cf = (const float*)consts;
  float* dst = (float*)&a.c;
  for (int k = 0; k < n_consts; ++k) dst[k] = cf[k];
  a.hf.tiles = (const float*)tiles;
  a.hf.row_start = (const int*)row_starts;
  a.hf.hmax_w = (const float*)hmax_w;
  a.hf.levels = hf ? levels : 0;
  a.hf.H = height;
  a.hf.skip_t0 = 1;
  a.hf.lstart = hf ? voxt::hf_start_level(height, tile_log, 0) : 0;
  a.table = (const int*)table;
  a.root = root;
  a.height = height;
  a.boxes = (const float*)boxes;
  a.n_boxes = n_boxes;
  a.trgb = (const float*)trgb;
  a.sun = (const float*)sun;
  a.pos = (const float*)pos;
  a.dir = (const float*)dir;
  a.light = (const float*)light;
  a.density = (const float*)density;
  a.state_in = (const unsigned*)state_in;
  a.p_hit = (const bool*)p_hit;
  a.p_t = (const float*)p_t;
  a.p_normal = (const float*)p_normal;
  a.p_rgb = (const float*)p_rgb;
  a.color_out = (float*)color;
  a.state_out = (unsigned*)state_out;
  a.last = (int*)last;
  a.max_last = (int*)max_last;
  a.work = (unsigned long long*)work;
  a.max_bounces = max_bounces;
  a.fog_steps = fog_steps;
  const cudaStream_t s = (cudaStream_t)stream;
  switch (engine) {
    case kHf:
      return launch_tl<kHf>(a, tile_log, n, counter, static_pct, chunk,
                            refill, extra_draws, s);
    case kSvo:
      return launch<kSvo, 3>(a, n, counter, static_pct, chunk, refill,
                             extra_draws, s);
    default:
      return launch_tl<kEdited>(a, tile_log, n, counter, static_pct, chunk,
                                refill, extra_draws, s);
  }
}
