// K9: the path integrator's bounce loop, as stage kernels over compacted
// path queues on the card (a wavefront).
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
// on the edited heightfield, K8's on the bit-grid engine with the hit's
// albedo from one descent of the node table), the nearer event winning
// by t <= cap, or on bounce 0 the given primary hit; the sun disk on
// bounce 0; next-event estimation (sample_sun, the facing test, the
// planet cast toward the sun, the shadow cast for live, facing lanes the
// planet left open and, on the unedited heightfield with sun maps, the
// maps do not prove lit: sunshadow.sun_clear's two reads, which take no
// draw); the emissive rule; the cosine-hemisphere bounce; Russian
// roulette. The walks are the device functions of fog_walk.cuh,
// svo_walk.cuh, hf_walk.cuh and bit_walk.cuh, the bodies of K1, K2, K4
// and K8, so every engine and option of the masked loop runs here.
//
// Draws: each bounce draws 11 random3 whatever the masks say (planet 3,
// sun 2, planet 3, hemisphere 2, roulette 1). The masked loop runs N
// bounces, N the last bounce any path lives through, plus one; a path
// that ends after bounce j here has drawn 11 (j + 1) times. So each path
// records j, the batch's largest j is kept with one atomic a warp, and a
// last, small pass (path_burn_kernel) advances each path's state by the
// 11 (N - j - 1) draws it skipped, and by `extra_draws` more (3 with the
// fused bounce/NEE, whose returned state carries one more planet draw).
//
// What bounds it on the card: the walks' dependent loads and their
// divergence. A path is 2 fog marches (up to fog_steps segments, an IEEE
// sqrt and exp each) and 1-3 walks (tens to hundreds of steps) a bounce,
// and the paths of a warp live 1 to 24 bounces. Run in one thread a path
// (this kernel's first form), a warp waits on its longest lane in each of
// the four loops of a bounce: counted on the card, its world and shadow
// casts ran at 10-31% SIMT efficiency and took three quarters of its
// cycles, and most fog segments it marched belonged to marches that never
// scatter.
//
// Design (Laine, Karras and Aila, "Megakernels Considered Harmful", HPG
// 2013): the path state lives in device memory, one array a component
// (structure of arrays, indexed by path), and each loop of a bounce is its
// own persistent kernel over a queue of the paths that need it, so its
// lanes are packed into full warps and refilled every few steps (the lane
// fetch of lanes.cuh, as K1, K2 and K4 standalone); the fixed logic
// between the loops runs in kernels whose warps take 32 queue entries at
// a time. Per bounce b:
//   path_bounce_kernel(b): ends bounce b-1 of the live paths (the NEE
//       term, the emissive rule, the hemisphere bounce, roulette; a path
//       that ends writes its colour, state and last bounce) and begins
//       bounce b of the survivors (the planet draw, the march set up, and
//       the scatter-free test of fog_walk.cuh): every survivor goes to
//       the live queue, and a march the test does not settle to the march
//       queue;
//   path_march_kernel<false>: K1's march over the march queue;
//   path_cast_kernel: the world cast over the live queue (none for
//       bounce 0's lanes with a primary hit), its result to the state; on
//       the edited engine a ray that reaches an edit box goes to the
//       re-cast queue, and path_recast_kernel<false> casts those on the
//       SVO;
//   path_shade_kernel: the fixed logic up to the sun march: the two
//       scatter-direction draws, the planet normal, the nearer event, the
//       sun disk, the move to the hit, sample_sun, the facing test, the
//       sun march's draw set up and tested, the sun maps' test, and the
//       2 unused draws; a sun march the test does not settle goes to the
//       sun-march queue, a live, facing lane the test leaves open and
//       the maps do not prove lit to the shadow queue;
//   path_march_kernel<true>: the sun march over its queue; the lanes it
//       leaves open and the maps do not prove lit go to the shadow queue;
//   path_shadow_kernel: the shadow cast over the shadow queue (the SVO
//       engine's two stages, one uncapped walk on the others; on the
//       edited engine the slab test, and path_recast_kernel<true>
//       re-casts the rays that reach a box).
// One last path_bounce_kernel ends the last bounce. Which thread runs a
// path changes, and when; the arithmetic of a path does not. Queue
// lengths and the lane-fetch claim counters stay on the card (a zeroed
// block of int32, kCounters a bounce); every stage is launched for every
// bounce and one whose queue is empty returns at once, so there is no
// host read. Appends go a warp at a time (a ballot, one atomicAdd), so
// neighbouring paths stay neighbours; a walk stage appends at the lane
// fetch's flush points, where its warp meets. The SVO walks keep their
// node stack in shared memory laid out [level][thread] as K2 does; the
// heightfield's row starts and the fog march's segment fractions are per
// block in shared memory. Two things the first timed runs taught (PERF.md
// section 6): the fixed logic after a walk, run by each lane as its walk
// ended, ran at a few lanes a warp and took most of the cast's time, so
// it is a kernel of its own; and counting SIMT steps in the walk stages
// (kStats) made the heightfield walks several times slower, so that count
// is a second build of the stages, launched for measurement only.

#include <cuda_runtime.h>
#include <stdint.h>

#include "bit_walk.cuh"
#include "fog_walk.cuh"
#include "hf_walk.cuh"
#include "lanes.cuh"
#include "svo_walk.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kBounceDraws = 11;
constexpr int kBurnThreads = 256;
constexpr int kMarchSteps = 16;  // segments between two looks (K1's)
constexpr int kWalkSteps = 8;    // walk steps between two looks (K2's, K4's)
constexpr int kHf = 0, kSvo = 1, kEdited = 2, kBit = 3;  // engines
constexpr int kSvoMaxHeight = 15;  // traverse.MAX_HEIGHT

// A bounce's counters: the lengths of its six queues and the claim
// counters of its six lane-fetch stages
constexpr int kLive = 0, kMarch = 1, kSunMarch = 2, kShadow = 3, kRecast = 4,
              kShadowRecast = 5, kClaims = 6, kCounters = 12;
// The lane-fetch stages: the march, the world cast, the sun march, the
// shadow cast, and the edited engine's SVO re-casts of each cast
constexpr int kStageMarch = 0, kStageCast = 1, kStageSunMarch = 2,
              kStageShadow = 3, kStageRecast = 4, kStageShadowRecast = 5,
              kStages = 6;
// The work counted (uint64, integrator.K9_WORK's order): walk steps by
// walk, fog segments marched, bounces; marches set up and settled by the
// scatter-free test, of the bounce and of the sun; the live, facing lanes
// that the sun planet cast left open and the sun maps proved lit; with
// stats on, each lane-fetch stage's lane steps and warp steps
constexpr int kHfSteps = 0, kSvoSteps = 1, kBitSteps = 2, kSegments = 3,
              kBounces = 4, kMarches = 5, kMarchesFree = 6, kSunMarches = 7,
              kSunMarchesFree = 8, kSunLit = 9, kLaneSteps = 10,
              kWarpSteps = kLaneSteps + kStages,
              kWork = kWarpSteps + kStages;
// The path state: float arrays, int arrays and queues of n entries each
// (structure of arrays: a queue keeps its paths in about their order, so
// a warp's loads of one field fall on few lines; a 128-byte record a
// path made the walk stages faster and the bounce and shade kernels,
// which read and write most fields, slower: PERF.md section 6)
constexpr int fPos = 0, fDir = 3, fLight = 6, fColor = 9, fNormal = 12,
              fRgba = 15, fSdir = 19, fPt = 22, fY0 = 23, fWt = 24,
              kFloatFields = 25;
constexpr int iSt = 0, iCode = 3, iFlags = 4, kIntFields = 5;
constexpr int qLive = 0, qMarch = 2, qSunMarch = 3, qShadow = 4,
              qRecast = 5, qShadowRecast = 6, kQueueFields = 7;
constexpr int kWordsPerPath = kFloatFields + kIntFields + kQueueFields;
// a path's bounce flags: hit, facing the sun, the sun march hit,
// occluded; the world cast's hit (for path_shade_kernel); the sun maps
// prove the lane lit
constexpr unsigned kHit = 1, kFacing = 2, kSunHit = 4, kOccluded = 8,
                   kWorldHit = 16, kLit = 32;

// float32 constants in the order of integrator.py's _K9_CONSTS, each the
// float the plain version rounds its Python expression to
struct PathConsts {
  float far, nee_near, cos_sun, sun_span, pi, sun_weight, sun_color, brdf,
      brdf_pi, rr, rr_scale, emissive, eps, planet_r, planet_r2, fog_r2,
      fog_factor;
  float ground[4], fog[4];
};

// sunshadow.build's threshold maps of this (world, sun), for the unedited
// heightfield engine (t_near null: no maps)
struct SunMaps {
  const float* t_near;  // (rn, rn), indexed by sub-column floor(x * subres)
  const float* t_far;   // (k, k), by sub-column / (subres * pool)
  float subres;         // a power of two, so x * subres is exact
  int rn, k, div;       // div = subres * pool
};

// sunshadow.sun_clear: whether the maps prove that no terrain blocks any
// sun-cone ray from p (two reads; a lane outside the map is not proved)
__device__ __forceinline__ bool sun_clear(const SunMaps& m, const float* p) {
  const float fx = floorf(p[0] * m.subres), fz = floorf(p[2] * m.subres);
  const float rn = (float)m.rn;
  if (!(fx >= 0.0f && fx < rn && fz >= 0.0f && fz < rn)) return false;
  const int sx = (int)fx, sz = (int)fz;
  const float tn = __ldg(m.t_near + (size_t)sx * m.rn + sz);
  const float tf = __ldg(m.t_far + (size_t)(sx / m.div) * m.k + sz / m.div);
  return p[1] > tn && p[1] > tf;
}

struct PathArgs {
  PathConsts c;
  voxt::HfPack hf;
  voxt::BitGrid bit;  // the bit-grid engine's pyramid
  SunMaps maps;
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
  unsigned long long* work;  // kWork counts, 0 at launch
  // the path state (kWordsPerPath words a path) and the counters
  float* f;
  unsigned* u;
  int* q;
  int* counters;
  int n, max_bounces, fog_steps, static_pct, chunk, refill;

  __device__ __forceinline__ float& F(int field, int i) const {
    return f[(size_t)field * n + i];
  }
  __device__ __forceinline__ unsigned& U(int field, int i) const {
    return u[(size_t)field * n + i];
  }
  __device__ __forceinline__ int* queue(int field) const {
    return q + (size_t)field * n;
  }
  // bounce b's live queue (two buffers in turn)
  __device__ __forceinline__ int* live(int b) const {
    return queue(qLive + (b & 1));
  }
  __device__ __forceinline__ int* counter(int b, int k) const {
    return counters + b * kCounters + k;
  }
  // the lane fetch of a stage over bounce b's queue `k`
  __device__ __forceinline__ voxt::LaneArgs lanes(int b, int k) const {
    return voxt::LaneArgs{counter(b, kClaims + k), nullptr, 0, 0, chunk,
                          refill, counter(b, k), static_pct};
  }
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

// sampling.cos_hemisphere around n from its two draws r1, r2
__device__ __forceinline__ void hemisphere(const PathConsts& c,
                                           const float* r1, const float* r2,
                                           const float* n, float* out) {
  const float r = sqrtf(r1[0]);
  const float angle = r1[1] * 2.0f * c.pi;
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
__device__ __forceinline__ void sample_sun(const PathConsts& c, unsigned* st,
                                           const float* sun, float* out) {
  float r[3], r2[3];
  random3(st, r);
  const float z = r[0] * c.sun_span + c.cos_sun;
  const float angle = r[1] * 2.0f * c.pi;
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

// Appends i to queue q (its length at *len) in the threads where `put`;
// all 32 threads of the warp call it, and its lanes land side by side.
__device__ __forceinline__ void append(int* q, int* len, bool put, int i) {
  const unsigned m = __ballot_sync(voxt::kFullMask, put);
  if (m == 0u) return;
  const int lane = threadIdx.x & 31;
  int base = 0;
  if (lane == 0) base = atomicAdd(len, __popc(m));
  base = __shfl_sync(voxt::kFullMask, base, 0);
  if (put) q[base + __popc(m & ((1u << lane) - 1u))] = i;
}

// Adds the K counts v (one a thread) to work[slot[k]]: one atomic each a
// warp; all 32 threads call it.
template <int K>
__device__ __forceinline__ void add_work(const PathArgs& a, const int* slot,
                                         unsigned* v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < K; ++k)
      v[k] += __shfl_xor_sync(voxt::kFullMask, v[k], o);
  if ((threadIdx.x & 31) == 0)
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (v[k] != 0u) atomicAdd(a.work + slot[k], (unsigned long long)v[k]);
}

// The march's launch-wide part, its segment fractions in shared memory
__device__ __forceinline__ voxt::FogWalk fog_walker(const PathArgs& a,
                                                    const float* frac_a,
                                                    const float* frac_b) {
  voxt::FogWalk w;
  w.frac_a = frac_a;
  w.frac_b = frac_b;
  w.n_steps = a.fog_steps;
  w.planet_r = a.c.planet_r;
  w.planet_r2 = a.c.planet_r2;
  w.fog_r2 = a.c.fog_r2;
  w.fog_factor = a.c.fog_factor;
  return w;
}

// Ends bounce b - 1 of path i (the NEE term, the emissive rule, the
// hemisphere bounce, roulette); returns whether the path lives on into
// bounce b, else writes its colour, state and last bounce.
__device__ __forceinline__ bool end_bounce(const PathArgs& a, int b, int i,
                                           int* max_last) {
  const PathConsts& c = a.c;
  const unsigned flags = a.U(iFlags, i);
  const bool hit_any = flags & kHit, facing = flags & kFacing;
  const bool sun_visible = !(flags & kSunHit) && !(flags & kOccluded);
  float light[3], color[3], rgba[4], normal[3], sdir[3], d[3];
  unsigned st[3];
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    light[k] = a.F(fLight + k, i);
    color[k] = a.F(fColor + k, i);
    normal[k] = a.F(fNormal + k, i);
    sdir[k] = a.F(fSdir + k, i);
    d[k] = a.F(fDir + k, i);
    st[k] = a.U(iSt + k, i);
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) rgba[k] = a.F(fRgba + k, i);
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
  float r[3], r1[3], r2[3];
  random3(st, r1);
  random3(st, r2);
  if (hit_any) {
    float ind[3];
    hemisphere(c, r1, r2, normal, ind);
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
  if (alive && b < a.max_bounces) {
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      a.F(fLight + k, i) = light[k];
      a.F(fColor + k, i) = color[k];
      a.F(fDir + k, i) = d[k];
      a.U(iSt + k, i) = st[k];
    }
    return true;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.color_out[3 * i + k] = color[k];
    a.state_out[3 * i + k] = st[k];
  }
  a.last[i] = b - 1;
  *max_last = max(*max_last, b - 1);
  return false;
}

// Ends bounce b - 1 of the live paths (b > 0) and begins bounce b of the
// survivors (b < max_bounces): the planet cast's free-path draw and its
// march set up; a march the scatter-free test settles writes (code, t)
// here, the others go to the march queue. Bounce 0 loads the paths.
__global__ void __launch_bounds__(kThreads)
    path_bounce_kernel(__grid_constant__ const PathArgs a, int b) {
  __shared__ float frac_a[voxt::kFogMaxSteps + 1];
  __shared__ float frac_b[voxt::kFogMaxSteps + 1];
  voxt::fog_fractions(frac_a, frac_b, a.fog_steps);
  __syncthreads();
  voxt::FogWalk fog = fog_walker(a, frac_a, frac_b);
  const int lane = threadIdx.x & 31;
  const int count = b == 0 ? a.n : *a.counter(b - 1, kLive);
  const int* in = b == 0 ? nullptr : a.live(b - 1);
  int max_last = 0;
  unsigned work[3] = {0u, 0u, 0u};  // bounces, marches, settled marches
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < count;
       base += gridDim.x * blockDim.x) {
    const int j = base + lane;
    int i = 0;
    bool go = false, march = false;
    if (j < count) {
      i = in == nullptr ? j : in[j];
      if (b == 0) {
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          a.F(fPos + k, i) = __ldg(a.pos + 3 * i + k);
          a.F(fDir + k, i) = __ldg(a.dir + 3 * i + k);
          a.F(fLight + k, i) = __ldg(a.light + 3 * i + k);
          a.F(fColor + k, i) = 0.0f;
          a.U(iSt + k, i) = __ldg(a.state_in + 3 * i + k);
        }
        go = true;
      } else {
        ++work[0];
        go = end_bounce(a, b, i, &max_last);
      }
    }
    if (go) {
      // the planet cast along d (atmosphere.raycast_planet): its first draw
      unsigned st[3];
      float r[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) st[k] = a.U(iSt + k, i);
      random3(st, r);
      const float y0 = -logf(1.0f - r[0]);
      voxt::FogWalk w = fog;
      if (w.setup(a.F(fPos, i), a.F(fPos + 1, i), a.F(fPos + 2, i),
                  a.F(fDir, i), a.F(fDir + 1, i), a.F(fDir + 2, i),
                  __ldg(a.density + i), y0)) {
        ++work[1];
        if (w.scatter_free()) {
          ++work[2];
          w.done(w.surf ? 1 : 0, w.surf ? w.t1 : 0.0f);
        } else {
          march = true;
          a.F(fY0, i) = y0;
        }
      }
      if (!march) {
        a.U(iCode, i) = (unsigned)w.code;
        a.F(fPt, i) = w.t;
      }
#pragma unroll
      for (int k = 0; k < 3; ++k) a.U(iSt + k, i) = st[k];
    }
    append(a.live(b), a.counter(b, kLive), go, i);
    append(a.queue(qMarch), a.counter(b, kMarch), march, i);
  }
  // the batch's last bounce and the work: one atomic each a warp
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    max_last = max(max_last, __shfl_xor_sync(voxt::kFullMask, max_last, o));
  if (lane == 0 && max_last > 0) atomicMax(a.max_last, max_last);
  const int slot[3] = {kBounces, kMarches, kMarchesFree};
  add_work<3>(a, slot, work);
}

// K1's march over bounce b's march queue (kSun false: the planet cast
// along d, writing (code, t)) or its sun-march queue (kSun true: a hit
// sets kSunHit, a lane left open goes to the shadow queue unless the sun
// maps prove it lit).
template <bool kSun>
struct MarchRay {
  const PathArgs& a;
  int b;
  voxt::FogWalk w;
  int i, open;
  unsigned segs, lit, lane_steps, warp_steps;

  __device__ __forceinline__ void skip(int, unsigned) {}  // no masked lanes

  __device__ __forceinline__ bool finish() {
    if (!kSun) {
      a.U(iCode, i) = (unsigned)w.code;
      a.F(fPt, i) = w.t;
    } else if (w.code > 0) {
      a.U(iFlags, i) |= kSunHit;
    } else if (a.U(iFlags, i) & kLit) {
      ++lit;
    } else {
      open = i;
    }
    return false;
  }

  __device__ __forceinline__ bool start(int j) {
    i = (kSun ? a.queue(qSunMarch) : a.queue(qMarch))[j];
    const int dir = kSun ? fSdir : fDir;
    if (w.setup(a.F(fPos, i), a.F(fPos + 1, i), a.F(fPos + 2, i),
                a.F(dir, i), a.F(dir + 1, i), a.F(dir + 2, i),
                __ldg(a.density + i), a.F(fY0, i)))
      return true;
    return finish();
  }

  __device__ __forceinline__ bool step() {
    ++segs;
    return w.step() || finish();
  }

  __device__ __forceinline__ void flush() {
    if (kSun) {
      append(a.queue(qShadow), a.counter(b, kShadow), open >= 0, open);
      open = -1;
    }
  }
};

template <bool kSun, bool kStats>
__global__ void __launch_bounds__(kThreads)
    path_march_kernel(__grid_constant__ const PathArgs a, int b) {
  __shared__ float frac_a[voxt::kFogMaxSteps + 1];
  __shared__ float frac_b[voxt::kFogMaxSteps + 1];
  __shared__ int ring[kThreads / 32 * voxt::kQueue];
  voxt::fog_fractions(frac_a, frac_b, a.fog_steps);
  __syncthreads();
  MarchRay<kSun> ray{
      a, b, fog_walker(a, frac_a, frac_b), 0, -1, 0u, 0u, 0u, 0u};
  const voxt::LaneArgs lanes = a.lanes(b, kSun ? kSunMarch : kMarch);
  voxt::run_lanes<kMarchSteps, kStats>(
      lanes, ring + (threadIdx.x >> 5) * voxt::kQueue, ray);
  const int stage = kSun ? kStageSunMarch : kStageMarch;
  const int slot[4] = {kSegments, kSunLit, kLaneSteps + stage,
                       kWarpSteps + stage};
  unsigned work[4] = {ray.segs, ray.lit, ray.lane_steps, ray.warp_steps};
  add_work<4>(a, slot, work);
}

// A walk's ray and result, in registers (the Io of svo_walk.cuh and
// hf_walk.cuh)
struct RayIo {
  float o[3], dv[3], dist;
  bool hit;
  float t;
  int node;
  float normal[3];
  int vox[3];  // the bit walk's hit voxel

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
  __device__ __forceinline__ void finish(bool h, float tt, const float* n,
                                         const int* v) {
    finish(h, tt, -1, n, nullptr);
#pragma unroll
    for (int k = 0; k < 3; ++k) vox[k] = v[k];
  }
};

// The world walk of engine E for one ray at a time, stepped from a
// lane-fetch stage: the heightfield walk (tile log TL) on the heightfield
// engines, the SVO walk (its node stack in shared memory) on the SVO
// engine and in the edited engine's re-casts, the bit walk on the
// bit-grid engine.
template <int E, int TL>
struct Walker {
  static constexpr bool kSvoWalk = E == kSvo;
  static constexpr bool kBitWalk = E == kBit;
  const PathArgs& a;
  voxt::HfWalk<TL, RayIo> hw;
  voxt::SvoWalk<RayIo> sw;
  voxt::BitWalk<RayIo> bw;
  unsigned steps;
  // the edited engine's slab test of the ray, taken as the walk begins:
  // whether it reaches an edit box, and the least such entry max(t_en, 0)
  bool box_any;
  float box_t;

  __device__ __forceinline__ Walker(const PathArgs& args, const int* rows,
                                    int* stk)
      : a(args), hw{args.hf, rows, RayIo{}}, bw{args.bit, RayIo{}},
        steps(0u) {
    sw.table = args.table;
    sw.stk = stk;
    sw.stride = blockDim.x;
    sw.root = args.root;
    sw.H = args.height;
    sw.skip_t0 = 1;
  }

  __device__ __forceinline__ RayIo& io() {
    return kSvoWalk ? sw.io : (kBitWalk ? bw.io : hw.io);
  }

  // starts a walk of (p, d) capped at dist; false once it has ended
  __device__ __forceinline__ bool begin(const float* p, const float* d,
                                        float dist) {
    RayIo& r = io();
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      r.o[k] = p[k];
      r.dv[k] = d[k];
    }
    r.dist = dist;
    if (E == kEdited) slab(p, d);
    return kSvoWalk ? sw.begin() : (kBitWalk ? bw.begin() : hw.begin());
  }

  __device__ __forceinline__ bool step() {
    ++steps;
    return kSvoWalk ? sw.step() : (kBitWalk ? bw.step() : hw.step());
  }

  // the leaf's albedo (traverse.leaf_rgb): float bits in columns 0..2
  __device__ __forceinline__ float leaf(int node, int k) const {
    return node >= 0 ? __int_as_float(__ldg(a.table + node * 8 + k)) : 0.0f;
  }

  // bitdda.svo_color_at's node of voxel v: one descent of `height` levels
  // through the node table (integers only; a missing child gives -1)
  __device__ __forceinline__ int color_node(const int* v) const {
    int node = a.root;
    for (int l = a.height - 1; l >= 0 && node >= 0; --l) {
      const int idx = ((v[0] >> l) & 1) | (((v[1] >> l) & 1) << 1) |
                      (((v[2] >> l) & 1) << 2);
      node = __ldg(a.table + node * 8 + idx);
    }
    return node;
  }

  // hf_raycast_edited's slab test against the edit boxes, for the ray
  // (p, d) before its walk
  __device__ __forceinline__ void slab(const float* p, const float* d) {
    const float inf = __int_as_float(0x7f800000);
    box_any = false;
    box_t = inf;
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
      if (t_en <= t_ex && t_ex >= 0.0f && par_ok) {
        box_any = true;
        box_t = fminf(box_t, fmaxf(t_en, 0.0f));
      }
    }
  }

  // After the heightfield walk: whether its ray reaches some edit box no
  // later than its result (hit, t), as hf_raycast_edited's any over the
  // boxes of (reaches && (!hit || max(t_en, 0) <= t + 2)); the least
  // entry decides it
  __device__ __forceinline__ bool affected() {
    const RayIo& r = io();
    return box_any && (!r.hit || box_t <= r.t + 2.0f);
  }
};

// Writes path i's world hit for path_shade_kernel: kWorldHit, t, normal,
// albedo.
__device__ __forceinline__ void put_world(const PathArgs& a, int i,
                                          const RayIo& r, const float* rgb) {
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    a.F(fRgba + k, i) = rgb[k];
    a.F(fNormal + k, i) = r.normal[k];
  }
  a.F(fWt, i) = r.t;
  a.U(iFlags, i) = r.hit ? kWorldHit : 0u;
}

// The world cast of bounce b over its live queue (the lane-fetch face,
// lanes.cuh): the walk's result goes to the path's state for
// path_shade_kernel. Bounce 0's lanes with a primary hit walk nothing. On
// the edited engine a ray that reaches an edit box goes to the re-cast
// queue instead.
template <int E, int TL>
struct CastRay {
  const PathArgs& a;
  int b;
  Walker<E, TL> walk;
  int i, recast;
  unsigned lane_steps, warp_steps;

  __device__ __forceinline__ void skip(int, unsigned) {}  // no masked lanes

  __device__ __forceinline__ bool start(int j) {
    i = a.live(b)[j];
    if (b == 0 && a.p_hit != nullptr) return false;
    float p[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = a.F(fPos + k, i);
      d[k] = a.F(fDir + k, i);
    }
    const float cap = a.U(iCode, i) > 0u ? a.F(fPt, i) : a.c.far;
    return walk.begin(p, d, cap) || walked();
  }

  __device__ __forceinline__ bool step() {
    return walk.step() || walked();
  }

  __device__ __forceinline__ bool walked() {
    if (E == kEdited && walk.affected()) {
      recast = i;
      return false;
    }
    const RayIo& r = walk.io();
    // the albedo: the SVO leaf, the bit walk's voxel's leaf (a miss reads
    // none: svo_color_at's mask), or the terrain colour
    const int node = E == kSvo ? r.node
                               : (E == kBit && r.hit ? walk.color_node(r.vox)
                                                     : -1);
    float rgb[3];
#pragma unroll
    for (int k = 0; k < 3; ++k)
      rgb[k] = E == kSvo || E == kBit ? walk.leaf(node, k) : __ldg(a.trgb + k);
    put_world(a, i, r, rgb);
    return false;
  }

  __device__ __forceinline__ void flush() {
    if (E == kEdited) {
      append(a.queue(qRecast), a.counter(b, kRecast), recast >= 0, recast);
      recast = -1;
    }
  }
};

// The shadow cast toward the sun over bounce b's shadow queue: sets
// kOccluded where the world blocks it. The SVO engine's two stages as the
// plain version (capped at NEE_NEAR, then the full cast for the lanes it
// left open); on the edited engine a ray that reaches an edit box goes to
// the shadow re-cast queue.
template <int E, int TL>
struct ShadowRay {
  const PathArgs& a;
  int b;
  Walker<E, TL> walk;
  int i, recast;
  bool near;  // the SVO engine's first stage
  unsigned lane_steps, warp_steps;

  __device__ __forceinline__ void skip(int, unsigned) {}  // no masked lanes

  __device__ __forceinline__ bool start(int j) {
    i = a.queue(qShadow)[j];
    float p[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = a.F(fPos + k, i);
      d[k] = a.F(fSdir + k, i);
    }
    near = E == kSvo;
    return walk.begin(p, d, near ? a.c.nee_near : a.c.far) || walked();
  }

  __device__ __forceinline__ bool step() {
    return walk.step() || walked();
  }

  __device__ __forceinline__ bool walked() {
    RayIo& r = walk.io();
    if (E == kSvo && near && !r.hit) {
      near = false;
      if (walk.begin(r.o, r.dv, a.c.far)) return true;
    }
    if (E == kEdited && walk.affected()) {
      recast = i;
      return false;
    }
    if (r.hit) a.U(iFlags, i) |= kOccluded;
    return false;
  }

  __device__ __forceinline__ void flush() {
    if (E == kEdited) {
      append(a.queue(qShadowRecast), a.counter(b, kShadowRecast),
             recast >= 0, recast);
      recast = -1;
    }
  }
};

// The edited engine's SVO re-casts over bounce b's re-cast queue (kShadow
// false: the world cast capped at the fog event, shading by the leaf it
// hits) or its shadow re-cast queue (kShadow true: kOccluded on a hit).
template <bool kShadow>
struct RecastRay {
  const PathArgs& a;
  int b;
  Walker<kSvo, 3> walk;
  int i;
  unsigned lane_steps, warp_steps;

  __device__ __forceinline__ void skip(int, unsigned) {}  // no masked lanes

  __device__ __forceinline__ bool start(int j) {
    i = a.queue(kShadow ? qShadowRecast : qRecast)[j];
    float p[3], d[3];
#pragma unroll
    for (int k = 0; k < 3; ++k) {
      p[k] = a.F(fPos + k, i);
      d[k] = a.F((kShadow ? fSdir : fDir) + k, i);
    }
    const float cap = kShadow || a.U(iCode, i) == 0u ? a.c.far : a.F(fPt, i);
    return walk.begin(p, d, cap) || walked();
  }

  __device__ __forceinline__ bool step() {
    return walk.step() || walked();
  }

  __device__ __forceinline__ bool walked() {
    const RayIo& r = walk.io();
    if (kShadow) {
      if (r.hit) a.U(iFlags, i) |= kOccluded;
      return false;
    }
    float rgb[3];  // a re-cast lane shades by the leaf it hits
#pragma unroll
    for (int k = 0; k < 3; ++k)
      rgb[k] = r.hit ? walk.leaf(r.node, k) : __ldg(a.trgb + k);
    put_world(a, i, r, rgb);
    return false;
  }
};

// The fixed logic of bounce b from the world hit to the sun march, over
// its live queue, the whole warp together: the planet cast's two
// scatter-direction draws and normal, the nearer event, the sun disk on
// bounce 0, the move to the hit, sample_sun, the facing test, the sun
// march's draw set up and tested, the sun maps' test, and the 2 unused
// draws. A sun march the test does not settle goes to the sun-march
// queue, a live, facing lane it leaves open to the shadow queue unless
// the maps prove it lit.
__global__ void __launch_bounds__(kThreads)
    path_shade_kernel(__grid_constant__ const PathArgs a, int b) {
  __shared__ float frac_a[voxt::kFogMaxSteps + 1];
  __shared__ float frac_b[voxt::kFogMaxSteps + 1];
  voxt::fog_fractions(frac_a, frac_b, a.fog_steps);
  __syncthreads();
  const PathConsts& c = a.c;
  const int lane = threadIdx.x & 31;
  const int count = *a.counter(b, kLive);
  const int* in = a.live(b);
  unsigned work[3] = {0u, 0u, 0u};  // sun marches set up, settled; lit
  for (int base = blockIdx.x * blockDim.x + (threadIdx.x & ~31); base < count;
       base += gridDim.x * blockDim.x) {
    const int j = base + lane;
    int i = 0;
    bool march = false, shadow = false;
    if (j < count) {
      i = in[j];
      // the world hit: bounce 0's primary, or the cast's
      bool w_hit;
      float w_t, w_normal[3], w_rgb[3];
      if (b == 0 && a.p_hit != nullptr) {
        w_hit = a.p_hit[i];
        w_t = __ldg(a.p_t + i);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          w_normal[k] = __ldg(a.p_normal + 3 * i + k);
          w_rgb[k] = __ldg(a.p_rgb + 3 * i + k);
        }
      } else {
        w_hit = a.U(iFlags, i) & kWorldHit;
        w_t = a.F(fWt, i);
#pragma unroll
        for (int k = 0; k < 3; ++k) {
          w_normal[k] = a.F(fNormal + k, i);
          w_rgb[k] = a.F(fRgba + k, i);
        }
      }
      float pos[3], d[3], sun[3];
      unsigned st[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        pos[k] = a.F(fPos + k, i);
        d[k] = a.F(fDir + k, i);
        st[k] = a.U(iSt + k, i);
        sun[k] = __ldg(a.sun + k);
      }
      const int code = (int)a.U(iCode, i);
      const float pt = a.F(fPt, i);
      // the planet cast's scatter direction (its 2 last draws)
      float r[3], r1[3], r2[3];
      random3(st, r1);
      random3(st, r2);
      float p_normal[3] = {0.0f, 0.0f, 0.0f};
      if (code == 1) {
        const float po[3] = {pos[0] + 0.0f, pos[1] + c.planet_r,
                             pos[2] + 0.0f};
#pragma unroll
        for (int k = 0; k < 3; ++k) p_normal[k] = po[k] + d[k] * pt;
        normalize3(p_normal);
      } else if (code == 2) {
        hemisphere(c, r1, r2, d, p_normal);
      }
      const bool p_hit = code > 0;
      const float cap = p_hit ? pt : c.far;

      const bool use_svo = w_hit && w_t <= cap;
      const bool hit_any = p_hit || use_svo;
      float rgba[4], normal[3];
      const float* p_rgba = code == 1 ? c.ground : c.fog;
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        rgba[k] = use_svo ? w_rgb[k] : (p_hit ? p_rgba[k] : 0.0f);
        normal[k] = use_svo ? w_normal[k] : p_normal[k];
      }
      rgba[3] = use_svo ? 1.0f : (p_hit ? p_rgba[3] : 0.0f);
      const float t_hit = use_svo ? w_t : pt;

      // a primary ray that misses sees the sun disk
      if (b == 0) {
        const bool sun_disk = dot3(d, sun) > c.cos_sun;
#pragma unroll
        for (int k = 0; k < 3; ++k)
          a.F(fColor + k, i) =
              a.F(fColor + k, i) +
              (!hit_any && sun_disk ? a.F(fLight + k, i) * c.sun_color
                                    : 0.0f);
      }
      if (hit_any) {
#pragma unroll
        for (int k = 0; k < 3; ++k) pos[k] = pos[k] + d[k] * t_hit;
      }

      // next-event estimation toward the sun: its direction, and its
      // planet cast set up and tested
      float sdir[3];
      sample_sun(c, st, sun, sdir);
      const bool facing = dot3(sdir, normal) > 0.0f;
      random3(st, r);
      bool sp_hit = false;
      if (hit_any && facing) {
        voxt::FogWalk w = fog_walker(a, frac_a, frac_b);
        const float y0 = -logf(1.0f - r[0]);
        if (w.setup(pos[0], pos[1], pos[2], sdir[0], sdir[1], sdir[2],
                    __ldg(a.density + i), y0)) {
          ++work[0];
          if (w.scatter_free()) {
            ++work[1];
            sp_hit = w.surf;
          } else {
            march = true;
            a.F(fY0, i) = y0;
          }
        } else {
          sp_hit = w.code > 0;
        }
      }
      // the sun maps (the unedited heightfield's option): a live, facing
      // lane they prove lit takes no shadow cast and stays unoccluded
      const bool lit = a.maps.t_near != nullptr && hit_any && facing &&
                       !sp_hit && sun_clear(a.maps, pos);
      pcg3d(st);  // the sun planet cast's scatter direction (unused)
      pcg3d(st);
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        a.F(fPos + k, i) = pos[k];
        a.F(fNormal + k, i) = normal[k];
        a.F(fSdir + k, i) = sdir[k];
        a.U(iSt + k, i) = st[k];
      }
#pragma unroll
      for (int k = 0; k < 4; ++k) a.F(fRgba + k, i) = rgba[k];
      a.U(iFlags, i) = (hit_any ? kHit : 0u) | (facing ? kFacing : 0u) |
                       (sp_hit ? kSunHit : 0u) | (lit ? kLit : 0u);
      shadow = !march && hit_any && facing && !sp_hit && !lit;
      work[2] += !march && lit;
    }
    append(a.queue(qSunMarch), a.counter(b, kSunMarch), march, i);
    append(a.queue(qShadow), a.counter(b, kShadow), shadow, i);
  }
  const int slot[3] = {kSunMarches, kSunMarchesFree, kSunLit};
  add_work<3>(a, slot, work);
}

// This thread's SVO node stack, after the warps' lane rings (the SVO
// walks only: the SVO engine's stages and the re-casts)
template <int E>
__device__ __forceinline__ int* svo_stack(int* smem) {
  return E != kSvo ? nullptr
                   : smem + kThreads / 32 * voxt::kQueue + threadIdx.x;
}

// The pack's row starts into shared memory (heightfield engines)
template <int E>
__device__ __forceinline__ void load_rows(const PathArgs& a, int* s_rows) {
  if ((E == kHf || E == kEdited) && (int)threadIdx.x < a.hf.levels)
    s_rows[threadIdx.x] = __ldg(a.hf.row_start + threadIdx.x);
  __syncthreads();
}

// The work slot of engine E's walk steps
template <int E>
__host__ __device__ constexpr int steps_slot() {
  return E == kSvo ? kSvoSteps : (E == kBit ? kBitSteps : kHfSteps);
}

// A walk stage's work: its walk steps (in `steps`) and, with stats, its
// lane and warp steps
template <class Ray>
__device__ __forceinline__ void walk_work(const PathArgs& a, Ray& ray,
                                          int steps, int stage) {
  const int slot[3] = {steps, kLaneSteps + stage, kWarpSteps + stage};
  unsigned work[3] = {ray.walk.steps, ray.lane_steps, ray.warp_steps};
  add_work<3>(a, slot, work);
}

template <int E, int TL, bool kStats>
__global__ void __launch_bounds__(kThreads)
    path_cast_kernel(__grid_constant__ const PathArgs a, int b) {
  extern __shared__ int smem[];
  __shared__ int s_rows[voxt::kHfMaxLevels];
  load_rows<E>(a, s_rows);
  CastRay<E, TL> ray{a, b, Walker<E, TL>(a, s_rows, svo_stack<E>(smem)), 0,
                     -1, 0u, 0u};
  voxt::run_lanes<kWalkSteps, kStats>(
      a.lanes(b, kLive), smem + (threadIdx.x >> 5) * voxt::kQueue, ray);
  walk_work(a, ray, steps_slot<E>(), kStageCast);
}

template <int E, int TL, bool kStats>
__global__ void __launch_bounds__(kThreads)
    path_shadow_kernel(__grid_constant__ const PathArgs a, int b) {
  extern __shared__ int smem[];
  __shared__ int s_rows[voxt::kHfMaxLevels];
  load_rows<E>(a, s_rows);
  ShadowRay<E, TL> ray{a, b, Walker<E, TL>(a, s_rows, svo_stack<E>(smem)),
                       0, -1, false, 0u, 0u};
  voxt::run_lanes<kWalkSteps, kStats>(
      a.lanes(b, kShadow), smem + (threadIdx.x >> 5) * voxt::kQueue, ray);
  walk_work(a, ray, steps_slot<E>(), kStageShadow);
}

template <bool kShadow, bool kStats>
__global__ void __launch_bounds__(kThreads)
    path_recast_kernel(__grid_constant__ const PathArgs a, int b) {
  extern __shared__ int smem[];
  RecastRay<kShadow> ray{a, b, Walker<kSvo, 3>(a, nullptr,
                                               svo_stack<kSvo>(smem)),
                         0, 0u, 0u};
  voxt::run_lanes<kWalkSteps, kStats>(
      a.lanes(b, kShadow ? kShadowRecast : kRecast),
      smem + (threadIdx.x >> 5) * voxt::kQueue, ray);
  walk_work(a, ray, kSvoSteps, kShadow ? kStageShadowRecast : kStageRecast);
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

// Every stage of every bounce, then the burn pass, on one stream.
template <int E, int TL, bool kStats>
int launch(const PathArgs& a, int extra, cudaStream_t stream) {
  const int n = a.n;
  auto bounce = path_bounce_kernel;
  auto march = path_march_kernel<false, kStats>;
  auto sun_march = path_march_kernel<true, kStats>;
  auto cast = path_cast_kernel<E, TL, kStats>;
  auto shade = path_shade_kernel;
  auto shadow = path_shadow_kernel<E, TL, kStats>;
  auto recast = path_recast_kernel<false, kStats>;
  auto shadow_recast = path_recast_kernel<true, kStats>;
  const size_t queues = (size_t)(kThreads / 32 * voxt::kQueue) * sizeof(int);
  const size_t stack = (size_t)(a.height + 1) * kThreads * sizeof(int);
  const size_t smem = queues + (E == kSvo ? stack : 0);
  int nb = 0, nm = 0, nc = 0, ns = 0, nh = 0, nr = 0;
  cudaError_t err = voxt::persistent_blocks(bounce, kThreads, 0, n, &nb);
  if (err == cudaSuccess)
    err = voxt::persistent_blocks(march, kThreads, 0, n, &nm);
  if (err == cudaSuccess)
    err = voxt::persistent_blocks(shade, kThreads, 0, n, &nh);
  if (err == cudaSuccess)
    err = voxt::persistent_blocks(cast, kThreads, smem, n, &nc);
  if (err == cudaSuccess)
    err = voxt::persistent_blocks(shadow, kThreads, smem, n, &ns);
  if (err == cudaSuccess && E == kEdited)
    err = voxt::persistent_blocks(recast, kThreads, queues + stack, n, &nr);
  if (err != cudaSuccess) return (int)err;
  bounce<<<nb, kThreads, 0, stream>>>(a, 0);
  for (int b = 0; b < a.max_bounces; ++b) {
    march<<<nm, kThreads, 0, stream>>>(a, b);
    cast<<<nc, kThreads, smem, stream>>>(a, b);
    if (E == kEdited) recast<<<nr, kThreads, queues + stack, stream>>>(a, b);
    shade<<<nh, kThreads, 0, stream>>>(a, b);
    sun_march<<<nm, kThreads, 0, stream>>>(a, b);
    shadow<<<ns, kThreads, smem, stream>>>(a, b);
    if (E == kEdited)
      shadow_recast<<<nr, kThreads, queues + stack, stream>>>(a, b);
    bounce<<<nb, kThreads, 0, stream>>>(a, b + 1);
  }
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  auto burn = path_burn_kernel;
  burn<<<(n + kBurnThreads - 1) / kBurnThreads, kBurnThreads, 0, stream>>>(
      a.last, a.max_last, a.state_out, n, extra);
  return (int)cudaGetLastError();
}

template <int E, bool kStats>
int launch_tl(const PathArgs& a, int tile_log, int extra, cudaStream_t s) {
  switch (tile_log) {
    case 1:
      return launch<E, 1, kStats>(a, extra, s);
    case 2:
      return launch<E, 2, kStats>(a, extra, s);
    default:
      return launch<E, 3, kStats>(a, extra, s);
  }
}

template <bool kStats>
int launch_engine(const PathArgs& a, int engine, int tile_log, int extra,
                  cudaStream_t s) {
  switch (engine) {
    case kHf:
      return launch_tl<kHf, kStats>(a, tile_log, extra, s);
    case kSvo:
      return launch<kSvo, 3, kStats>(a, extra, s);
    case kEdited:
      return launch_tl<kEdited, kStats>(a, tile_log, extra, s);
    default:
      return launch<kBit, 3, kStats>(a, extra, s);
  }
}

}  // namespace

// ws: kWordsPerPath * n words of path state (uninitialized); counters:
// kCounters * (max_bounces + 1) int32, zeroed; work: kWork uint64, zeroed;
// stats: count each lane-fetch stage's lane and warp steps (slower: only
// for measurement). bit_*: the bit-grid engine's pyramid (edge bit_size);
// t_near, t_far: the heightfield engine's sun maps ((near_n)^2 and
// (far_n)^2 floats; t_near null: none).
extern "C" int voxt_path_trace(
    const void* consts, int n_consts, int engine, const void* tiles,
    int tile_log, int levels, const void* row_starts, const void* hmax_w,
    const void* table, int root, int height, const void* boxes, int n_boxes,
    const void* bit_top, int top_words, const void* bit_regions,
    const void* bit_bricks, int bit_size, const void* t_near,
    const void* t_far, int near_n, int far_n, int subres, int pool,
    const void* trgb, const void* sun, const void* pos, const void* dir,
    const void* light, const void* density, const void* state_in,
    const void* p_hit, const void* p_t, const void* p_normal,
    const void* p_rgb, void* color, void* state_out, void* last,
    void* max_last, void* work, int n_work, void* ws, long long ws_words,
    void* counters, int n_counters, int n, int max_bounces, int fog_steps,
    int extra_draws, int stats, int static_pct, int chunk, int refill,
    void* stream) {
  if (n <= 0) return 0;
  const bool hf = engine == kHf || engine == kEdited;
  const bool svo = engine == kSvo || engine == kEdited;
  if (n_consts * sizeof(float) != sizeof(PathConsts) || engine < kHf ||
      engine > kBit || !voxt::valid_fetch(static_pct, chunk, refill) ||
      height < 1 || max_bounces < 1 || fog_steps < 0 ||
      fog_steps > voxt::kFogMaxSteps || extra_draws < 0 ||
      n_work != kWork || ws_words < (long long)kWordsPerPath * n ||
      n_counters < kCounters * (max_bounces + 1) ||
      (svo && height > kSvoMaxHeight) ||
      (hf && (levels < 1 || levels > voxt::kHfMaxLevels || tile_log < 1 ||
              tile_log > 3 || height > 30)) ||
      (engine == kEdited && n_boxes < 1) ||
      (engine == kBit && (bit_size < 128 || (bit_size & (bit_size - 1)) ||
                          top_words < 1 || height > 30)) ||
      (t_near != nullptr &&
       (engine != kHf || subres < 1 || (subres & (subres - 1)) || pool < 1 ||
        far_n < 1 || (long long)far_n * subres * pool != near_n)))
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
  a.bit.top = (const unsigned*)bit_top;
  a.bit.regions = (const unsigned*)bit_regions;
  a.bit.bricks = (const unsigned*)bit_bricks;
  a.bit.top_words = top_words;
  a.bit.n = bit_size;
  a.bit.skip_t0 = 1;
  a.maps.t_near = (const float*)t_near;
  a.maps.t_far = (const float*)t_far;
  a.maps.subres = (float)subres;
  a.maps.rn = near_n;
  a.maps.k = far_n;
  a.maps.div = subres * pool;
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
  a.f = (float*)ws;
  a.u = (unsigned*)(a.f + (size_t)kFloatFields * n);
  a.q = (int*)(a.u + (size_t)kIntFields * n);
  a.counters = (int*)counters;
  a.n = n;
  a.max_bounces = max_bounces;
  a.fog_steps = fog_steps;
  a.static_pct = static_pct;
  a.chunk = chunk;
  a.refill = refill;
  const cudaStream_t s = (cudaStream_t)stream;
  return stats ? launch_engine<true>(a, engine, tile_log, extra_draws, s)
               : launch_engine<false>(a, engine, tile_log, extra_draws, s);
}
