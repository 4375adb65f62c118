// K7: the beam resolve, the nearest of a beam's candidate boxes for every
// ray of the beam.
//
// Replaces: voxtracer/kernels/beam.py, resolve_candidates (jnp on the
// TPU, no Pallas kernel). Same results, bit for bit, as
// resolve_candidates_plain in voxtracer_torch/kernels/beam.py; built with
// --fmad=false. K3 (resolve_fold.cu) folds packed raster records without
// the walk's t == 0 rule and returns no voxel, so this is a kernel of its
// own.
//
// What it computes, per ray: the slab test of each candidate in the
// traversal's mirrored space (EPS-clamped directions, the exact integer
// planes of the candidate cell, (plane - origin) * inv), so the entry t
// is the SVO walk's crossing t by bits; a candidate the ray starts inside
// scores the ray's next unit-grid plane when that plane still lies in the
// cell (the walk's skip of a hit at t == 0); the first candidate with the
// least score wins (strict <, the reference's argmin). Then the winner's
// entry axis (x before y before z), normal, colour and voxel. With
// ``merge``, the outputs hold the running best of earlier rounds and a
// ray takes this round's result only where it is strictly nearer (the
// frame's merge of rounds, beam.py's _merge).
//
// What bounds it on the card: operations. The used candidates a ray, ~40
// float operations each (six multiplies, the min/max and compares),
// against 53 bytes a ray and 28 bytes a used candidate slot shared by
// the P rays of its beam.
//
// Design: several beams a block (P rounded up to a warp threads a beam,
// 256 threads a block at P = 64), a thread a ray. A beam resolves only
// its used slots, up to its last slot with lvl >= 0 (the walk fills
// slots from 0 without gaps; an unused slot before it is never taken).
// The block stages each used candidate once in shared memory: its
// mirrored near and far planes when every ray of the beam has the same
// direction signs (true of every beam the walk collects for, which are
// coherent), so a ray's test is six subtractions and multiplies; its
// lo/hi corners when they differ, and each ray mirrors them with its own
// signs (the plain version's expressions either way). A beam with no
// used slot touches no candidate: its rays resolve against the walk's
// unused slot (lvl -1, corner 0, colour 0), which gives the plain
// version's no-hit outputs, and with ``merge`` they do nothing at all.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBlock = 256;  // threads a block, several beams when P <= 128
constexpr int kMaxWarps = 32;
constexpr float kEps = 1.0e-6f;  // raytrace.wgsl:53
constexpr float kFar = 1.0e12f;  // traverse.FAR

struct ResolveArgs {
  const int* lvl;
  const int* off;
  const float* rgb;
  const float* origin;
  int origin_per_ray;
  const float* dir;
  int H, skip_t0, merge, n_beams, P, K, T, per;
  bool* hit_out;
  float* t_out;
  float* normal_out;
  float* rgb_out;
  int* voxel_out;
};

struct Ray {
  float o[3], inv[3], dm[3], plane[3], sgn[3], tu, plane_a;
  bool flip[3], uaxis[3];
};

struct Slab {
  float score, score2, e[3], near_[3], far_[3];
};

// v: a staged slot, (near, far) or (lo, hi) when ``mirror_here``
__device__ __forceinline__ Slab slab(const float* v, bool present,
                                     bool mirror_here, const Ray& r,
                                     float bound, int skip_t0) {
  Slab s;
  float entry = -3.0e38f, exit_ = 3.0e38f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    if (mirror_here) {
      s.near_[c] = r.flip[c] ? bound - v[3 + c] : v[c];
      s.far_[c] = r.flip[c] ? bound - v[c] : v[3 + c];
    } else {
      s.near_[c] = v[c];
      s.far_[c] = v[3 + c];
    }
    s.e[c] = (s.near_[c] - r.o[c]) * r.inv[c];
    const float x = (s.far_[c] - r.o[c]) * r.inv[c];
    entry = fmaxf(entry, s.e[c]);
    exit_ = fminf(exit_, x);
  }
  const float entry_eff = fmaxf(entry, 0.0f);
  bool valid = present && entry <= exit_ && exit_ > 0.0f;
  if (skip_t0) valid = valid && entry_eff > 0.0f;
  s.score = valid ? entry_eff : kFar;
  s.score2 = kFar;
  if (skip_t0) {
    const float far_a = r.uaxis[0]   ? s.far_[0]
                        : r.uaxis[1] ? s.far_[1]
                        : r.uaxis[2] ? s.far_[2]
                                     : 0.0f;
    const bool special = present && entry <= 0.0f && exit_ > 0.0f &&
                         entry < exit_ && r.plane_a + 1.0f <= far_a;
    if (special) s.score2 = r.tu;
  }
  return s;
}

__global__ void __launch_bounds__(1024) beam_resolve_kernel(
    const ResolveArgs a) {
  extern __shared__ __align__(16) float smem[];
  __shared__ int s_used[kMaxWarps];
  __shared__ int s_mixed[kMaxWarps];
  const int K = a.K, T = a.T;
  const int g = threadIdx.x / T;  // the block's beam of this thread
  const int p = threadIdx.x - g * T;
  const int beam = blockIdx.x * a.per + g;
  const bool has_beam = beam < a.n_beams;
  float* planes = smem + (int64_t)g * K * 8;  // near/far (or lo/hi), present
  float* s_rgb = smem + (int64_t)a.per * K * 8 + (int64_t)g * K * 3;
  const float bound = (float)(1 << a.H);

  if (p == 0) s_used[g] = 0;
  __syncthreads();
  // used slots: up to the last slot with lvl >= 0
  if (has_beam)
    for (int k = p; k < K; k += T)
      if (a.lvl[(int64_t)beam * K + k] >= 0) atomicMax(&s_used[g], k + 1);
  __syncthreads();
  const int n = s_used[g];
  const bool busy = has_beam && (n > 0 || !a.merge);

  // the ray, and whether the beam's rays share their direction signs
  const int64_t i = (int64_t)beam * a.P + p;
  const bool mine = busy && p < a.P;
  Ray r;
  int flips = 0;
  if (mine) {
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float d = a.dir[3 * i + c];
      const float ow = a.origin_per_ray ? a.origin[3 * i + c] : a.origin[c];
      r.flip[c] = d < 0.0f;
      r.sgn[c] = d > 0.0f ? 1.0f : (d < 0.0f ? -1.0f : 0.0f);
      r.dm[c] = fmaxf(fabsf(d), kEps);
      r.inv[c] = 1.0f / r.dm[c];
      r.o[c] = r.flip[c] ? bound - ow : ow;
      r.plane[c] = floorf(r.o[c]) + 1.0f;
      flips |= (int)r.flip[c] << c;
    }
    float tu_k[3];
#pragma unroll
    for (int c = 0; c < 3; ++c) tu_k[c] = (r.plane[c] - r.o[c]) * r.inv[c];
    r.tu = fminf(fminf(tu_k[0], tu_k[1]), tu_k[2]);
    r.uaxis[0] = tu_k[0] == r.tu;
    r.uaxis[1] = !r.uaxis[0] && tu_k[1] == r.tu;
    r.uaxis[2] = !r.uaxis[0] && !r.uaxis[1] && tu_k[2] == r.tu;
    r.plane_a = r.uaxis[0]   ? r.plane[0]
                : r.uaxis[1] ? r.plane[1]
                : r.uaxis[2] ? r.plane[2]
                             : 0.0f;
  }
  // the beam's signs are those of its first ray; a warp reports a ray
  // that differs
  int ref = 0;
  if (busy) {
    const float* d0 = a.dir + (int64_t)beam * a.P * 3;
    ref = (int)(d0[0] < 0.0f) | (int)(d0[1] < 0.0f) << 1 |
          (int)(d0[2] < 0.0f) << 2;
  }
  const unsigned differ = __ballot_sync(0xffffffffu, mine && flips != ref);
  if ((threadIdx.x & 31) == 0) s_mixed[threadIdx.x >> 5] = differ != 0u;
  __syncthreads();
  bool mixed = false;
  for (int wv = g * T / 32; wv < (g + 1) * T / 32; ++wv)
    mixed = mixed || s_mixed[wv] != 0;
  const bool mirror_here = mixed;

  // stage the used slots (or the walk's unused slot 0 for an empty beam)
  if (busy) {
    const int m = n > 0 ? n : 1;
    for (int k = p; k < m; k += T) {
      const int64_t at = (int64_t)beam * K + k;
      const int l = n > 0 ? a.lvl[at] : -1;
      const float size = l >= 0 ? (float)(1 << l) : 0.5f;
      float lo[3], hi[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        lo[c] = n > 0 ? (float)a.off[at * 3 + c] : 0.0f;
        hi[c] = lo[c] + size;
        s_rgb[3 * k + c] = n > 0 ? a.rgb[at * 3 + c] : 0.0f;
      }
      float* v = planes + 8 * k;
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const bool f = !mirror_here && ((ref >> c) & 1);
        v[c] = f ? bound - hi[c] : lo[c];
        v[3 + c] = f ? bound - lo[c] : hi[c];
      }
      v[6] = l >= 0 ? 1.0f : 0.0f;
    }
  }
  __syncthreads();
  if (!mine) return;

  float best_t = kFar;
  int best = 0;
  for (int k = 0; k < n; ++k) {
    const float4 v0 = reinterpret_cast<const float4*>(planes)[2 * k];
    const float4 v1 = reinterpret_cast<const float4*>(planes)[2 * k + 1];
    const float v[6] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y};
    const Slab s = slab(v, v1.z != 0.0f, mirror_here, r, bound, a.skip_t0);
    const float sc = fminf(s.score, s.score2);
    if (sc < best_t) {
      best_t = sc;
      best = k;
    }
  }
  const float t = best_t;
  const bool hit = t < kFar;
  if (a.merge) {  // the running best keeps a ray unless strictly nearer
    const float bk = a.hit_out[i] ? a.t_out[i] : kFar;
    if (!((hit ? t : kFar) < bk)) return;
  }
  const float* v = planes + 8 * best;
  const Slab s = slab(v, v[6] != 0.0f, mirror_here, r, bound, a.skip_t0);
  const bool special = s.score2 < s.score;
  bool axis3[3];
  axis3[0] = s.e[0] == t;
  axis3[1] = !axis3[0] && s.e[1] == t;
  axis3[2] = !axis3[0] && !axis3[1] && s.e[2] == t;
  if (special) {
#pragma unroll
    for (int c = 0; c < 3; ++c) axis3[c] = r.uaxis[c];
  }
  const float hitf = hit ? 1.0f : 0.0f;
  a.hit_out[i] = hit;
  a.t_out[i] = hit ? t : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.normal_out[3 * i + c] = (axis3[c] ? -r.sgn[c] : 0.0f) * hitf;
    a.rgb_out[3 * i + c] = s_rgb[3 * best + c] * hitf;
    const float ph = r.o[c] + r.dm[c] * t;
    float vm = fminf(fmaxf(floorf(ph), s.near_[c]), s.far_[c] - 1.0f);
    if (axis3[c]) vm = special ? r.plane[c] : s.near_[c];
    const float vw = r.flip[c] ? bound - vm - 1.0f : vm;
    a.voxel_out[3 * i + c] = hit ? (int)vw : 0;
  }
}

}  // namespace

extern "C" int voxt_beam_resolve(const void* lvl, const void* off,
                                 const void* rgb, const void* origin,
                                 int origin_per_ray, const void* dir,
                                 int height, int skip_t0, int merge,
                                 void* hit, void* t, void* normal,
                                 void* rgb_out, void* voxel, int n_beams,
                                 int P, int K, void* stream) {
  if (n_beams <= 0 || P <= 0) return 0;
  if (P > 1024 || K < 1 || height < 1 || height > 30)
    return (int)cudaErrorInvalidValue;
  const int T = (P + 31) / 32 * 32;
  const size_t per_beam = (size_t)K * 11 * sizeof(float);
  int per = T < kBlock ? kBlock / T : 1;
  while (per > 1 && per * per_beam > 48 * 1024) per /= 2;
  if (per * per_beam > 48 * 1024) return (int)cudaErrorInvalidValue;
  const ResolveArgs a{(const int*)lvl,      (const int*)off,
                      (const float*)rgb,    (const float*)origin,
                      origin_per_ray,       (const float*)dir,
                      height,               skip_t0,
                      merge,                n_beams,
                      P,                    K,
                      T,                    per,
                      (bool*)hit,           (float*)t,
                      (float*)normal,       (float*)rgb_out,
                      (int*)voxel};
  beam_resolve_kernel<<<(n_beams + per - 1) / per, per * T, per * per_beam,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
