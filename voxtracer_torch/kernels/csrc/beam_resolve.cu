// K7: the beam resolve, the nearest of a beam's K candidate boxes for
// every ray of the beam.
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
// entry axis (x before y before z), normal, colour and voxel.
//
// What bounds it on the card: operations. K candidates a ray, ~30 float
// operations each (six multiplies, the min/max and compares), against
// 52 bytes a ray of output and 28 bytes a candidate shared by the P rays
// of its beam.
//
// Design (simple first): one block a beam, one thread a ray; the block
// stages its K candidates in shared memory once (planes as floats,
// presence, colour), then every thread runs over them in order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1.0e-6f;  // raytrace.wgsl:53
constexpr float kFar = 1.0e12f;  // traverse.FAR

struct ResolveArgs {
  const int* lvl;
  const int* off;
  const float* rgb;
  const float* origin;
  int origin_per_ray;
  const float* dir;
  int H, skip_t0, n_beams, P, K;
  bool* hit_out;
  float* t_out;
  float* normal_out;
  float* rgb_out;
  int* voxel_out;
};

struct Slab {
  float score, score2, e[3], near_[3], far_[3];
};

__device__ __forceinline__ Slab slab(const float* lo, const float* hi,
                                     bool present, const bool* flip,
                                     const float* o, const float* inv,
                                     float bound, const bool* uaxis,
                                     float plane_a, float tu, int skip_t0) {
  Slab s;
  float entry = -3.0e38f, exit_ = 3.0e38f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    s.near_[c] = flip[c] ? bound - hi[c] : lo[c];
    s.far_[c] = flip[c] ? bound - lo[c] : hi[c];
    s.e[c] = (s.near_[c] - o[c]) * inv[c];
    const float x = (s.far_[c] - o[c]) * inv[c];
    entry = fmaxf(entry, s.e[c]);
    exit_ = fminf(exit_, x);
  }
  const float entry_eff = fmaxf(entry, 0.0f);
  bool valid = present && entry <= exit_ && exit_ > 0.0f;
  if (skip_t0) valid = valid && entry_eff > 0.0f;
  s.score = valid ? entry_eff : kFar;
  s.score2 = kFar;
  if (skip_t0) {
    const float far_a =
        uaxis[0] ? s.far_[0] : (uaxis[1] ? s.far_[1] : (uaxis[2] ? s.far_[2] : 0.0f));
    const bool special = present && entry <= 0.0f && exit_ > 0.0f &&
                         entry < exit_ && plane_a + 1.0f <= far_a;
    if (special) s.score2 = tu;
  }
  return s;
}

__global__ void beam_resolve_kernel(const ResolveArgs a) {
  extern __shared__ float smem[];
  const int beam = blockIdx.x;
  const int K = a.K;
  float* s_lo = smem;          // K * 3
  float* s_hi = smem + 3 * K;  // K * 3
  float* s_rgb = smem + 6 * K; // K * 3
  int* s_present = (int*)(smem + 9 * K);  // K
  for (int k = threadIdx.x; k < K; k += blockDim.x) {
    const int l = a.lvl[(int64_t)beam * K + k];
    const float size = l >= 0 ? (float)(1 << l) : 0.5f;
    s_present[k] = l >= 0;
#pragma unroll
    for (int c = 0; c < 3; ++c) {
      const float lo = (float)a.off[((int64_t)beam * K + k) * 3 + c];
      s_lo[3 * k + c] = lo;
      s_hi[3 * k + c] = lo + size;
      s_rgb[3 * k + c] = a.rgb[((int64_t)beam * K + k) * 3 + c];
    }
  }
  __syncthreads();
  const int p = threadIdx.x;
  if (p >= a.P) return;
  const int64_t i = (int64_t)beam * a.P + p;
  const float bound = (float)(1 << a.H);
  float d[3], ow[3], o[3], inv[3], dm[3], plane[3], tu_k[3], sgn[3];
  bool flip[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    d[c] = a.dir[3 * i + c];
    ow[c] = a.origin_per_ray ? a.origin[3 * i + c] : a.origin[c];
    flip[c] = d[c] < 0.0f;
    sgn[c] = d[c] > 0.0f ? 1.0f : (d[c] < 0.0f ? -1.0f : 0.0f);
    dm[c] = fmaxf(fabsf(d[c]), kEps);
    inv[c] = 1.0f / dm[c];
    o[c] = flip[c] ? bound - ow[c] : ow[c];
    plane[c] = floorf(o[c]) + 1.0f;
    tu_k[c] = (plane[c] - o[c]) * inv[c];
  }
  const float tu = fminf(fminf(tu_k[0], tu_k[1]), tu_k[2]);
  bool uaxis[3];
  uaxis[0] = tu_k[0] == tu;
  uaxis[1] = !uaxis[0] && tu_k[1] == tu;
  uaxis[2] = !uaxis[0] && !uaxis[1] && tu_k[2] == tu;
  const float plane_a =
      uaxis[0] ? plane[0] : (uaxis[1] ? plane[1] : (uaxis[2] ? plane[2] : 0.0f));

  float best_t = kFar;
  int best = 0;
  for (int k = 0; k < K; ++k) {
    const Slab s = slab(s_lo + 3 * k, s_hi + 3 * k, s_present[k] != 0, flip,
                        o, inv, bound, uaxis, plane_a, tu, a.skip_t0);
    const float sc = fminf(s.score, s.score2);
    if (sc < best_t) {
      best_t = sc;
      best = k;
    }
  }
  const float t = best_t;
  const bool hit = t < kFar;
  const Slab s = slab(s_lo + 3 * best, s_hi + 3 * best, s_present[best] != 0,
                      flip, o, inv, bound, uaxis, plane_a, tu, a.skip_t0);
  const bool special = s.score2 < s.score;
  bool axis3[3];
  axis3[0] = s.e[0] == t;
  axis3[1] = !axis3[0] && s.e[1] == t;
  axis3[2] = !axis3[0] && !axis3[1] && s.e[2] == t;
  if (special) {
#pragma unroll
    for (int c = 0; c < 3; ++c) axis3[c] = uaxis[c];
  }
  const float hitf = hit ? 1.0f : 0.0f;
  a.hit_out[i] = hit;
  a.t_out[i] = hit ? t : 0.0f;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    a.normal_out[3 * i + c] = (axis3[c] ? -sgn[c] : 0.0f) * hitf;
    a.rgb_out[3 * i + c] = s_rgb[3 * best + c] * hitf;
    const float ph = o[c] + dm[c] * t;
    float vm = fminf(fmaxf(floorf(ph), s.near_[c]), s.far_[c] - 1.0f);
    if (axis3[c]) vm = special ? plane[c] : s.near_[c];
    const float vw = flip[c] ? bound - vm - 1.0f : vm;
    a.voxel_out[3 * i + c] = hit ? (int)vw : 0;
  }
}

}  // namespace

extern "C" int voxt_beam_resolve(const void* lvl, const void* off,
                                 const void* rgb, const void* origin,
                                 int origin_per_ray, const void* dir,
                                 int height, int skip_t0, void* hit, void* t,
                                 void* normal, void* rgb_out, void* voxel,
                                 int n_beams, int P, int K, void* stream) {
  if (n_beams <= 0 || P <= 0) return 0;
  if (P > 1024 || K < 1 || height < 1 || height > 30)
    return (int)cudaErrorInvalidValue;
  const ResolveArgs a{(const int*)lvl,   (const int*)off,  (const float*)rgb,
                      (const float*)origin, origin_per_ray, (const float*)dir,
                      height,            skip_t0,          n_beams,
                      P,                 K,                (bool*)hit,
                      (float*)t,         (float*)normal,   (float*)rgb_out,
                      (int*)voxel};
  const int threads = (P + 31) / 32 * 32;
  const size_t smem = (size_t)K * 10 * sizeof(float);
  if (smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  beam_resolve_kernel<<<n_beams, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
