// K3: the rasterizer's resolve fold.
//
// Replaces: voxtracer/kernels/pallas/resolve.py, resolve_fold /
// _resolve_kernel (the Pallas TPU kernel), and the XLA scan it stands in
// for (voxtracer/kernels/raster.py, resolve_scan and the near pre-pass).
// Same arithmetic, op for op, as resolve_fold_plain in
// voxtracer_torch/kernels/resolve.py and as raster._mirrored_slab; built
// with --fmad=false, so every output is bit-equal to the plain version.
//
// What it computes: per raster tile, fold K candidate boxes into every
// ray's best-hit carry (t, pl = owner << 2 | entry axis, rgb). Each
// candidate gets the traversal's mirrored slab test; the fold is
// candidate-sequential with a strict <, so the first candidate seen wins
// a tie. Candidates are sorted-pair records [key, owner, q0, q1, q2, r, g,
// b] (int32 x 8: 16-bit coordinate and extent fields, rgb as float bits)
// beside a validity mask; an invalid record never hits. The same kernel
// serves the main fold (a tile's K nearest records), the widen rounds
// (the next 104 / 256 / 1024 records of a tile's segment) and the near
// pre-pass (one shared list for every tile: tile stride 0).
//
// What bounds it on the card: arithmetic, weakly. Per (ray, candidate)
// pair it does ~30 float operations and reads nothing from device memory
// (the candidate sits in shared memory, the ray in registers), while
// each ray costs 52 bytes of traffic (direction, carry in, carry out)
// for the whole list. At the main path's shapes (6,420 tiles x 512 rays
// x 16 candidates) the operations and the bytes bound it at about the
// same time, ~0.05 ms.
//
// Design: one CTA per tile. The CTA decodes its tile's candidates once
// into shared memory (structure of arrays, up to 1024 at a time); each
// thread then takes rays of the tile in turn, keeps the ray's carry and
// its mirrored s0 / 1/|d| / flip in registers for the whole staged list,
// and writes the carry once. Threads loop over the tile's R rays, so any
// number of jitter samples per tile (R = KS * 64) works. A list longer
// than one stage reloads the carry from the output between stages.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kEps = 1.0e-6f;  // raytrace.wgsl:53
constexpr int kStage = 1024;     // candidates staged in shared memory

__global__ void resolve_fold_kernel(
    const float* __restrict__ t_in, const int* __restrict__ pl_in,
    const float* __restrict__ rgb_in, const int* __restrict__ rows,
    const bool* __restrict__ valid, long long tile_stride,
    const float* __restrict__ dir, float cam_x, float cam_y, float cam_z,
    float bound, float distance, float* __restrict__ t_out,
    int* __restrict__ pl_out, float* __restrict__ rgb_out, int rays, int k,
    int stage) {
  extern __shared__ float smem[];
  float* s_lo = smem;               // [3][stage]
  float* s_hi = smem + 3 * stage;   // [3][stage]
  float* s_rgb = smem + 6 * stage;  // [3][stage]
  int* s_pl = reinterpret_cast<int*>(smem + 9 * stage);

  const long long tile = blockIdx.x;
  const int* trows = rows + tile * tile_stride * 8;
  const bool* tvalid = valid + tile * tile_stride;
  const float cam[3] = {cam_x, cam_y, cam_z};

  for (int c0 = 0; c0 < k; c0 += stage) {
    const int nc = k - c0 < stage ? k - c0 : stage;
    __syncthreads();
    for (int j = threadIdx.x; j < nc; j += blockDim.x) {
      const int* rec = trows + (long long)(c0 + j) * 8;
      const unsigned q0 = (unsigned)rec[2];
      const unsigned q1 = (unsigned)rec[3];
      const unsigned q2 = (unsigned)rec[4];
      const float lo[3] = {(float)(q0 & 0xFFFFu), (float)(q0 >> 16),
                           (float)(q1 & 0xFFFFu)};
      const float sz[3] = {(float)(q1 >> 16), (float)(q2 & 0xFFFFu),
                           (float)(q2 >> 16)};
      for (int a = 0; a < 3; ++a) {
        s_lo[a * stage + j] = lo[a];
        s_hi[a * stage + j] = lo[a] + sz[a];
        s_rgb[a * stage + j] = __int_as_float(rec[5 + a]);
      }
      s_pl[j] = tvalid[c0 + j] ? (rec[1] << 2) : -4;
    }
    __syncthreads();

    for (int r = threadIdx.x; r < rays; r += blockDim.x) {
      const long long i = tile * rays + r;
      bool flip[3];
      float inv[3], s0[3];
      for (int a = 0; a < 3; ++a) {
        const float d = dir[3 * i + a];
        flip[a] = d < 0.0f;
        inv[a] = 1.0f / fmaxf(fabsf(d), kEps);
        s0[a] = flip[a] ? bound - cam[a] : cam[a];
      }
      const bool first = c0 == 0;
      float tb = first ? t_in[i] : t_out[i];
      int pb = first ? pl_in[i] : pl_out[i];
      float cb[3];
      for (int c = 0; c < 3; ++c)
        cb[c] = first ? rgb_in[3 * i + c] : rgb_out[3 * i + c];

      for (int j = 0; j < nc; ++j) {
        float ti[3], to[3];
        for (int a = 0; a < 3; ++a) {
          const float lo = s_lo[a * stage + j];
          const float hi = s_hi[a * stage + j];
          const float mlo = flip[a] ? bound - hi : lo;
          const float mhi = flip[a] ? bound - lo : hi;
          ti[a] = (mlo - s0[a]) * inv[a];
          to[a] = (mhi - s0[a]) * inv[a];
        }
        const float t_enter = fmaxf(fmaxf(fmaxf(ti[0], ti[1]), ti[2]), 0.0f);
        const float t_exit =
            fminf(fminf(fminf(to[0], to[1]), to[2]), distance);
        const int pl = s_pl[j];
        const bool hit = t_enter < t_exit && t_enter > 0.0f && pl >= 0;
        const float tc = hit ? t_enter : INFINITY;
        if (tc < tb) {
          const int axis = ti[0] == t_enter ? 0 : (ti[1] == t_enter ? 1 : 2);
          tb = tc;
          pb = pl + axis;
          for (int c = 0; c < 3; ++c) cb[c] = s_rgb[c * stage + j];
        }
      }

      t_out[i] = tb;
      pl_out[i] = pb;
      for (int c = 0; c < 3; ++c) rgb_out[3 * i + c] = cb[c];
    }
  }
}

}  // namespace

extern "C" int voxt_resolve_fold(const void* t_in, const void* pl_in,
                                 const void* rgb_in, const void* rows,
                                 const void* valid, long long tile_stride,
                                 const void* dir, float cam_x, float cam_y,
                                 float cam_z, float bound, float distance,
                                 void* t_out, void* pl_out, void* rgb_out,
                                 int n_tiles, int rays, int k, void* stream) {
  if (n_tiles <= 0 || rays <= 0 || k <= 0) return 0;
  const int stage = k < kStage ? k : kStage;
  int threads = (rays + 31) / 32 * 32;
  if (threads > 256) threads = 256;
  const size_t smem = (size_t)stage * 10 * sizeof(float);
  resolve_fold_kernel<<<n_tiles, threads, smem, (cudaStream_t)stream>>>(
      (const float*)t_in, (const int*)pl_in, (const float*)rgb_in,
      (const int*)rows, (const bool*)valid, tile_stride, (const float*)dir,
      cam_x, cam_y, cam_z, bound, distance, (float*)t_out, (int*)pl_out,
      (float*)rgb_out, rays, k, stage);
  return (int)cudaGetLastError();
}
