// K10: the per-pose horizon envelope table E (bins, K) and its summary S,
// built on the card for one origin.
//
// Replaces: voxtracer/kernels/skyline.py, _env_device (a jitted jnp body
// on the TPU, no Pallas kernel; XLA fused its fold, scatter and rolls).
// Same table, by bits, as _env_device in voxtracer_torch/kernels/
// skyline.py, the plain version: that one runs each level's fold as ~70
// PyTorch ops, scatter-maxes into a dense class plane and dilates it by
// rolls, ~1,400 launches a build and ~15 GB of traffic at K = 512. Built
// with --fmad=false, and every float operation of the fold is the plain
// version's, in its order, rounded in float32 on its own (atan2f, hypotf,
// log2f, fmodf the libdevice functions torch's CUDA ops call; divisions
// IEEE; the constants folded by the wrapper from the same Python floats).
//
// Four steps on one stream:
// 1. Clear: one cudaMemsetAsync zeroes the workspace: all_k (K), the
//    class rows' used flags (n_cls x K) and the class plane cls_b (n_cls
//    x K x bins), all uint32 in an order-preserving encoding of float32
//    in which 0 sorts below -inf (enc below). Max over encodings is the
//    float max, exact and independent of order, so the atomics give the
//    plain scatter_reduce_'s amax.
// 2. Fold (sky_fold_kernel): a thread a cell over every level, the fine
//    window levels 0..tile_log-1 (a cell's height the max of ceil over
//    its voxels, read from the pack's level-0 rows) and the coarse
//    windows tile_log..top (the pyramid's cells); the level table comes
//    from the wrapper, which computes the windows as the plain version
//    does. A cell the ladder does not select is skipped (the plain
//    version scatters -inf for it, a no-op); a selected one atomicMaxes
//    its bound into all_k[rung] (cells that span every azimuth) or into
//    cls_b[cls, rung, bin], and flags its class row used.
// 3. Dilate (sky_dilate_kernel): a block a rung. Every used class row is
//    loaded into shared memory and dilated by its half-width w in place,
//    by doubling steps (the plain version's roll schedule: 1, 2, 4, ...,
//    the last cut so the half-width is w exactly; the wraparound window
//    is the same set of bins, so the same max), then maxed into the
//    rung's row, which starts at all_k[k]. Unused rows are not read.
// 4. Scan (sky_scan_kernel): a thread a bin takes the cumulative max
//    over the rungs, maps an empty entry (-inf) to -3e38 and writes E
//    transposed through a shared tile, so each warp writes 32 rungs of
//    one row, and S (each block of 16 rungs' last) in the same pass.
//
// What bounds it: bytes. The clear writes the class plane (13 x 512 x
// 8192 x 4 B = 218 MB at tier 1) and the dilate reads its used rows; the
// fold's arithmetic (~60 operations a cell for the ladder's gate, ~400
// more for a selected cell's five atan2f, fmodf and log2f) is below that
// at 67 TFLOP/s on every tier (chip_smoke.py's K10 bound). Launch
// overhead was the plain version's limit; K10 is one memset and three
// launches.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kMaxLevels = 32;
constexpr int kMaxCls = 32;
constexpr int kFoldThreads = 256;
constexpr int kDilThreads = 512;
constexpr int kScanBins = 128;  // bins a scan block: its threads
constexpr int kScanRungs = 32;  // rungs a scan tile: one a lane

struct Level {
  int i0, j0, size;  // the window's first cell (x, z) and edge, in cells
  int dim;           // coarse: the pyramid level's edge
  int lf;            // fine: log2 of the cell's voxels; coarse: -1
  int is_top;        // the top level: no parent gate
  int start;         // the level's first cell in the fold's order
  float c, a_lo, a_hi;  // cell size, the ladder's annulus
  const float* src;  // coarse: the pyramid level (dim x dim)
};

struct FoldArgs {
  Level lv[kMaxLevels];
  int n_levels, n_cells;
  const float* flat;  // the pack (rows, TS * TS)
  int row0, dp, tile_log;
  int bins, K, n_cls;
  float ox, oy, oz;
  float bin_w, log2_d0, log2_g, inv_step;
  float pi, two_pi, wide;                  // float32 pi, 2 pi; the wide cut
  float num_margin, eps_d, eps_rung, eps_cls, eps_far;  // 0.5, 1e-6,
                                                        // 1e-3, 1e-4, 1e-12
  unsigned* all_k;  // (K)
  unsigned* used;   // (n_cls, K)
  unsigned* cls_b;  // (n_cls, K, bins)
};

struct DilArgs {
  const unsigned* all_k;
  const unsigned* used;
  const unsigned* cls_b;
  unsigned* ed;  // (K, bins): the dilated rows, encoded
  int bins, K, n_cls;
  int cls_w[kMaxCls];
};

struct ScanArgs {
  const unsigned* ed;
  float* E;  // (bins, K)
  float* S;  // (bins, sw)
  int bins, K, sw;
  float floor_v;  // -3e38 as float32
};

// float32 -> uint32 preserving order, every float above 0 (the empty
// entry): non-negative floats above 2^31, negative ones below, reversed
__device__ __forceinline__ unsigned enc(float f) {
  const unsigned u = (unsigned)__float_as_int(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float dec(unsigned e) {
  if (e == 0u) return -INFINITY;
  return __int_as_float((int)((e & 0x80000000u) ? (e & 0x7fffffffu) : ~e));
}

// skyline.py's box_d: the nearest and farthest distance in xz from the
// origin to the box [x0, x1] x [z0, z1]
__device__ __forceinline__ void box_d(float x0, float x1, float z0, float z1,
                                      const FoldArgs& a, float* d_min,
                                      float* d_max) {
  const float dx = fmaxf(fmaxf(x0 - a.ox, a.ox - x1), 0.0f);
  const float dz = fmaxf(fmaxf(z0 - a.oz, a.oz - z1), 0.0f);
  *d_min = hypotf(dx, dz);
  if (d_max) {
    const float fx = fmaxf(fabsf(x0 - a.ox), fabsf(x1 - a.ox));
    const float fz = fmaxf(fabsf(z0 - a.oz), fabsf(z1 - a.oz));
    *d_max = hypotf(fx, fz);
  }
}

// JAX's float a % b for b > 0: fmod, moved into [0, b) when negative
__device__ __forceinline__ float jmod(float x, float b) {
  const float r = fmodf(x, b);
  return (r != 0.0f && r < 0.0f) ? r + b : r;
}

__global__ void __launch_bounds__(kFoldThreads)
    sky_fold_kernel(const __grid_constant__ FoldArgs a) {
  const int stride = gridDim.x * blockDim.x;
  for (int i = blockIdx.x * blockDim.x + threadIdx.x; i < a.n_cells;
       i += stride) {
    int l = 0;
    while (l + 1 < a.n_levels && a.lv[l + 1].start <= i) ++l;
    const Level& lv = a.lv[l];
    const int r = i - lv.start;
    const int ii = lv.i0 + r / lv.size, jj = lv.j0 + r % lv.size;
    const float c = lv.c;
    const float x0 = (float)ii * c, z0 = (float)jj * c;
    const float x1 = x0 + c, z1 = z0 + c;
    float d_min, d_max;
    box_d(x0, x1, z0, z1, a, &d_min, &d_max);
    bool sel = d_min >= lv.a_lo;
    if (!lv.is_top && sel) {
      const float pc = 2.0f * c;
      const float px0 = floorf(x0 / pc) * pc, pz0 = floorf(z0 / pc) * pc;
      float pd_min;
      box_d(px0, px0 + pc, pz0, pz0 + pc, a, &pd_min, nullptr);
      sel = pd_min < lv.a_hi;
    }
    if (!sel) continue;  // the plain version scatters -inf: a no-op

    float hm;
    if (lv.lf < 0) {
      hm = lv.src[(int64_t)ii * lv.dim + jj];
    } else {  // the max of ceil over the cell's voxels, one tile's
      const int ts = 1 << a.tile_log, m = ts - 1;
      const int vx = ii << lv.lf, vz = jj << lv.lf, side = 1 << lv.lf;
      const float* row =
          a.flat + ((int64_t)a.row0 + (int64_t)(vx >> a.tile_log) * a.dp +
                    (vz >> a.tile_log)) * (ts * ts);
      hm = -INFINITY;
      for (int u = 0; u < side; ++u)
        for (int v = 0; v < side; ++v)
          hm = fmaxf(hm, ceilf(row[((vx & m) + u) * ts + (vz & m) + v]));
    }
    const float num = (hm + a.num_margin) - a.oy;
    // a cell above the origin divides by its true nearest distance: one
    // that touches or holds the origin blocks its bins (inf)
    float bound = num >= 0.0f ? num / d_min : num / fmaxf(d_max, a.eps_far);
    if (bound != bound) bound = INFINITY;

    // azimuth centre and half-spread from the four corners
    const float ac = atan2f(0.5f * (z0 + z1) - a.oz, 0.5f * (x0 + x1) - a.ox);
    float hw = 0.0f;
    const float gx[4] = {x0, x0, x1, x1}, gz[4] = {z0, z1, z0, z1};
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      float dlt = atan2f(gz[q] - a.oz, gx[q] - a.ox) - ac;
      dlt = jmod(dlt + a.pi, a.two_pi) - a.pi;
      hw = fmaxf(hw, fabsf(dlt));
    }
    if (x0 <= a.ox && a.ox <= x1 && z0 <= a.oz && a.oz <= z1) hw = a.pi;

    float rk = ceilf((log2f(fmaxf(d_min, a.eps_d)) - a.log2_d0) / a.log2_g -
                     a.eps_rung);
    rk = fminf(fmaxf(rk, 0.0f), (float)(a.K - 1));
    const int rung = (int)rk;
    const unsigned v = enc(bound);
    if (hw >= a.wide) {
      atomicMax(a.all_k + rung, v);
      continue;
    }
    const float wb = ceilf(hw / a.bin_w) + 1.0f;
    int cls = (int)ceilf(log2f(fmaxf(wb, 1.0f)) * a.inv_step + a.eps_cls);
    cls = min(max(cls, 0), a.n_cls - 1);
    int cb = (int)floorf(jmod(ac, a.two_pi) / a.bin_w);
    cb = min(max(cb, 0), a.bins - 1);
    const int rowi = cls * a.K + rung;
    if (a.used[rowi] == 0u) a.used[rowi] = 1u;
    atomicMax(a.cls_b + (int64_t)rowi * a.bins + cb, v);
  }
}

__global__ void __launch_bounds__(kDilThreads)
    sky_dilate_kernel(const __grid_constant__ DilArgs a) {
  extern __shared__ unsigned smem[];
  unsigned* acc = smem;
  unsigned* const buf0 = smem + a.bins;
  unsigned* const buf1 = smem + 2 * a.bins;
  const int k = blockIdx.x, bins = a.bins;
  const unsigned floor_v = a.all_k[k];
  for (int b = threadIdx.x; b < bins; b += blockDim.x) acc[b] = floor_v;
  for (int c = 0; c < a.n_cls; ++c) {
    if (a.used[c * a.K + k] == 0u) continue;  // the same for the block
    const unsigned* row = a.cls_b + ((int64_t)c * a.K + k) * bins;
    for (int b = threadIdx.x; b < bins; b += blockDim.x) buf0[b] = row[b];
    __syncthreads();
    int cur = 0;
    const int w = a.cls_w[c];
    for (int h = 0; h < w;) {  // half-width h -> h + s, s <= h + 1
      const int s = min(h + 1, w - h);
      const unsigned* in = cur ? buf1 : buf0;
      unsigned* out = cur ? buf0 : buf1;
      for (int b = threadIdx.x; b < bins; b += blockDim.x) {
        const int lo = b - s < 0 ? b - s + bins : b - s;
        const int hi = b + s >= bins ? b + s - bins : b + s;
        out[b] = max(in[b], max(in[lo], in[hi]));
      }
      __syncthreads();
      cur ^= 1;
      h += s;
    }
    for (int b = threadIdx.x; b < bins; b += blockDim.x)
      acc[b] = max(acc[b], (cur ? buf1 : buf0)[b]);
    __syncthreads();
  }
  unsigned* out = a.ed + (int64_t)k * bins;
  for (int b = threadIdx.x; b < bins; b += blockDim.x) out[b] = acc[b];
}

__global__ void __launch_bounds__(kScanBins)
    sky_scan_kernel(const __grid_constant__ ScanArgs a) {
  __shared__ float tile[kScanBins * (kScanRungs + 1)];
  const int t = threadIdx.x, b0 = blockIdx.x * kScanBins;
  const int lane = t & 31, warp = t >> 5;
  unsigned run = 0u;
  for (int k0 = 0; k0 < a.K; k0 += kScanRungs) {
    const int nk = min(kScanRungs, a.K - k0);
    if (b0 + t < a.bins) {
      for (int kk = 0; kk < nk; ++kk) {
        run = max(run, a.ed[(int64_t)(k0 + kk) * a.bins + b0 + t]);
        const float v = dec(run);
        tile[t * (kScanRungs + 1) + kk] = v == -INFINITY ? a.floor_v : v;
      }
    }
    __syncthreads();
    for (int rr = warp; rr < kScanBins; rr += kScanBins / 32) {
      const int b = b0 + rr, k = k0 + lane;
      if (b < a.bins && lane < nk) {
        const float v = tile[rr * (kScanRungs + 1) + lane];
        a.E[(int64_t)b * a.K + k] = v;
        if ((k & 15) == 15 || k == a.K - 1)
          a.S[(int64_t)b * a.sw + (k >> 4)] = v;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// levels: n_levels records of 7 ints (i0, j0, size, dim, lf, is_top,
// start) and of 3 floats (c, a_lo, a_hi), and a pointer each (the coarse
// level, or null); cls_w: n_cls half-widths; consts: ox, oy, oz, bin_w,
// log2_d0, log2_g, inv_step, pi, two_pi, wide, num_margin, eps_d,
// eps_rung, eps_cls, eps_far, floor_v. ws: K + n_cls * K + n_cls * K *
// bins uint32, ed: K * bins uint32, both scratch.
extern "C" int voxt_sky_env(const void* flat, int row0, int dp, int tile_log,
                            const int* level_ints, const float* level_floats,
                            const void* const* level_src, int n_levels,
                            int n_cells, const int* cls_w, int n_cls,
                            const float* consts, int bins, int K, int sw,
                            void* ws, void* ed, void* E, void* S,
                            void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_cls < 1 || n_cls > kMaxCls ||
      bins < 2 || K < 1 || sw != (K + 15) / 16 || n_cells < 1 ||
      (int64_t)n_cls * K * bins >= (1ll << 31))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  unsigned* w = (unsigned*)ws;
  const int64_t n_ws = (int64_t)K + (int64_t)n_cls * K +
                       (int64_t)n_cls * K * bins;
  cudaError_t err = cudaMemsetAsync(w, 0, n_ws * sizeof(unsigned), st);
  if (err != cudaSuccess) return (int)err;

  FoldArgs f;
  for (int l = 0; l < n_levels; ++l) {
    const int* li = level_ints + 7 * l;
    const float* lf = level_floats + 3 * l;
    f.lv[l] = Level{li[0], li[1], li[2], li[3], li[4], li[5], li[6],
                    lf[0], lf[1], lf[2], (const float*)level_src[l]};
  }
  f.n_levels = n_levels;
  f.n_cells = n_cells;
  f.flat = (const float*)flat;
  f.row0 = row0;
  f.dp = dp;
  f.tile_log = tile_log;
  f.bins = bins;
  f.K = K;
  f.n_cls = n_cls;
  f.ox = consts[0];
  f.oy = consts[1];
  f.oz = consts[2];
  f.bin_w = consts[3];
  f.log2_d0 = consts[4];
  f.log2_g = consts[5];
  f.inv_step = consts[6];
  f.pi = consts[7];
  f.two_pi = consts[8];
  f.wide = consts[9];
  f.num_margin = consts[10];
  f.eps_d = consts[11];
  f.eps_rung = consts[12];
  f.eps_cls = consts[13];
  f.eps_far = consts[14];
  f.all_k = w;
  f.used = w + K;
  f.cls_b = w + K + n_cls * K;
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int fold_blocks =
      min((n_cells + kFoldThreads - 1) / kFoldThreads, 8 * sms);
  sky_fold_kernel<<<fold_blocks, kFoldThreads, 0, st>>>(f);

  DilArgs d;
  d.all_k = f.all_k;
  d.used = f.used;
  d.cls_b = f.cls_b;
  d.ed = (unsigned*)ed;
  d.bins = bins;
  d.K = K;
  d.n_cls = n_cls;
  for (int c = 0; c < n_cls; ++c) d.cls_w[c] = cls_w[c];
  const size_t smem = 3 * (size_t)bins * sizeof(unsigned);
  err = cudaFuncSetAttribute(sky_dilate_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  sky_dilate_kernel<<<K, kDilThreads, smem, st>>>(d);

  ScanArgs s;
  s.ed = d.ed;
  s.E = (float*)E;
  s.S = (float*)S;
  s.bins = bins;
  s.K = K;
  s.sw = sw;
  s.floor_v = consts[15];
  sky_scan_kernel<<<(bins + kScanBins - 1) / kScanBins, kScanBins, 0, st>>>(
      s);
  return (int)cudaGetLastError();
}
