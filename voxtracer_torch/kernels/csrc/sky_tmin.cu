// K5: per-ray certified-air t_min from the per-pose horizon envelope.
//
// Replaces: voxtracer/kernels/skyline.py, skyline_env_tmin_traced (a jnp
// function on the TPU, no Pallas kernel; XLA fused its per-lane row
// gather). Same result as skyline_env_tmin_plain in
// voxtracer_torch/kernels/skyline.py: the plain version counts the rungs
// of a gathered (B, K) row, which at a batch-8 call at 8192^3 (3,275,520
// lanes, K = 512) is 6.7 GB of rows; this kernel gathers nothing. Built
// with --fmad=false so each product and sum rounds on its own, as in the
// plain version.
//
// Per ray: the azimuth bin from atan2f, the margin-adjusted elevation
// slope tan_adj, then k* = #{k : E[bin, k] < tan_adj}. Each row of E is
// nondecreasing in k (the build ends in a cumulative max over rungs, its
// -3e38 floor and +inf blocks kept in order), so that count is the row's
// lower bound of tan_adj, and any search for that bound gives the full
// count's integer. Then d_{k*-1} = exp2(log2 d0 + (k* - 1) log2 g) and
// t_min = max(d - ENV_SLACK, 0) / |d_xz|; 0 where k* == 0, far where
// k* == K.
//
// What bounds it on the card: the least time is bytes (a ray's direction
// read, 12 B, and t_min written, 4 B; each table row the rays reach read
// once), but a search's row reads depend on each other, and rays of one
// warp that read different rows read different L2 sectors: a binary
// search over E takes ceil(log2(K + 1)) = 10 dependent loads at K = 512,
// and 32 neighbouring pixels of one image row span 20-32 azimuth bins of
// 360/8192 degrees, so in lane order each step costs about one 32-B
// sector a lane. Past the search, the per-ray arithmetic (atan2f, hypotf,
// three IEEE divisions, exp2f) and the lane bookkeeping cost instruction
// throughput.
//
// The design:
// 1. Rays that share a row share a warp. Given the set's image shape (S
//    samples of an H x W frame, lanes (s, y, x)), a block takes a tile of
//    8 columns x TY rows x SG samples (SG the largest power of two up to
//    min(S, 32), TY = 32 / SG; a 3-axis grid, no division) and a warp
//    one column of it: its 32 rays lie within a few pixels and jitters of
//    each other (at batch-8 width ~5 rows a warp, against 31 in lane
//    order), and their loads coincide. Directions come into shared
//    memory and t_min goes out through it, a thread a pixel of a row
//    segment (a warp moves 4 segments of 8 neighbouring pixels: 96 B in,
//    32 B out each), so global reads and writes stay as coalesced as in
//    lane order. Ragged tile edges are masked. A set without an image
//    shape runs in lane order, a thread a lane.
// 2. A two-level search. S (skyline.env_summary, made with the table)
//    holds the last rung of each block of 16 of every row. A binary
//    search over the row's summary (one 128-B line at K = 512) gives c,
//    the blocks wholly below tan_adj; one over block c of E (64 B) gives
//    k*, the lower bound there. The same 10 dependent loads, but a row's
//    search touches 2 lines instead of up to 10, so a warp's stay in L1.
//    Counting the summary and the block with float4 loads instead (2
//    round trips) was slower on the card: 12 wide loads a lane (PERF.md).
// The azimuth skips the reference's fmod by 2 pi: atan2f lies in [-pi,
// pi], where that fmod is the identity, exactly.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr float kRelMargin = 1e-5f;
constexpr float kAbsMargin = 1e-6f;
constexpr float kEnvSlack = 2.0f;
constexpr float kBig = 3e38f;
constexpr int kBlk = 16;       // rungs a summary entry stands for
constexpr int kThreads = 256;
constexpr int kTileX = 8;      // image columns a block: one a warp
constexpr int kSegs = 32;      // row segments a block: TY x SG
constexpr int kSeg = 3 * kTileX;   // floats of one segment's directions
constexpr int kSegPad = kSeg + 1;  // odd strides: a warp's 32 segments
constexpr int kOutPad = kTileX + 1;  // fall in 32 different banks

struct SkyArgs {
  const float* E;    // (bins, K)
  const float* S;    // (bins, sw = ceil(K / 16)): E[:, min(16 j + 15, K-1)]
  const float* dir;
  float* t_min;
  int bins, K, sw, n;
  int img_s, img_h, img_w;       // image shape; img_w == 0: lane order
  int sg_log, ty_log;            // log2 SG, log2 TY
  float bin_w, log2_d0, log2_g, far;
};

__device__ __forceinline__ float ray_tmin(float dx, float dy, float dz,
                                          const SkyArgs& a) {
  // azimuth bin: (atan2 % 2pi) / bin_w, % as JAX takes it for floats;
  // |atan2f| <= pi < 2 pi, so its fmod by 2 pi is itself, exactly
  float m = atan2f(dz, dx);
  if (m < 0.0f) m = m + kTwoPi;
  int cb = (int)floorf(m / a.bin_w);
  cb = cb < 0 ? 0 : (cb > a.bins - 1 ? a.bins - 1 : cb);
  const float xz = hypotf(dx, dz);
  float slope;
  if (xz > 0.0f)
    slope = dy / fmaxf(xz, 1e-30f);
  else
    slope = dy >= 0.0f ? kBig : -kBig;
  const float tan_adj = fabsf(slope) >= kBig
                            ? slope
                            : slope - (kRelMargin * fabsf(slope) + kAbsMargin);
  // level 1: c = the summary entries below tan_adj, the blocks of the
  // row wholly below it (a lower bound over one short row)
  const int nblk = a.sw;
  const float* srow = a.S + cb * a.sw;
  int c = 0;
  for (int hi = nblk; c < hi;) {
    const int mid = (c + hi) >> 1;
    if (__ldg(srow + mid) < tan_adj)
      c = mid + 1;
    else
      hi = mid;
  }
  // level 2: the lower bound inside block c, whose last rung is not
  // below tan_adj
  int ks = a.K;
  if (c < nblk) {
    const float* row = a.E + cb * a.K;
    int hi = min(c * kBlk + kBlk, a.K) - 1;
    ks = c * kBlk;
    while (ks < hi) {
      const int mid = (ks + hi) >> 1;
      if (__ldg(row + mid) < tan_adj)
        ks = mid + 1;
      else
        hi = mid;
    }
  }
  if (ks == 0) return 0.0f;
  if (ks == a.K) return a.far;
  const float dk = exp2f(a.log2_d0 + (float)(ks - 1) * a.log2_g);
  return fmaxf(dk - kEnvSlack, 0.0f) / fmaxf(xz, 1e-30f);
}

__global__ void __launch_bounds__(kThreads)
    sky_tmin_kernel(const __grid_constant__ SkyArgs a) {
  if (a.img_w == 0) {  // lane order
    const int i = blockIdx.x * kThreads + threadIdx.x;
    if (i < a.n)
      a.t_min[i] = ray_tmin(a.dir[3 * i], a.dir[3 * i + 1], a.dir[3 * i + 2],
                            a);
    return;
  }
  // the block's tile: columns x0 .. x0 + 7, rows y0 .. y0 + TY - 1 of
  // samples s0 .. s0 + SG - 1; segment q = ss * TY + yy is row y0 + yy of
  // sample s0 + ss. Thread (q, e) = (tid / 8, tid % 8) moves pixel x0 + e
  // of segment q in (3 floats) and out (t_min): a warp, 4 segments of 8
  // neighbouring pixels
  __shared__ float sdir[kSegs * kSegPad];
  __shared__ float sout[kSegs * kOutPad];
  const int x0 = blockIdx.x * kTileX;
  const int y0 = blockIdx.y << a.ty_log, s0 = blockIdx.z << a.sg_log;
  const int q = threadIdx.x / kTileX, e = threadIdx.x % kTileX;
  const int s = s0 + (q >> a.ty_log);
  const int y = y0 + (q & ((1 << a.ty_log) - 1));
  const bool mine = s < a.img_s && y < a.img_h && x0 + e < a.img_w;
  const int pix = (s * a.img_h + y) * a.img_w + x0 + e;
  if (mine) {
    float* p = sdir + q * kSegPad + 3 * e;
    p[0] = a.dir[3 * pix];
    p[1] = a.dir[3 * pix + 1];
    p[2] = a.dir[3 * pix + 2];
  }
  __syncthreads();
  {  // warp = column xl; lane = yy * SG + ss, samples fastest
    const int xl = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int ss = lane & ((1 << a.sg_log) - 1), yy = lane >> a.sg_log;
    const int r = (ss << a.ty_log) + yy;
    if (s0 + ss < a.img_s && y0 + yy < a.img_h && x0 + xl < a.img_w) {
      const float* p = sdir + r * kSegPad + 3 * xl;
      sout[r * kOutPad + xl] = ray_tmin(p[0], p[1], p[2], a);
    }
  }
  __syncthreads();
  if (mine) a.t_min[pix] = sout[q * kOutPad + e];
}

}  // namespace

extern "C" int voxt_sky_tmin(const void* E, const void* S, int bins, int K,
                             int sw, const void* dir, int n, int img_s,
                             int img_h, int img_w, float bin_w,
                             float log2_d0, float log2_g, float far,
                             void* t_min, void* stream) {
  if (n <= 0) return 0;
  // 32-bit indices: 3 floats a lane, and the table's entries
  if (n > (1 << 28) || (int64_t)bins * K >= (1ll << 31) || bins < 1 ||
      K < 1 || sw != (K + kBlk - 1) / kBlk)
    return (int)cudaErrorInvalidValue;
  SkyArgs a;
  a.E = (const float*)E;
  a.S = (const float*)S;
  a.dir = (const float*)dir;
  a.t_min = (float*)t_min;
  a.bins = bins;
  a.K = K;
  a.sw = sw;
  a.n = n;
  a.bin_w = bin_w;
  a.log2_d0 = log2_d0;
  a.log2_g = log2_g;
  a.far = far;
  if (img_w > 0 && img_h > 0 && img_s > 0) {
    if ((int64_t)img_s * img_h * img_w != n) return (int)cudaErrorInvalidValue;
    int sg_log = 0;
    while (sg_log < 5 && (2 << sg_log) <= img_s) ++sg_log;
    a.img_s = img_s;
    a.img_h = img_h;
    a.img_w = img_w;
    a.sg_log = sg_log;
    a.ty_log = 5 - sg_log;
    const dim3 grid((img_w + kTileX - 1) / kTileX,
                    (img_h + (1 << a.ty_log) - 1) >> a.ty_log,
                    (img_s + (1 << sg_log) - 1) >> sg_log);
    if (grid.y > 65535 || grid.z > 65535) return (int)cudaErrorInvalidValue;
    sky_tmin_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(a);
  } else {
    a.img_s = a.img_h = a.img_w = 0;
    a.sg_log = a.ty_log = 0;
    sky_tmin_kernel<<<(n + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>(a);
  }
  return (int)cudaGetLastError();
}
