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
// Per ray (one thread): the azimuth bin from atan2f, the margin-adjusted
// elevation slope tan_adj, then k* = #{k : E[bin, k] < tan_adj}. Each row
// of E is nondecreasing in k (the build ends in a cumulative max over
// rungs, its -3e38 floor and +inf blocks kept in order), so that count is
// the row's lower bound of tan_adj: a binary search of ceil(log2(K + 1))
// steps finds the same integer as the full count. Then d_{k*-1} =
// exp2(log2 d0 + (k* - 1) log2 g) and t_min = max(d - ENV_SLACK, 0) /
// |d_xz|; 0 where k* == 0, far where k* == K.
//
// What bounds it on the card: bytes. A ray reads its direction (12 B) and
// writes t_min (4 B); of the table (8192 x 512 floats, 16 MiB) only the
// rows of the rays' azimuth bins are read (a camera's view reaches about
// a third of them), at most once from device memory, then from the 50 MB
// L2. The
// arithmetic is ~60 float operations and 10 dependent loads of the row a
// ray. The binary search's loads depend on each other, so a warp waits
// on L2 latency ten times; many warps an SM hide it. Fusing the lookup
// into K4's prologue would save the t_min round trip (a later redesign).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kTwoPi = 6.28318548202514648f;  // float32(2 pi)
constexpr float kRelMargin = 1e-5f;
constexpr float kAbsMargin = 1e-6f;
constexpr float kEnvSlack = 2.0f;
constexpr float kBig = 3e38f;

struct SkyArgs {
  const float* E;
  const float* dir;
  float* t_min;
  int bins, K, n;
  float bin_w, log2_d0, log2_g, far;
};

__global__ void __launch_bounds__(256)
    sky_tmin_kernel(const __grid_constant__ SkyArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float dx = a.dir[3 * i], dy = a.dir[3 * i + 1],
              dz = a.dir[3 * i + 2];
  // azimuth bin: (atan2 % 2pi) / bin_w, % as JAX takes it for floats
  float m = fmodf(atan2f(dz, dx), kTwoPi);
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
  // lower bound of tan_adj in the nondecreasing row
  const float* row = a.E + (int64_t)cb * a.K;
  int lo = 0, hi = a.K;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (__ldg(row + mid) < tan_adj)
      lo = mid + 1;
    else
      hi = mid;
  }
  const int ks = lo;
  float t;
  if (ks == 0) {
    t = 0.0f;
  } else if (ks == a.K) {
    t = a.far;
  } else {
    const float dk = exp2f(a.log2_d0 + (float)(ks - 1) * a.log2_g);
    t = fmaxf(dk - kEnvSlack, 0.0f) / fmaxf(xz, 1e-30f);
  }
  a.t_min[i] = t;
}

}  // namespace

extern "C" int voxt_sky_tmin(const void* E, int bins, int K, const void* dir,
                             int n, float bin_w, float log2_d0, float log2_g,
                             float far, void* t_min, void* stream) {
  if (n <= 0) return 0;
  if (bins < 1 || K < 1) return (int)cudaErrorInvalidValue;
  SkyArgs a;
  a.E = (const float*)E;
  a.dir = (const float*)dir;
  a.t_min = (float*)t_min;
  a.bins = bins;
  a.K = K;
  a.n = n;
  a.bin_w = bin_w;
  a.log2_d0 = log2_d0;
  a.log2_g = log2_g;
  a.far = far;
  const int threads = 256;
  sky_tmin_kernel<<<(n + threads - 1) / threads, threads, 0,
                    (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
