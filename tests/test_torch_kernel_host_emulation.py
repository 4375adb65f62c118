"""The CUDA sources of K2 (csrc/svo_cast.cu), K4 (csrc/hf_cast.cu), K1
(csrc/fog_march.cu), lane fetch (csrc/lanes.cuh) and the walk headers
included, K3 (csrc/resolve_fold.cu), K5 (csrc/sky_tmin.cu), K6
(csrc/beam_walk.cu), K7 (csrc/beam_resolve.cu), K8 (csrc/bit_dda.cu) and
K9 (csrc/path_trace.cu), compiled for the host
and run under a small emulation of the CUDA features they use: every
thread of a block is a std::thread (grids of up to three axes), the 32
threads of a warp meet at a barrier for each warp collective
(__ballot_sync, __shfl_sync, __shfl_xor_sync, __syncwarp), blocks run one
after another, and the "card" has 2 SMs of 2 blocks. It runs the
kernels' real scheduling code on the CPU: the round-robin and claimed
lanes, the per-warp queue, the refills, and the outputs of inactive
lanes; K3's ray chunks, per-octant stages, candidate spans and their
merge.

K3 must equal its plain versions bit for bit in both forms, for every
ray tile and span count; a build whose spans merge out of order, or by t
alone, must not.

K2 and K4 must equal their plain versions bit for bit (their float
operations are IEEE on both sides). K1 calls expf, and the host's expf differs from
torch.exp in the last bit for ~1% of inputs, so K1 is held bit for bit
to itself under every lane-fetch setting and mask; against its plain
version, its codes may differ on 0.5% of the lanes, a planet hit's t by
an ulp of the planet-scale terms it cancels, and a scatter point by
about one segment. K5 calls atan2f, hypotf and exp2f, which may differ
from torch's in the last bit: a lane whose azimuth or slope lies on a
boundary may land one bin or one rung over (at most 2 lanes in 4096, the
smoke's graze share), and every other lane's t_min is within 1e-6
relative; its two-level search over the row must give the full count's
rung (the nondecreasing rows make them one), in image order (pixel
tiles, directions and t_min through shared memory, ragged edges masked)
and in lane order alike. Against the binary search of the kernel's first
form (BSEARCH_SKY_TMIN, built under the same shim and host libm), t_min is
equal by bits in every lane: the same rung everywhere.

K6, K7 and K8 must equal their plain versions bit for bit: the walk's
candidates and its resumed state over several rounds (with pauses), the
resolve's five outputs with a shared origin and with one origin a ray,
and the bit-grid DDA's four outputs (its walker, bit_walk.cuh, on the
lane fetch) with caps and masks, under every lane-fetch setting.

K9 runs a bounce of every live path as stage kernels over queues of
paths (the planet draw and the scatter-free test, K1's march, the world
cast with K2's, K4's or K8's walk, the sun march, the shadow cast, the
end of the bounce), one launch each. On each of its engines (the
heightfield with and without the sun maps, the edited heightfield, the
SVO, the bit grid), its returned RNG state must equal the masked loop's
(trace_paths_plain) by bits in every lane, dead or alive, which holds
its burn pass; its radiance is held to the golden contract (0.5% of
values beyond 1e-3, means within 1e-3), since the host's expf, logf,
sinf and cosf are not torch's; its walk-step counts to the plain walks'
within 2%; its count of the NEE lanes the sun maps settled to the masked
loop's; with the maps, its radiance and state to its own without them
by bits; its queue lengths to the paths' last bounces and its march
counts; and K9 to itself by bits under every lane-fetch setting.

The scatter-free test of the march (fog_walk.cuh, in K1 and K9's
stages) is fuzzed against the full march of the same source: every
lane's (code, t) by bits, its bound above the sum of the segment
densities, at 1, 64 and 256 segments. K1's work counts (the marches the
test settled, the segments marched) must equal that lane-by-lane
model's.

Needs g++ with C++20 (<barrier>); skips without it.
"""

import ctypes
import ctypes.util
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.core.spectra import fog_density
from voxtracer_torch.kernels import (beam, bitdda, build, fog, heightfield,
                                     integrator, resolve, traverse)
from voxtracer_torch.world import svo, worldgen

torch.set_num_threads(2)

SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstring>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
#define __grid_constant__
#define __shared__ static
struct dim3_ { unsigned x = 0, y = 0, z = 0; };
inline thread_local dim3_ threadIdx, blockIdx;
inline dim3_ blockDim, gridDim;
typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1,
       cudaDevAttrMultiProcessorCount = 16 };
inline int cudaGetDevice(int* d) { *d = 0; return 0; }
inline int cudaDeviceGetAttribute(int* v, int, int) { *v = 2; return 0; }
template <class K>
int cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* v, K, int, size_t) {
  *v = 2; return 0;
}
inline int cudaGetLastError() { return 0; }
enum { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
template <class K> int cudaFuncSetAttribute(K, int, int) { return 0; }
inline int cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  memset(p, v, n);
  return 0;
}
struct EmuWarp { std::barrier<> bar{32}; unsigned vals[32]; };
inline thread_local EmuWarp* t_warp = nullptr;
inline std::barrier<>* g_block_bar = nullptr;
inline int* g_dyn_smem = nullptr;
inline unsigned __ballot_sync(unsigned, bool p) {
  t_warp->vals[threadIdx.x & 31] = p;
  t_warp->bar.arrive_and_wait();
  unsigned r = 0;
  for (int j = 0; j < 32; ++j) r |= (t_warp->vals[j] ? 1u : 0u) << j;
  t_warp->bar.arrive_and_wait();
  return r;
}
inline int __shfl_sync(unsigned, int v, int src) {
  t_warp->vals[threadIdx.x & 31] = (unsigned)v;
  t_warp->bar.arrive_and_wait();
  const int r = (int)t_warp->vals[src];
  t_warp->bar.arrive_and_wait();
  return r;
}
inline int __popc(unsigned x) { return __builtin_popcount(x); }
inline void __syncwarp() { t_warp->bar.arrive_and_wait(); }
inline void __syncthreads() { g_block_bar->arrive_and_wait(); }
inline int atomicAdd(int* p, int v) {
  return std::atomic_ref<int>(*p).fetch_add(v);
}
template <class T> T __ldg(const T* p) { return *p; }
using std::max;
using std::min;
template <class T> T __shfl_xor_sync(unsigned, T v, int mask) {
  t_warp->vals[threadIdx.x & 31] = (unsigned)v;
  t_warp->bar.arrive_and_wait();
  const T r = (T)t_warp->vals[(threadIdx.x & 31) ^ mask];
  t_warp->bar.arrive_and_wait();
  return r;
}
inline unsigned __reduce_add_sync(unsigned, unsigned v) {
  t_warp->vals[threadIdx.x & 31] = v;
  t_warp->bar.arrive_and_wait();
  unsigned r = 0;
  for (int j = 0; j < 32; ++j) r += t_warp->vals[j];
  t_warp->bar.arrive_and_wait();
  return r;
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  t_warp->vals[threadIdx.x & 31] = v;
  t_warp->bar.arrive_and_wait();
  unsigned r = 0;
  for (int j = 0; j < 32; ++j) r = std::max(r, t_warp->vals[j]);
  t_warp->bar.arrive_and_wait();
  return r;
}
inline unsigned long long atomicAdd(unsigned long long* p,
                                    unsigned long long v) {
  return std::atomic_ref<unsigned long long>(*p).fetch_add(v);
}
inline int atomicMax(int* p, int v) {
  std::atomic_ref<int> a(*p);
  int old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {}
  return old;
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old < v && !a.compare_exchange_weak(old, v)) {}
  return old;
}
inline unsigned atomicMin(unsigned* p, unsigned v) {
  std::atomic_ref<unsigned> a(*p);
  unsigned old = a.load();
  while (old > v && !a.compare_exchange_weak(old, v)) {}
  return old;
}
inline int __float_as_int(float f) { int i; memcpy(&i, &f, 4); return i; }
inline float __int_as_float(int i) { float f; memcpy(&f, &i, 4); return f; }
inline int __vimax3_s32(int a, int b, int c) { return max(max(a, b), c); }
inline int __vimin3_s32(int a, int b, int c) { return min(min(a, b), c); }
struct alignas(8) float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) int4 { int x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return float4{x, y, z, w};
}
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1)
      : x(x_), y(y_), z(z_) {}
};
template <class K, class... A>
void emu_launch(K kernel, dim3 grid, int threads, size_t smem, cudaStream_t,
                A... args) {
  blockDim.x = threads;
  gridDim.x = grid.x;
  gridDim.y = grid.y;
  gridDim.z = grid.z;
  std::vector<int> dyn(smem / sizeof(int) + 1);
  for (unsigned b = 0; b < grid.x * grid.y * grid.z; ++b) {
    std::barrier<> block_bar(threads);
    g_block_bar = &block_bar;
    g_dyn_smem = dyn.data();
    std::vector<EmuWarp> warps((threads + 31) / 32);
    std::vector<std::thread> ts;
    for (int x = 0; x < threads; ++x)
      ts.emplace_back([&, x, b] {
        threadIdx.x = x;
        blockIdx.x = b % grid.x;
        blockIdx.y = b / grid.x % grid.y;
        blockIdx.z = b / grid.x / grid.y;
        t_warp = &warps[x / 32];
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
"""

# builds of K3 that must fail: the spans merged last to first, and merged
# by t alone (<= lets a later span take an equal t)
FOLD_MUTANTS = {
    "fold_reversed_merge": ("for (int s = 1; s < a.spans; ++s) {",
                            "for (int s = a.spans - 1; s >= 1; --s) {"),
    "fold_merge_by_t": ("if (js >= 0 && res[0] < lim[q]) {",
                        "if (js >= 0 && res[0] <= lim[q]) {"),
}

# K5 in its first form, a thread a lane and a binary search of the row
# (C entry: E, bins, K, dir, n, bin_w, log2_d0, log2_g, far, t_min,
# stream): the new kernel must find the same rung in every lane
BSEARCH_SKY_TMIN = r"""
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
namespace {
constexpr float kTwoPi = 6.28318548202514648f;
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
__global__ void sky_tmin_kernel(const SkyArgs a) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= a.n) return;
  const float dx = a.dir[3 * i], dy = a.dir[3 * i + 1],
              dz = a.dir[3 * i + 2];
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
  SkyArgs a{(const float*)E, (const float*)dir, (float*)t_min, bins, K, n,
            bin_w, log2_d0, log2_g, far};
  sky_tmin_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
"""
BSEARCH_SIGNATURE = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int,
                     ctypes.c_void_p, ctypes.c_int, ctypes.c_float,
                     ctypes.c_float, ctypes.c_float, ctypes.c_float,
                     ctypes.c_void_p, ctypes.c_void_p)

# The march of fog_walk.cuh three ways, lane by lane: the full march with
# no scatter-free test, K1's (the test, then the march if it does not
# settle), and the test's bound D against the sum of the segment
# densities the march computes (step()'s float expressions, summed in
# double with y0 infinite). C entry: start, dir, density, y0, n, n_steps,
# planet_r, planet_r2, fog_r2, fog_factor, code_full, t_full, code_k1,
# t_k1, settled (1, 0, or -1 where setup() settled the lane), bound, sum,
# segments K1 marches
FOG_CERTIFY = r"""
#include <cuda_runtime.h>
#include <math.h>
#include "fog_walk.cuh"
extern "C" int voxt_fog_certify(
    const float* start, const float* dir, const float* density,
    const float* y0, int n, int n_steps, float planet_r, float planet_r2,
    float fog_r2, float fog_factor, int* code_full, float* t_full,
    int* code_k1, float* t_k1, int* settled, double* bound, double* sum,
    int* segs) {
  static float fa[voxt::kFogMaxSteps + 1], fb[voxt::kFogMaxSteps + 1];
  blockDim.x = 1;
  threadIdx.x = 0;
  voxt::fog_fractions(fa, fb, n_steps);
  voxt::FogWalk base;
  base.frac_a = fa;
  base.frac_b = fb;
  base.n_steps = n_steps;
  base.planet_r = planet_r;
  base.planet_r2 = planet_r2;
  base.fog_r2 = fog_r2;
  base.fog_factor = fog_factor;
  for (int i = 0; i < n; ++i) {
    const float* o = start + 3 * i;
    const float* d = dir + 3 * i;
    voxt::FogWalk w = base;
    settled[i] = -1;
    bound[i] = NAN;
    sum[i] = 0.0;
    if (w.setup(o[0], o[1], o[2], d[0], d[1], d[2], density[i], y0[i])) {
      settled[i] = w.scatter_free();
      bound[i] = w.scatter_bound();
      double acc = 0.0;
      for (int s = 0; s < n_steps; ++s) {
        const float t_s1 = fa[s + 1] * w.t0 + fb[s + 1] * w.t1;
        const float sx = w.px + w.dx * t_s1;
        const float sy = w.pyr + w.dy * t_s1;
        const float sz = w.pz + w.dz * t_s1;
        const float alt = sqrtf(sx * sx + sy * sy + sz * sz) - w.planet_r;
        acc += (double)(w.density_scaled * expf(-alt * w.fog_factor));
      }
      sum[i] = acc;
      while (w.step()) {
      }
    }
    code_full[i] = w.code;
    t_full[i] = w.t;
    voxt::FogWalk k = base;
    segs[i] = 0;
    if (k.setup(o[0], o[1], o[2], d[0], d[1], d[2], density[i], y0[i])) {
      if (k.scatter_free())
        k.settle();
      else
        while (++segs[i], k.step()) {
        }
    }
    code_k1[i] = k.code;
    t_k1[i] = k.t;
  }
  return 0;
}
"""
FOG_CERTIFY_SIGNATURE = (ctypes.c_void_p,) * 4 + (ctypes.c_int,) * 2 + (
    ctypes.c_float,) * 4 + (ctypes.c_void_p,) * 8

# lane-fetch settings (static percent, chunk, refill): the wrappers' and
# the corners
FETCHES = [(traverse.STATIC_PCT, traverse.CHUNK, traverse.REFILL),
           (fog.STATIC_PCT, fog.CHUNK, fog.REFILL), (0, 32, 32),
           (100, 64, 1), (50, 96, 16)]


def _host_source(src: str) -> str:
    src = re.sub(r"extern __shared__ (?:__align__\(\d+\) )?(\w+) smem\[\];",
                 r"\1* smem = reinterpret_cast<\1*>(g_dyn_smem);", src)
    return re.sub(r"(\w+)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", src)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "cuda_runtime.h").write_text(SHIM)
    for header in build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    libs = {}
    procs = []
    fold_src = (build.CSRC / "resolve_fold.cu").read_text()
    sources = {name: (build.CSRC / f"{name}.cu").read_text()
               for name in ("svo_cast", "fog_march", "hf_cast", "sky_tmin",
                            "beam_walk", "beam_resolve", "bit_dda",
                            "path_trace", "sky_env")}
    sources["resolve_fold"] = fold_src
    sources["sky_bsearch"] = BSEARCH_SKY_TMIN
    sources["fog_certify"] = FOG_CERTIFY
    for name, (old, new) in FOLD_MUTANTS.items():
        assert fold_src.count(old) == 1, name
        sources[name] = fold_src.replace(old, new)
    for name, text in sources.items():
        cpp = out / f"{name}.cpp"
        cpp.write_text(_host_source(text))
        so = out / f"{name}.so"
        procs.append((name, so, subprocess.Popen(
            [gxx, "-std=c++20", "-O1", "-ffp-contract=off", "-fno-fast-math",
             "-Wno-unknown-pragmas", "-pthread", "-shared", "-fPIC",
             f"-I{out}", "-o", str(so), str(cpp)],
            stderr=subprocess.PIPE, text=True)))
    for name, so, p in procs:
        _, err = p.communicate()
        if p.returncode != 0 and "barrier" in err:
            pytest.skip(f"g++ lacks C++20 <barrier>: {err[:200]}")
        assert p.returncode == 0, err
        lib = ctypes.CDLL(str(so))
        entries = [f"voxt_{name}"] \
            if name in ("svo_cast", "fog_march", "hf_cast", "sky_tmin",
                        "beam_walk", "beam_resolve", "bit_dda",
                        "path_trace", "sky_env") \
            else ["voxt_sky_tmin"] if name == "sky_bsearch" \
            else ["voxt_fog_certify"] if name == "fog_certify" \
            else ["voxt_resolve_fold", "voxt_resolve_fold_seg"]
        fns = []
        for entry in entries:
            fn = getattr(lib, entry)
            fn.argtypes = list(BSEARCH_SIGNATURE if name == "sky_bsearch"
                               else FOG_CERTIFY_SIGNATURE
                               if name == "fog_certify"
                               else build.SIGNATURES[entry])
            fn.restype = ctypes.c_int
            fns.append(fn)
        libs[name] = fns[0] if len(fns) == 1 else tuple(fns)
    return libs


@pytest.fixture(scope="module")
def world():
    dev = worldgen.generate(log2_size=6, verbose=False, device="cpu").serialize()
    return svo.upload(dev.table, dev.root, dev.height, "cpu")


def _svo_rays(rng, B, n):
    """Camera rays for the first third, random rays with random caps."""
    start = rng.random((B, 3), np.float32) * np.float32(n)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[: B // 16, 1] = 0.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    s = n / 8192
    cam = vcam.Camera(pos=tuple(np.asarray(vcam.DEFAULT_POSE.pos) * s),
                      yaw=vcam.DEFAULT_POSE.yaw, pitch=vcam.DEFAULT_POSE.pitch)
    _, cd = vcam.generate_rays(cam, 48, 32, device="cpu")
    k = min(B // 3, 48 * 32)
    start[:k] = np.asarray(cam.pos, np.float32)
    d[:k] = cd.reshape(-1, 3).numpy()[:k]
    dist = np.where(rng.random(B) < 0.5, np.float32(traverse.FAR),
                    rng.random(B, np.float32) * np.float32(2 * n))
    return (torch.from_numpy(start), torch.from_numpy(d),
            torch.from_numpy(dist.astype(np.float32)))


def _svo_host(fn, w, start, d, dist, active, fetch):
    B = d.shape[0]
    out = dict(hit=torch.full((B,), True), t=torch.full((B,), 7.0),
               node=torch.full((B,), 7, dtype=torch.int32),
               normal=torch.full((B, 3), 7.0),
               voxel=torch.full((B, 3), 7, dtype=torch.int32))
    counter = torch.zeros(1, dtype=torch.int32)
    err = fn(w.table.data_ptr(), w.root, w.height, start.data_ptr(),
             d.data_ptr(), dist.data_ptr(),
             None if active is None else active.data_ptr(), 1,
             out["hit"].data_ptr(), out["t"].data_ptr(), out["node"].data_ptr(),
             out["normal"].data_ptr(), out["voxel"].data_ptr(), B,
             counter.data_ptr(), *fetch, None)
    assert err == 0
    return out


@pytest.mark.parametrize("fetch", FETCHES)
@pytest.mark.parametrize("B,frac", [(1, 1.0), (37, 0.5), (1000, None),
                                    (2500, 0.3), (4099, 0.02)])
def test_svo_cast_source_equals_plain(host_kernels, world, B, frac, fetch):
    rng = np.random.default_rng(B)
    start, d, dist = _svo_rays(rng, B, float(1 << world.height))
    active = None if frac is None else torch.from_numpy(rng.random(B) < frac)
    got = _svo_host(host_kernels["svo_cast"], world, start, d, dist, active,
                    fetch)
    want = traverse.svo_raycast_plain(world.table, world.root, world.height,
                                      start, d, dist, True, active)
    for key in ("hit", "t", "node", "normal", "voxel"):
        # bits, so that a -0.0 for a 0.0 would show
        assert np.array_equal(got[key].numpy().view(np.uint8),
                              want[key].numpy().view(np.uint8)), key
    if B > 1:
        assert want["hit"].any()


@pytest.fixture(scope="module")
def hf_world():
    """A 64^3 terrain world: its pack at tile logs 3 and 2 (the second
    with a partial top grid) and its exact column heights."""
    space = worldgen.generate(log2_size=6, verbose=False, device="cpu")
    packs = [heightfield.build_height_mips(space.heights, tile_log=tl,
                                           device="cpu") for tl in (3, 2)]
    return packs, np.asarray(space.heights)


def _hf_host(fn, pack, start, d, dist, active, t_min, skip_t0, init_desc,
             fetch):
    tiles, offsets, height = pack
    B = d.shape[0]
    out = dict(hit=torch.full((B,), True), t=torch.full((B,), 7.0),
               normal=torch.full((B, 3), 7.0),
               voxel=torch.full((B, 3), 7, dtype=torch.int32))
    counter = torch.zeros(1, dtype=torch.int32)
    rows = heightfield.row_starts(offsets, "cpu")
    hmax_w = heightfield.terrain_max(tiles, offsets)
    err = fn(tiles.data_ptr(), offsets[0], len(offsets) - 1,
             rows.data_ptr(), height, hmax_w.data_ptr(), start.data_ptr(),
             d.data_ptr(),
             dist.data_ptr(), None if active is None else active.data_ptr(),
             None if t_min is None else t_min.data_ptr(), int(skip_t0),
             init_desc, out["hit"].data_ptr(), out["t"].data_ptr(),
             out["normal"].data_ptr(), out["voxel"].data_ptr(), B,
             counter.data_ptr(), *fetch, None)
    assert err == 0
    return out


def _bits(got, want):
    for key in ("hit", "t", "normal", "voxel"):
        # bits, so that a -0.0 for a 0.0 would show
        assert np.array_equal(got[key].numpy().view(np.uint8),
                              want[key].numpy().view(np.uint8)), key


def _hf_rays(rng, B, heights):
    """The K2 sets' rays, a quarter of them started inside solid columns
    and some exactly on voxel boundaries."""
    n = heights.shape[0]
    start, d, dist = _svo_rays(rng, B, float(n))
    sx, sz = np.nonzero(heights >= 2)
    k = B // 4
    if k:
        pick = rng.integers(0, len(sx), k)
        x, z = sx[pick], sz[pick]
        y = heights[x, z] * rng.uniform(0.1, 0.9, k)
        start[B - k:] = torch.from_numpy(np.stack(
            [x + rng.uniform(0.2, 0.8, k), y, z + rng.uniform(0.2, 0.8, k)],
            axis=-1).astype(np.float32))
        start[B - k:B - k // 2] = torch.floor(start[B - k:B - k // 2])
    return start, d, dist


@pytest.mark.parametrize("fetch", FETCHES)
@pytest.mark.parametrize("B,frac,pack_i,skip_t0,init_desc", [
    (1, 1.0, 0, True, 0), (37, 0.5, 1, True, 0), (1000, None, 0, True, 0),
    (2500, 0.3, 1, False, 1), (4099, 0.02, 0, True, 2)])
def test_hf_cast_source_equals_plain(host_kernels, hf_world, B, frac, pack_i,
                                     skip_t0, init_desc, fetch):
    packs, heights = hf_world
    pack = packs[pack_i]
    rng = np.random.default_rng(B + 1)
    start, d, dist = _hf_rays(rng, B, heights)
    active = None if frac is None else torch.from_numpy(rng.random(B) < frac)
    got = _hf_host(host_kernels["hf_cast"], pack, start, d, dist, active,
                   None, skip_t0, init_desc, fetch)
    want = heightfield.hf_raycast_plain(*pack, start, d, dist, skip_t0,
                                        active, None, init_desc)
    _bits(got, want)
    if B > 100:
        assert want["hit"].any() and not want["hit"].all()


@pytest.fixture(scope="module")
def hf_heights():
    """Terrain heightmaps of 32 and 128 columns a side."""
    return {lg: worldgen.heightmap(lg, device="cpu") for lg in (5, 7)}


@pytest.mark.parametrize("log2", [5, 7])
@pytest.mark.parametrize("tile_log", heightfield.TILE_LOGS)
def test_hf_cast_source_every_tile_log(host_kernels, hf_heights, log2,
                                       tile_log):
    """Every tile_log instantiation, at two world heights (their top
    levels fill a tile or not), from every start level: bit for bit the
    plain version."""
    heights = hf_heights[log2]
    pack = heightfield.build_height_mips(heights, tile_log=tile_log,
                                         device="cpu")
    tiles, offsets, _ = pack
    rng = np.random.default_rng(log2 * 10 + tile_log)
    B = 700
    start, d, dist = _hf_rays(rng, B, heights)
    active = torch.from_numpy(rng.random(B) < 0.8)
    want = heightfield.hf_raycast_plain(*pack, start, d, dist, True, active)
    assert want["hit"].any() and not want["hit"].all()
    for init_desc in range(len(offsets) - 1):
        got = _hf_host(host_kernels["hf_cast"], pack, start, d, dist, active,
                       None, True, init_desc, FETCHES[0])
        _bits(got, want)


@pytest.mark.parametrize("log2", [5, 7])
def test_hf_cast_source_starts_on_the_low_face(host_kernels, hf_heights,
                                               log2):
    """Rays from integer points, half on the floor y = 0 and some on the
    world's faces, with zero direction components, t == 0 hits kept: a
    start on a (mirrored) low face enters at t = -0.0 and may hit at t0 =
    max(-0.0, 0.0), +0.0 on both sides, bit for bit."""
    heights = hf_heights[log2]
    n = heights.shape[0]
    pack = heightfield.build_height_mips(heights, device="cpu")
    rng = np.random.default_rng(log2)
    B = 1500
    start = rng.integers(0, n + 1, (B, 3)).astype(np.float32)
    start[:, 1] = np.where(rng.random(B) < 0.5, 0.0, rng.integers(0, 12, B))
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[rng.random((B, 3)) < 0.3] = 0.0
    d[np.abs(d).sum(1) == 0, 1] = 1.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start, d = torch.from_numpy(start), torch.from_numpy(d)
    dist = torch.full((B,), traverse.FAR)
    want = heightfield.hf_raycast_plain(*pack, start, d, dist, False)
    assert (want["hit"] & (want["t"] == 0.0)).sum() > 50
    for init_desc in (0, 1):
        got = _hf_host(host_kernels["hf_cast"], pack, start, d, dist, None,
                       None, False, init_desc, FETCHES[0])
        _bits(got, want)


def test_hf_cast_source_resumes_at_t_min(host_kernels, hf_world):
    """A walk resumed in certified air, from the kernel's source: equal to
    the plain version resumed alike and to the full walk."""
    packs, heights = hf_world
    rng = np.random.default_rng(5)
    B = 1500
    n = heights.shape[0]
    start = rng.uniform(-n, 2 * n, (B, 3)).astype(np.float32)
    start[:, 1] = rng.uniform(heights.max() + 1, 2 * n, B)
    target = rng.uniform(0, n, (B, 3)).astype(np.float32)
    d = target - start
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    start, d = torch.from_numpy(start), torch.from_numpy(d)
    dist = torch.full((B,), traverse.FAR)
    for pack in packs:
        full = heightfield.hf_raycast_plain(*pack, start, d, dist)
        t_min = torch.where(full["hit"], full["t"], float(n)) \
            * torch.from_numpy(rng.random(B, np.float32))
        want = heightfield.hf_raycast_plain(*pack, start, d, dist, True, None,
                                            t_min, 3)
        got = _hf_host(host_kernels["hf_cast"], pack, start, d, dist, None,
                       t_min, True, 3, FETCHES[0])
        for key in ("hit", "t", "normal", "voxel"):
            assert torch.equal(got[key], want[key]), key
            assert torch.equal(got[key], full[key]), key
        assert full["hit"].sum() > B // 4


@pytest.mark.parametrize("tier", [dict(), dict(bins=8192, K=256, ratio=32),
                                  dict(bins=8192, K=512, ratio=128)])
def test_sky_tmin_source_equals_plain(host_kernels, hf_world, tier):
    """K5 from its source against skyline_env_tmin_plain on the same
    table: camera rays from the envelope's origin and random directions,
    axis-parallel and vertical ones included (module doc's budget); the
    resumed walk equals the full walk either way."""
    from voxtracer_torch.kernels import skyline

    packs, heights = hf_world
    n = heights.shape[0]
    origin = (0.55 * n, float(heights.max()) + 4.0, 0.4 * n)
    env = skyline.build_skyline_env_device(
        skyline.sky_levels_from_hf(*packs[0]), origin, **tier)
    E = env["E"]
    cam = vcam.Camera(pos=origin, yaw=2.2, pitch=0.15)
    _, cd = vcam.generate_rays(cam, 64, 32, device="cpu")
    rng = np.random.default_rng(7)
    rd = rng.normal(size=(2048, 3)).astype(np.float32)
    rd[:6] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1], [-1, 0, 0],
              [0, 0, 0]]
    d = torch.cat([cd.reshape(-1, 3), torch.from_numpy(rd)]).contiguous()
    consts = skyline._consts(E.shape[0], env["d0"], env["g"])
    got = _sky_host(host_kernels["sky_tmin"], E, env["S"], d, consts)
    want = skyline.skyline_env_tmin_plain(E, d, *consts)
    rel = (got - want).abs() / want.abs().clamp_min(1e-30)
    off = rel > 1e-6
    assert int(off.sum()) <= max(2, 2 * d.shape[0] // 4096), int(off.sum())
    assert (want > 0).float().mean() > 0.3
    start = torch.tensor(origin, dtype=torch.float32).expand(d.shape) \
        .contiguous()
    dist = torch.full((d.shape[0],), traverse.FAR)
    full = heightfield.hf_raycast_plain(*packs[0], start, d, dist)
    resumed = heightfield.hf_raycast_plain(*packs[0], start, d, dist, True,
                                           None, got, 3)
    for key in ("hit", "t", "normal", "voxel"):
        assert torch.equal(full[key], resumed[key]), key


def _sky_host(fn, E, S, d, consts, image=(0, 0, 0)):
    """K5's C entry on (B, 3) directions ``d``, as lanes (s, y, x) of
    the image shape ``image`` (S, H, W), or in lane order for (0, 0, 0)."""
    from voxtracer_torch.kernels import skyline

    got = torch.full((d.shape[0],), 7.0)
    err = fn(E.data_ptr(), S.data_ptr(), E.shape[0], E.shape[1], S.shape[1],
             d.data_ptr(), d.shape[0], *image, *consts, skyline.FAR,
             got.data_ptr(), None)
    assert err == 0
    return got


def _sky_table(rng, bins, K):
    """A (bins, K) table shaped like a built envelope: rows nondecreasing
    over slopes that camera rays reach, a -3e38 floor over the first
    rungs of a third of the rows, +inf from some rung on in a fifth, and
    runs of equal rungs."""
    steps = rng.exponential(1.2 / K, (bins, K)).astype(np.float32)
    steps[rng.random((bins, K)) < 0.3] = 0.0
    E = np.cumsum(steps, axis=1) + rng.uniform(-1.2, -0.2, (bins, 1))
    E = E.astype(np.float32)
    floor = rng.random(bins) < 1 / 3
    E[floor, : max(K // 8, 1)] = -3e38
    inf_from = rng.integers(K // 2, K, bins)
    inf = rng.random(bins) < 1 / 5
    E[inf[:, None] & (np.arange(K)[None, :] >= inf_from[:, None])] = np.inf
    return torch.from_numpy(np.maximum.accumulate(E, axis=1))


def _sky_rays(shape, rng):
    """Directions of the image shape (S, H, W) (jittered samples of one
    frame; pixel centres at S = 1) from a camera whose view wraps azimuth
    0 / 2 pi, as (S * H * W, 3); or (B,) random directions, axis-parallel
    and vertical ones among them."""
    if len(shape) == 1:
        rd = rng.normal(size=(shape[0], 3)).astype(np.float32)
        rd[:6] = [[0, 1, 0], [0, -1, 0], [1, 0, 0], [0, 0, -1], [-1, 0, 0],
                  [0, 0, 0]]
        return torch.from_numpy(rd)
    S, H, W = shape
    cam = vcam.Camera(pos=(5.0, 30.0, 7.0), yaw=1.3, pitch=0.22)
    py, px = vcam.pixel_grid(W, H)
    ndc = vcam.pixel_ndc(px, py, W, H)
    if S == 1:
        d = vcam.ray_directions(cam.basis(), ndc)[None]
    else:
        jit = rng.uniform(0, 1, (S, H, W, 2)).astype(np.float32)
        d = vcam.ray_directions(cam.basis(), ndc[None].expand(S, H, W, 2),
                                jitter=torch.from_numpy(jit), height=H)
    return d.reshape(-1, 3).contiguous()


@pytest.mark.parametrize("K", [37, 64, 100, 256, 512])
@pytest.mark.parametrize("shape", [(1, 37, 29), (8, 13, 21), (3, 9, 10),
                                   (1000,)])
def test_sky_tmin_source_orders_and_searches(host_kernels, shape, K):
    """K5 from its source on image-shaped sets (S = 1 and 8, and S = 3,
    whose second sample group is half masked; W and H no multiples of the
    tile) in image and lane order, and on a set of random directions in
    lane order, against the plain version (module doc's budget) and
    against the binary search by bits in every lane: tables with K a
    multiple of 16 and not (100: a partial last block; 37: blocks read a
    float at a time), -3e38 floors and +inf blocks; the view wraps azimuth
    0 / 2 pi."""
    from voxtracer_torch.kernels import skyline

    rng = np.random.default_rng(K + len(shape))
    bins = 8192
    E = _sky_table(rng, bins, K)
    S = skyline.env_summary(E)
    d = _sky_rays(shape, rng)
    consts = skyline._consts(bins, 4.0, 1.01)
    cb = skyline.azimuth_bin(d, consts[0], bins)
    if len(shape) == 3:
        assert int(cb.min()) < 64 and int(cb.max()) > bins - 64  # wraps
    want = skyline.skyline_env_tmin_plain(E, d, *consts)
    ref = torch.full((d.shape[0],), 7.0)
    assert host_kernels["sky_bsearch"](
        E.data_ptr(), bins, K, d.data_ptr(), d.shape[0], *consts,
        skyline.FAR, ref.data_ptr(), None) == 0
    orders = [(0, 0, 0)] + ([shape] if len(shape) == 3 else [])
    for image in orders:
        got = _sky_host(host_kernels["sky_tmin"], E, S, d, consts, image)
        assert torch.equal(got.view(torch.int32), ref.view(torch.int32)), \
            image
        rel = (got - want).abs() / want.abs().clamp_min(1e-30)
        off = rel > 1e-6
        assert int(off.sum()) <= max(2, 2 * d.shape[0] // 4096), image
    # every kind of lane occurs: no certificate, a rung, all-miss
    assert (want == 0).any() and (want >= 1e37).any()
    assert ((want > 0) & (want < 1e37)).float().mean() > 0.2


# ---- K10 (csrc/sky_env.cu): the envelope build's stages in plain torch,
# held to the plain build (skyline._env_device) on the CPU, and the
# kernel's source held to them under the host's libm

SKY_ENV_INF = float("inf")


def _k10_enc(f):
    """sky_env.cu's ``enc``: float32 -> its order-preserving uint32 (held
    in int64), every float above 0, the empty entry."""
    u = f.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    return torch.where(u >= 1 << 31, ~u & 0xFFFFFFFF, u | 1 << 31)


def _k10_dec(e):
    """sky_env.cu's ``dec``: 0 -> -inf, else the float32 ``enc`` took
    there."""
    u = torch.where(e >= 1 << 31, e & 0x7FFFFFFF, ~e & 0xFFFFFFFF)
    f = torch.where(u >= 1 << 31, u - (1 << 32), u).to(torch.int32) \
        .view(torch.float32)
    return torch.where(e == 0, -SKY_ENV_INF, f)


def _k10_dilate(rows, w: int):
    """sky_dilate_kernel's doubling on the last axis: half-width h -> h +
    s, s = min(h + 1, w - h), the neighbours at (b -+ s) mod bins."""
    bins = rows.shape[-1]
    ar = torch.arange(bins)
    h = 0
    while h < w:
        s = min(h + 1, w - h)
        rows = torch.maximum(rows, torch.maximum(rows[..., (ar - s) % bins],
                                                 rows[..., (ar + s) % bins]))
        h += s
    return rows


def _libm(name, n_args):
    """The host libm's float function ``name`` over tensors (the one the
    kernel's source calls when built for the host)."""
    fn = getattr(ctypes.CDLL(ctypes.util.find_library("m")), name)
    fn.argtypes = [ctypes.c_float] * n_args
    fn.restype = ctypes.c_float
    vec = np.frompyfunc(fn, n_args, 1)

    def call(*xs):
        xs = np.broadcast_arrays(*(x.numpy() for x in xs))
        return torch.from_numpy(np.asarray(vec(*xs), np.float32))

    return call


TORCH_FNS = dict(atan2=torch.atan2, hypot=torch.hypot, log2=torch.log2)


def _k10_emulate(lv, origin, fns=TORCH_FNS, bins=4096, ratio=16, K=64,
                 d0=4.0, cls_step=1.0):
    """K10's four stages in plain torch on the CPU, from the level table
    its wrapper passes (skyline._env_plan): the fold of every level's
    window, a fine cell's height as the max of ceil over its voxels read
    from the pack's level-0 rows as the kernel indexes them, a coarse
    cell's from its pyramid level; the bounds max-reduced in the
    kernel's encoding into all_k, the used flags and the class plane;
    each rung's used class rows dilated by the kernel's doubling over
    all_k[k]; the cumulative max over rungs, -inf to -3e38, E transposed
    and S. ``fns``: atan2, hypot and log2, torch's (each called on the
    same tensors as in the plain build) or the host's libm. Returns E, S
    and the workspace (all_k, flags, plane; int64 encodings)."""
    from voxtracer_torch.kernels import skyline

    f32 = torch.float32
    offs, height, flat = lv["offsets"], lv["height"], lv["flat"]
    p = skyline._env_plan(offs, height, origin, bins, ratio, K, d0, cls_step)
    ox, oy, oz = p["ox"], p["oy"], p["oz"]
    cls_w = p["cls_w"]
    n_cls = len(cls_w)
    tl = offs[0]
    TS = 1 << tl
    dp = max((1 << height) >> tl, 1)
    bin_w = torch.tensor(p["bin_w"], dtype=f32)
    log2_g = torch.tensor(p["log2_g"], dtype=f32)
    wide_hw = float(np.float32(np.pi * (1.0 - 1e-6)))
    pi, two_pi = skyline._PI, skyline._TWO_PI
    all_k = torch.zeros(K, dtype=torch.int64)
    used = torch.zeros(n_cls * K, dtype=torch.int64)
    cls_b = torch.zeros(n_cls * K * bins, dtype=torch.int64)

    def box_d(x0, x1, z0, z1):
        dx = torch.clamp_min(torch.maximum(x0 - ox, ox - x1), 0.0)
        dz = torch.clamp_min(torch.maximum(z0 - oz, oz - z1), 0.0)
        fx = torch.maximum(torch.abs(x0 - ox), torch.abs(x1 - ox))
        fz = torch.maximum(torch.abs(z0 - oz), torch.abs(z1 - oz))
        return fns["hypot"](dx, dz), fns["hypot"](fx, fz)

    for lvl in p["levels"]:
        r = torch.arange(lvl.size * lvl.size)
        ii, jj = lvl.i0 + r // lvl.size, lvl.j0 + r % lvl.size
        if lvl.lf < 0:
            hm = lv["coarse"][lvl.src].reshape(-1)[ii * lvl.dim + jj]
        else:
            u = torch.arange(1 << lvl.lf)
            vx, vz = ii << lvl.lf, jj << lvl.lf
            row = offs[1] + (vx >> tl) * dp + (vz >> tl)
            slot = ((vx & TS - 1)[:, None, None] + u[None, :, None]) * TS \
                + (vz & TS - 1)[:, None, None] + u[None, None, :]
            hm = torch.ceil(flat[row[:, None, None], slot]).amax((1, 2))
        c = lvl.c
        x0, z0 = ii.to(f32) * c, jj.to(f32) * c
        x1, z1 = x0 + c, z0 + c
        d_min, d_max = box_d(x0, x1, z0, z1)
        sel = d_min >= lvl.a_lo
        if not lvl.is_top:
            pc = 2.0 * c
            px0, pz0 = torch.floor(x0 / pc) * pc, torch.floor(z0 / pc) * pc
            sel &= box_d(px0, px0 + pc, pz0, pz0 + pc)[0] < lvl.a_hi
        num = hm + skyline.NUM_MARGIN - oy
        bound = torch.where(num >= 0.0, num / d_min,
                            num / torch.clamp_min(d_max, 1e-12))
        bound = torch.where(torch.isnan(bound), SKY_ENV_INF, bound)
        ac = fns["atan2"](0.5 * (z0 + z1) - oz, 0.5 * (x0 + x1) - ox)
        hw = torch.zeros_like(ac)
        for gx, gz in ((x0, z0), (x0, z1), (x1, z0), (x1, z1)):
            dlt = fns["atan2"](gz - oz, gx - ox) - ac
            dlt = skyline._jmod(dlt + pi, two_pi) - pi
            hw = torch.maximum(hw, torch.abs(dlt))
        inside = (x0 <= ox) & (ox <= x1) & (z0 <= oz) & (oz <= z1)
        hw = torch.where(inside, pi, hw)
        rk = torch.ceil((fns["log2"](torch.clamp_min(d_min, 1e-6))
                         - p["log2_d0"]) / log2_g - 1e-3)
        rung = torch.clamp(rk, 0, K - 1).to(torch.int64)
        wb = torch.ceil(hw / bin_w) + 1.0
        cls = torch.ceil(fns["log2"](torch.clamp_min(wb, 1.0)) * p["inv_step"]
                         + 1e-4).to(torch.int64).clamp(0, n_cls - 1)
        cb = torch.floor(skyline._jmod(ac, two_pi) / bin_w).to(torch.int64) \
            .clamp(0, bins - 1)
        v = _k10_enc(bound)
        wide = sel & (hw >= wide_hw)
        narrow = sel & (hw < wide_hw)
        all_k.scatter_reduce_(0, rung[wide], v[wide], "amax")
        rowi = (cls * K + rung)[narrow]
        used[rowi] = 1
        cls_b.scatter_reduce_(0, rowi * bins + cb[narrow], v[narrow], "amax")

    ed = all_k[:, None].expand(K, bins).clone()
    plane = cls_b.reshape(n_cls, K, bins)
    for c in range(n_cls):
        on = used[c * K:(c + 1) * K] == 1
        ed[on] = torch.maximum(ed[on], _k10_dilate(plane[c][on], cls_w[c]))
    E = _k10_dec(torch.cummax(ed, dim=0).values)
    E = torch.where(torch.isneginf(E), float(np.float32(-3e38)), E)
    E = E.t().contiguous()
    return E, skyline.env_summary(E), torch.cat([all_k, used, cls_b])


@pytest.fixture(scope="module")
def sky_worlds():
    """Terrain packs of 64 columns (tile logs 3 and 2) and of 256."""
    h6, h8 = (worldgen.heightmap(lg, device="cpu") for lg in (6, 8))
    from voxtracer_torch.kernels import skyline

    return {name: (skyline.sky_levels_from_hf(*heightfield.build_height_mips(
        h, tile_log=tl, device="cpu")), float(h.max()))
        for name, h, tl in (("64", h6, 3), ("64/tl2", h6, 2),
                            ("256", h8, 3))}


def _sky_env_origins(n, top):
    """An origin on the world's edge (x = 0), one inside a cell (off every
    cell boundary, under the peaks), one above all terrain, and one
    outside the grid."""
    return {"edge": (0.0, top * 0.6, n * 0.45),
            "inside": (n * 0.37 + 0.3, top * 0.7, n * 0.61 + 0.45),
            "above": (n * 0.52, top + 9.5, n * 0.3),
            "outside": (-0.4 * n, top + 30.0, n * 1.2)}


def test_sky_env_encoding_round_trips_and_orders():
    """The kernel's encoding: decodes back to the same bits (0 to -inf),
    every float encodes above 0, and the order of the encodings is the
    order of the floats, -0 just below +0; so a max over encodings is the
    float max."""
    special = [0.0, -0.0, SKY_ENV_INF, -SKY_ENV_INF, 1.4e-45, -1.4e-45,
               1.1754942e-38, -1.1754942e-38, 1.17549435e-38, 3.4028235e38,
               -3.4028235e38, 1.0, -1.0, 3e38, -3e38]
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 1 << 32, 20000, dtype=np.uint64).astype(np.uint32)
    rand = bits.view(np.float32)
    rand = rand[~np.isnan(rand)]
    f = torch.from_numpy(np.concatenate([np.float32(special), rand]))
    e = _k10_enc(f)
    assert (e > 0).all() and (e < 1 << 32).all()
    back = _k10_dec(e)
    assert torch.equal(back.view(torch.int32), f.view(torch.int32))
    assert _k10_dec(torch.zeros(1, dtype=torch.int64)).item() == -SKY_ENV_INF
    order = torch.argsort(e)
    fs = f[order]
    assert (fs[1:] >= fs[:-1]).all()
    zero = _k10_enc(torch.tensor([-0.0, 0.0]))
    assert zero[0] + 1 == zero[1]
    assert _k10_enc(torch.tensor([-SKY_ENV_INF])).item() > 0


@pytest.mark.parametrize("bins", [2, 37, 64, 100])
def test_sky_env_dilate_equals_dilate_max(bins):
    """The kernel's doubling (modular neighbours) equals _dilate_max's
    rolls for every half-width from 1 to bins / 2, on rows with ties,
    empty (-inf) runs and an inf."""
    from voxtracer_torch.kernels import skyline

    rng = np.random.default_rng(bins)
    rows = rng.normal(size=(6, bins)).astype(np.float32)
    rows[rng.random((6, bins)) < 0.6] = -np.inf
    rows[1] = np.round(rows[1])
    rows[2, bins // 3] = np.inf
    rows[3] = -np.inf
    t = torch.from_numpy(rows)
    for w in range(1, bins // 2 + 1):
        assert torch.equal(_k10_dilate(t, w), skyline._dilate_max(t, w)), w


def test_sky_env_dilate_equals_dilate_max_at_the_tiers_widths():
    """At 8192 bins, the width classes' half-widths (2^c up to 4096) and
    odd ones between."""
    from voxtracer_torch.kernels import skyline

    rng = np.random.default_rng(8192)
    rows = rng.normal(size=(2, 8192)).astype(np.float32)
    rows[rng.random((2, 8192)) < 0.99] = -np.inf
    t = torch.from_numpy(rows)
    for w in [1 << c for c in range(13)] + [3, 1000, 4095]:
        assert torch.equal(_k10_dilate(t, w), skyline._dilate_max(t, w)), w


def _renderer_tiers():
    from voxtracer_torch.render.driver import Renderer

    return [kw for kw, _ in Renderer.SKY_TIERS]


@pytest.mark.parametrize("where", ["edge", "inside", "above"])
@pytest.mark.parametrize("tier", [0, 1, 2])
def test_sky_env_stages_equal_plain_at_the_tiers(sky_worlds, tier, where):
    """K10's stages (level table, encoded accumulators, the kernel's
    dilation, the scan) equal the plain build bit for bit at each of the
    Renderer's envelope tiers (8192 bins, K 256 and 512, ratio 32, 128,
    256) on a 256^3 world."""
    from voxtracer_torch.kernels import skyline

    lv, top = sky_worlds["256"]
    kw = _renderer_tiers()[tier]
    o = np.asarray(_sky_env_origins(256, top)[where])
    E, S, _ = _k10_emulate(lv, o, **kw)
    want = skyline.build_skyline_env_device(lv, o, **kw)
    assert torch.equal(E, want["E"]) and torch.equal(S, want["S"])
    assert (E > -1e38).any() and (E < E.max()).any()


@pytest.mark.parametrize("where", ["edge", "inside", "above", "outside"])
@pytest.mark.parametrize("world,kw", [
    ("256", dict(bins=1024, K=64, ratio=4)),
    ("256", dict(bins=512, K=37, ratio=2, cls_step=0.7)),
    ("64/tl2", dict(bins=256, K=40, ratio=3))])
def test_sky_env_stages_equal_plain_windowed(sky_worlds, world, kw, where):
    """The same where the windows clip: the fine window and the first
    coarse levels smaller than the grid (a small ratio), shifted inward
    at the world's edge; a cls_step of 0.7 and K off the scan's tiles;
    the pack at tile log 2."""
    from voxtracer_torch.kernels import skyline

    lv, top = sky_worlds[world]
    n = 1 << lv["height"]
    o = np.asarray(_sky_env_origins(n, top)[where])
    plan = skyline._env_plan(lv["offsets"], lv["height"], o, kw["bins"],
                             kw["ratio"], kw["K"], 4.0,
                             kw.get("cls_step", 1.0))
    assert plan["WG"] < n >> lv["offsets"][0]
    E, S, _ = _k10_emulate(lv, o, **kw)
    want = skyline.build_skyline_env_device(lv, o, **kw)
    assert torch.equal(E, want["E"]) and torch.equal(S, want["S"])


@pytest.mark.parametrize("where", ["edge", "inside", "above", "outside"])
@pytest.mark.parametrize("world,kw", [
    ("64", dict(bins=256, K=16, ratio=4)),
    ("64", dict(bins=128, K=37, ratio=2, cls_step=0.7)),
    ("64/tl2", dict(bins=200, K=33, ratio=3))])
def test_sky_env_source_equals_emulation(host_kernels, sky_worlds, world, kw,
                                         where):
    """K10 from its source, run through skyline._env_launch as the
    wrapper runs it: its workspace (all_k, the used flags, the class
    plane), E and S equal the stages' emulation under the host's libm
    (the one the host build calls) by bits; against the plain build
    (torch's atan2, hypot and log2) a cell on a bin, class or rung
    boundary may land one over, so E may differ in a few entries."""
    from voxtracer_torch.kernels import skyline

    lv, top = sky_worlds[world]
    n = 1 << lv["height"]
    o = np.asarray(_sky_env_origins(n, top)[where])
    full = dict(dict(d0=4.0, cls_step=1.0), **kw)
    plan = skyline._env_plan(lv["offsets"], lv["height"], o, full["bins"],
                             full["ratio"], full["K"], full["d0"],
                             full["cls_step"])
    err, E, S, ws = skyline._env_launch(
        host_kernels["sky_env"], lv["flat"], lv["coarse"], plan,
        lv["offsets"], lv["height"], full["bins"], full["K"])
    assert err == 0
    libm = dict(atan2=_libm("atan2f", 2), hypot=_libm("hypotf", 2),
                log2=_libm("log2f", 1))
    Ee, Se, wse = _k10_emulate(lv, o, fns=libm, **kw)
    assert torch.equal(ws.to(torch.int64) & 0xFFFFFFFF, wse)
    assert torch.equal(E, Ee) and torch.equal(S, Se)
    assert torch.equal(S, skyline.env_summary(E))
    want = skyline.build_skyline_env_device(lv, o, **kw)["E"]
    assert int((E != want).sum()) <= E.numel() // 100


def _fog_host(fn, args, active, n_steps, fetch, work=None):
    B = args[0].shape[0]
    code = torch.full((B,), 7, dtype=torch.int32)
    t = torch.full((B,), 7.0)
    counter = torch.zeros(1, dtype=torch.int32)
    err = fn(*(a.data_ptr() for a in args),
             None if active is None else active.data_ptr(), code.data_ptr(),
             t.data_ptr(), B, n_steps, fog.PLANET_R_F, fog.PLANET_R2_F,
             fog.FOG_R2_F, fog.FOG_FACTOR_F, counter.data_ptr(), *fetch,
             None if work is None else work.data_ptr(), None)
    assert err == 0
    return code, t


@pytest.mark.parametrize("B,n_steps", [(1, 64), (100, 16), (3001, 64),
                                       (2048, 0)])
def test_fog_march_source_masks_and_schedules_exactly(host_kernels, B,
                                                      n_steps):
    rng = np.random.default_rng(B + n_steps)
    start = rng.random((B, 3), np.float32) * np.float32(1024)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dens = fog_density(torch.from_numpy(rng.random(B, np.float32)))
    y0 = -np.log(np.float32(1) - rng.random(B, np.float32))
    args = (torch.from_numpy(start), torch.from_numpy(d), dens.contiguous(),
            torch.from_numpy(y0.astype(np.float32)))
    fn = host_kernels["fog_march"]
    code, t = _fog_host(fn, args, None, n_steps, FETCHES[0])
    active = torch.from_numpy(rng.random(B) < 0.3)
    # the work counts: the lane-by-lane model's settled marches and
    # segments, over the lanes each launch marches
    model = _certify_host(host_kernels["fog_certify"],
                          *(a.numpy() for a in args), n_steps)
    settled, segs = model[4] == 1, model[7].astype(np.int64)
    assert np.array_equal(model[2], code.numpy())
    if B > 100 and n_steps:
        assert settled.any() and segs.any()
    for fetch in FETCHES:
        work = torch.zeros(2, dtype=torch.int64)
        c_all, t_all = _fog_host(fn, args, None, n_steps, fetch, work)
        assert torch.equal(c_all, code) and torch.equal(t_all, t)
        assert work.tolist() == [int(settled.sum()), int(segs.sum())]
        work.zero_()
        c_m, t_m = _fog_host(fn, args, active, n_steps, fetch, work)
        on = active.numpy()
        assert work.tolist() == [int(settled[on].sum()), int(segs[on].sum())]
        assert torch.equal(c_m, torch.where(active, code, 0))
        assert np.array_equal(t_m.numpy().view(np.int32),
                              torch.where(active, t, 0.0).numpy()
                              .view(np.int32))
    code_p, t_p = fog.fog_march_plain(*args, n_steps=n_steps)
    same = code == code_p
    assert int((~same).sum()) <= max(1, B // 200)
    miss = same & (code_p == 0)
    assert (t[miss] == 0).all() and (t_p[miss] == 0).all()
    # planet hits: t = (-b - sqrt(det)) / 2 cancels terms of ~1.3e7,
    # whose float32 spacing is 1.0, and PyTorch's CPU kernels and the host
    # build round them apart by an ulp (on the card the two agree bit for
    # bit, chip_smoke.py)
    planet = same & (code_p == 1)
    assert float((t[planet] - t_p[planet]).abs().max()) <= 2.0
    # a scatter point may move by about one segment (the shell is ~1.35e6
    # long; tests/test_torch_atmosphere.py's bound)
    fogged = same & (code_p == 2)
    if fogged.any():
        assert float((t[fogged] - t_p[fogged]).abs().max()) \
            < 1.5 * 1.35e6 / n_steps
    if B > 100 and n_steps:
        assert set(code.tolist()) == {0, 1, 2}


def _certify_rays(rng, B):
    """Fog-march rays of four kinds, a quarter each: starts 0-3000 m up
    and any direction; near the horizon (vertical component within 1e-2,
    down to 1e-6); downward; and starts at the fog shell's edge (within
    1 km inside and out, and on it). Returns (start, dir) float32."""
    q = B // 4
    start = np.zeros((B, 3), np.float32)
    start[:, [0, 2]] = rng.uniform(-5000, 5000, (B, 2))
    start[:, 1] = rng.uniform(0, 3000, B)
    d = rng.normal(size=(B, 3))
    elev = rng.choice([-1, 1], q) * 10.0 ** rng.uniform(-6, -2, q)
    d[q:2 * q, 1] = elev * np.hypot(d[q:2 * q, 0], d[q:2 * q, 2])
    d[2 * q:3 * q, 1] = -np.abs(d[2 * q:3 * q, 1]) - 0.01
    edge = fog.FOG_RADIUS - fog.PLANET_RADIUS
    start[3 * q:, 1] = edge + rng.choice([-1000.0, -50.0, -1.0, 0.0, 1.0,
                                          50.0, 1000.0], B - 3 * q)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    return start, d.astype(np.float32)


def _certify_host(fn, start, d, density, y0, n_steps):
    B = start.shape[0]
    outs = [np.zeros(B, np.int32), np.zeros(B, np.float32),
            np.zeros(B, np.int32), np.zeros(B, np.float32),
            np.zeros(B, np.int32), np.zeros(B, np.float64),
            np.zeros(B, np.float64), np.zeros(B, np.int32)]
    ins = [np.ascontiguousarray(x) for x in (start, d, density, y0)]
    err = fn(*(x.ctypes.data for x in ins), B, n_steps, fog.PLANET_R_F,
             fog.PLANET_R2_F, fog.FOG_R2_F, fog.FOG_FACTOR_F,
             *(x.ctypes.data for x in outs))
    assert err == 0
    return outs


@pytest.mark.parametrize("n_steps", [1, 64, 256])
def test_fog_scatter_free_test_matches_the_full_march(host_kernels, n_steps):
    """The scatter-free test of fog_walk.cuh (K1's begin() and K9's
    stages) against the full march of the same source: every lane's
    (code, t) by bits, a settled march never scatters, and the bound D
    covers the sum of the segment densities wherever it is finite. Rays
    from the ground, near the horizon, downward and at the shell's edge;
    400 nm, 800 nm and density 0; free paths drawn as the integrator
    draws them, a quarter just above D and a few far above."""
    fn = host_kernels["fog_certify"]
    rng = np.random.default_rng(11 + n_steps)
    B = 4096
    start, d = _certify_rays(rng, B)
    wl = rng.choice(np.float32([0.0, 1.0]), B)
    density = fog_density(torch.from_numpy(wl)).numpy()
    density[rng.random(B) < 0.1] = 0.0
    y0 = (-np.log(np.float32(1) - rng.random(B, np.float32))).astype(
        np.float32)
    y0[rng.random(B) < 0.02] = np.float32(1e3)
    # a quarter of the lanes just above the bound: the least float y0
    # with y0 (1 - 2^-15) > D
    bound = _certify_host(fn, start, d, density, y0, n_steps)[5]
    edge = (rng.random(B) < 0.25) & (bound < 1e38)
    y_edge = (bound / (1.0 - 2.0 ** -15)).astype(np.float32)
    low = y_edge.astype(np.float64) * (1.0 - 2.0 ** -15) <= bound
    y_edge[low] = np.nextafter(y_edge[low], np.float32(np.inf))
    y0 = np.where(edge, y_edge, y0).astype(np.float32)
    code_f, t_f, code_k, t_k, settled, bound, total, _ = _certify_host(
        fn, start, d, density, y0, n_steps)
    assert np.array_equal(code_k, code_f)
    assert np.array_equal(t_k.view(np.int32), t_f.view(np.int32))
    ok = settled == 1
    assert (code_f[ok] != 2).all()
    finite = np.isfinite(bound)
    assert (total[finite] <= bound[finite]).all()
    # the march's every kind: settled, marched to a scatter, marched
    # through (with one segment the bound is all but exact, so a march
    # that does not scatter is settled); settled at both wavelengths, at
    # density 0 and at the edge
    assert (code_f == 2).any()
    if n_steps > 1:
        assert ((settled == 0) & (code_f != 2)).any()
    for lanes in (wl == 0, wl == 1, density == 0, edge):
        assert ok[lanes & (settled >= 0)].any()
    assert ok[edge].all()


def _records(rng, shape, span=56, big=8):
    """Random pair records (..., 8) of boxes in a 64^3 world."""
    lo = rng.integers(0, span, shape + (3,))
    size = rng.integers(1, big + 1, shape + (3,))
    rows = np.zeros(shape + (8,), np.int32)
    rows[..., 1] = rng.integers(0, 1 << 20, shape)
    rows[..., 2] = lo[..., 0] | (lo[..., 1] << 16)
    rows[..., 3] = lo[..., 2] | (size[..., 0] << 16)
    rows[..., 4] = size[..., 1] | (size[..., 2] << 16)
    rows[..., 5:8] = rng.random(shape + (3,), np.float32).view(np.int32)
    return rows


def _rays_and_carry(rng, N, R, coherent):
    """Unit directions (random octants, or one octant per tile with a few
    axis-aligned rays) and a carry that holds some hits."""
    d = rng.normal(size=(N, R, 3)).astype(np.float32)
    if coherent:
        d = np.abs(d) * np.sign(rng.normal(size=(N, 1, 3))).astype(np.float32)
        d[:, :3, 1:] = 0.0  # the EPS clamp
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t0 = np.where(rng.random((N, R)) < 0.3,
                  rng.random((N, R), np.float32) * 80, np.inf)
    t0 = t0.astype(np.float32)
    pl0 = np.where(np.isfinite(t0), rng.integers(0, 4000, (N, R)) * 4, -1)
    rgb0 = np.where(np.isfinite(t0)[..., None], rng.random((N, R, 3)), 0)
    f = lambda a, dt: torch.from_numpy(np.ascontiguousarray(a.astype(dt)))  # noqa: E731,E501
    return f(d, np.float32), (f(t0, np.float32), f(pl0, np.int32),
                              f(rgb0, np.float32))


CAM_OUT = np.float32([31.3, 70.2, -9.6])
CAM_IN = np.float32([23.5, 24.25, 22.75])  # inside a box: t_enter == 0


def _fold_host(fn, carry, rows, valid, d, cam, distance, ray_tile, spans):
    t, pl, rgb = carry
    N, R = t.shape
    K = rows.shape[-2]
    out = (torch.full_like(t, 7.0), torch.full_like(pl, 7),
           torch.full_like(rgb, 7.0))
    err = fn(t.data_ptr(), pl.data_ptr(), rgb.data_ptr(), rows.data_ptr(),
             valid.data_ptr(), 0 if rows.dim() == 2 else K, d.data_ptr(),
             float(cam[0]), float(cam[1]), float(cam[2]), 64.0,
             float(np.float32(distance)), out[0].data_ptr(),
             out[1].data_ptr(), out[2].data_ptr(), N, R, K, ray_tile, spans,
             None)
    assert err == 0
    return out


def _bits_equal(got, want):
    for name, a, b in zip(("t", "pl", "rgb"), got, want):
        assert a.dtype == b.dtype and np.array_equal(
            a.numpy().view(np.uint8), b.numpy().view(np.uint8)), name


@pytest.mark.parametrize("N,R,K,shared,coherent,ray_tile,spans", [
    (5, 64, 16, False, True, 0, 0),      # the main fold's shape, one octant
    (3, 128, 16, False, False, 0, 0),    # ray tile 4, every octant in a warp
    (3, 70, 37, False, False, 2, 1),     # ragged R and K
    (2, 200, 150, False, True, 4, 2),    # three stages, ragged chunk
    (2, 64, 150, False, False, 2, 4),    # spans end inside stages
    (1, 64, 530, False, False, 2, 16),   # a 16-warp block
    (1, 33, 40, False, False, 0, 8),     # spans longer than the list needs
    (4, 64, 24, True, False, 0, 0),      # one list for every tile
    (3, 128, 100, True, True, 4, 2),
    (9, 64, 5, False, True, 2, 0),       # more units than one block holds
])
def test_resolve_fold_source_equals_plain(host_kernels, N, R, K, shared,
                                          coherent, ray_tile, spans):
    rng = np.random.default_rng(N * R + K)
    rows = _records(rng, (N, K))
    valid = rng.random((N, K)) >= 0.2
    if shared:
        rows, valid = rows[0], valid[0]
    rows[..., 0, 2:5] = [20 | (20 << 16), 20 | (8 << 16), 8 | (8 << 16)]
    rows, valid = torch.from_numpy(rows), torch.from_numpy(valid)
    d, carry = _rays_and_carry(rng, N, R, coherent)
    fn = host_kernels["resolve_fold"][0]
    improved = False
    for cam, distance in ((CAM_OUT, 1.0e12), (CAM_IN, 1.0e12),
                          (CAM_OUT, 85.0)):
        got = _fold_host(fn, carry, rows, valid, d, cam, distance, ray_tile,
                         spans)
        want = resolve.resolve_fold_plain(*carry, rows, valid, d, cam, 6,
                                          distance)
        _bits_equal(got, want)
        improved |= bool((want[0] < carry[0]).any())
    assert improved


def _tie_case():
    """Every ray's nearest candidate stands twice in the list, with two
    owners and colours, once in each half: the first must win."""
    rng = np.random.default_rng(3)
    N, R, K = 2, 64, 96
    rows = _records(rng, (N, K), span=30, big=4)
    rows[..., 2] += 30  # boxes at x >= 30: behind the wall below
    wall = [2 | (0 << 16), 0 | (2 << 16), 62 | (62 << 16)]  # x in [2, 4)
    for j in (30, 80):  # with 4 spans: in the second and the fourth
        rows[:, j, 2:5] = wall
    valid = torch.ones((N, K), dtype=torch.bool)
    d = rng.normal(size=(N, R, 3)).astype(np.float32)
    d[..., 0] = np.abs(d[..., 0]) + 2.0  # toward +x, through the wall
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    carry = (torch.full((N, R), torch.inf),
             torch.full((N, R), -1, dtype=torch.int32), torch.zeros((N, R, 3)))
    return carry, torch.from_numpy(rows), valid, torch.from_numpy(d), \
        np.float32([-5.0, 30.5, 31.25])


@pytest.mark.parametrize("spans", [1, 2, 4, 8])
def test_resolve_fold_spans_merge_in_list_order(host_kernels, spans):
    carry, rows, valid, d, cam = _tie_case()
    want = resolve.resolve_fold_plain(*carry, rows, valid, d, cam, 6, 1.0e12)
    assert (want[1] >> 2 == rows[:, 30, 1][:, None]).all()  # the first wall
    got = _fold_host(host_kernels["resolve_fold"][0], carry, rows, valid, d,
                     cam, 1.0e12, 2, spans)
    _bits_equal(got, want)


@pytest.mark.parametrize("mutant", sorted(FOLD_MUTANTS))
def test_resolve_fold_wrong_span_merges_are_caught(host_kernels, mutant):
    carry, rows, valid, d, cam = _tie_case()
    want = resolve.resolve_fold_plain(*carry, rows, valid, d, cam, 6, 1.0e12)
    fn = host_kernels[mutant][0]
    _bits_equal(_fold_host(fn, carry, rows, valid, d, cam, 1.0e12, 2, 1),
                want)  # one span: nothing to merge, still right
    got = _fold_host(fn, carry, rows, valid, d, cam, 1.0e12, 2, 4)
    assert torch.equal(got[0], want[0])  # the same t ...
    assert not torch.equal(got[1], want[1])  # ... from the wrong candidate


def _segments(rng, NT, db=20, most=150):
    """A sorted pair array: each tile a segment of 0..most records with
    rising keys, then the sentinel; and every tile's segment start."""
    counts = rng.integers(0, most, NT)
    counts[rng.integers(0, NT - 1)] = 0
    counts[-1] = most - 1
    tile = np.repeat(np.arange(NT), counts)
    rows = _records(rng, (tile.size + 1,))
    rows[:-1, 0] = (tile << db) | np.arange(tile.size)
    rows[-1] = 0
    rows[-1, 0] = NT << db
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return torch.from_numpy(rows), torch.from_numpy(start), counts


@pytest.mark.parametrize("NT,R,k,consumed,listed,ray_tile,spans", [
    (12, 64, 16, 0, None, 0, 0),     # the main fold: every tile, in place
    (12, 128, 16, 0, None, 4, 1),
    (12, 64, 104, 16, 7, 2, 2),      # a widen round over 7 listed tiles
    (12, 70, 130, 40, 5, 2, 4),      # segments end inside the span
    (6, 64, 256, 10, 1, 0, 0),       # one tile; reads clamp at the end
    (6, 128, 40, 0, 0, 0, 0),        # an empty list
])
def test_resolve_fold_seg_source_equals_plain(host_kernels, NT, R, k,
                                              consumed, listed, ray_tile,
                                              spans):
    rng = np.random.default_rng(NT + R + k)
    db = 20
    spairs, seg_start, _ = _segments(rng, NT, db)
    d, carry = _rays_and_carry(rng, NT, R, coherent=False)
    ok = rng.random((NT, R)) < 0.8
    ok[0] = False  # a tile of padding only
    ok = torch.from_numpy(ok)
    if listed is None:
        tiles, start = None, seg_start
    else:
        tiles = torch.from_numpy(np.sort(rng.choice(NT, listed, replace=False))
                                 .astype(np.int32))
        if listed == 1:
            tiles[0] = NT - 1
        start = (seg_start[tiles.long()] + consumed).to(torch.int32)
    S = NT if tiles is None else listed
    got = tuple(c.clone() for c in carry)
    got_max = torch.full((S,), -torch.inf)
    got_next = torch.full((S,), 7.0)
    if S:
        err = host_kernels["resolve_fold"][1](
            got[0].data_ptr(), got[1].data_ptr(), got[2].data_ptr(),
            spairs.data_ptr(), spairs.shape[0],
            None if tiles is None else tiles.data_ptr(), start.data_ptr(), S,
            k, db, 0.375, d.data_ptr(), ok.data_ptr(), got_max.data_ptr(),
            got_next.data_ptr(), float(CAM_OUT[0]), float(CAM_OUT[1]),
            float(CAM_OUT[2]), 64.0, 1.0e12, R, ray_tile, spans, None)
        assert err == 0
    want = tuple(c.clone() for c in carry)
    want_max, want_next = resolve.resolve_fold_seg_plain(
        *want, spairs, tiles, start, k, db, 0.375, d, ok, CAM_OUT, 6, 1.0e12)
    _bits_equal(got, want)
    assert np.array_equal(got_max.numpy().view(np.int32),
                          want_max.numpy().view(np.int32))
    assert np.array_equal(got_next.numpy().view(np.int32),
                          want_next.numpy().view(np.int32))
    if listed:
        rest = np.setdiff1d(np.arange(NT), tiles.numpy())
        _bits_equal([g[rest] for g in got], [c[rest] for c in carry])
        assert (want[0] < carry[0]).any()


@pytest.fixture(scope="module")
def clutter():
    """tests/test_beam.py's 32^3 random fill and its augmented rows."""
    rng = np.random.default_rng(5)
    solid = rng.random((32, 32, 32)) < 0.2
    rgb = rng.random((32, 32, 32, 3)).astype(np.float32)
    rgb[~solid] = 0
    dev = svo.from_dense(solid, rgb).serialize()
    w = svo.upload(dev.table, dev.root, dev.height, "cpu")
    return w, torch.from_numpy(beam.build_aug_table(dev.table,
                                                    dev.solid_leaf))


def _beam_tiles(pos, yaw, pitch, W=64, H=40):
    cam = vcam.Camera(pos=pos, yaw=yaw, pitch=pitch)
    _, d = vcam.generate_rays(cam, W, H)
    return torch.tensor(pos, dtype=torch.float32), beam._group(d, 8) \
        .contiguous()


@pytest.fixture(scope="module")
def terrain7():
    """A 128^3 terrain (height 7) and its augmented rows."""
    dev = worldgen.generate(log2_size=7, verbose=False,
                            device="cpu").serialize()
    w = svo.upload(dev.table, dev.root, dev.height, "cpu")
    return w, torch.from_numpy(beam.build_aug_table(dev.table,
                                                    dev.solid_leaf))


def _walk_host(fn, aug, height, pre, state, K, max_steps):
    Bb = pre["ilo"].shape[0]
    out = dict(lvl=torch.full((Bb, K), 7, dtype=torch.int32),
               off=torch.full((Bb, K, 3), 7, dtype=torch.int32),
               rgb=torch.full((Bb, K, 3), 7.0),
               ok=torch.full((Bb,), True), t_safe=torch.full((Bb,), 7.0))
    err = fn(aug.data_ptr(), height, pre["olo"].data_ptr(),
             pre["ohi"].data_ptr(), pre["ilo"].data_ptr(),
             pre["ihi"].data_ptr(), pre["mirror"].data_ptr(),
             pre["incoherent"].data_ptr(), K, max_steps, 1,
             state["h"].data_ptr(), state["ids_stk"].data_ptr(),
             state["mask_stk"].data_ptr(), state["entry_stk"].data_ptr(),
             state["words"].data_ptr(), state["cap"].data_ptr(),
             state["alive"].data_ptr(), out["lvl"].data_ptr(),
             out["off"].data_ptr(), out["rgb"].data_ptr(),
             out["ok"].data_ptr(), out["t_safe"].data_ptr(), Bb, None)
    assert err == 0
    return out


def _resolve_host(fn, c, origin, d, height, best=None):
    """K7 under the emulation; with ``best``, into that running best."""
    Bb, P, _ = d.shape
    out = best if best is not None else dict(
        hit=torch.full((Bb, P), True), t=torch.full((Bb, P), 7.0),
        normal=torch.full((Bb, P, 3), 7.0), rgb=torch.full((Bb, P, 3), 7.0),
        voxel=torch.full((Bb, P, 3), 7, dtype=torch.int32))
    err = fn(c["lvl"].data_ptr(), c["off"].data_ptr(), c["rgb"].data_ptr(),
             origin.data_ptr(), int(origin.dim() != 1), d.data_ptr(), height,
             1, int(best is not None), out["hit"].data_ptr(),
             out["t"].data_ptr(), out["normal"].data_ptr(),
             out["rgb"].data_ptr(), out["voxel"].data_ptr(), Bb, P,
             c["lvl"].shape[1], None)
    assert err == 0
    return out


def _same_bits(got, want):
    """Every key of ``want`` equal by bits (a -0.0 for a 0.0 would show)."""
    for key in want:
        a, b = got[key].contiguous(), want[key].contiguous()
        assert a.dtype == b.dtype and np.array_equal(
            a.numpy().view(np.uint8), b.numpy().view(np.uint8)), key


def _no_negative_zero(*xs):
    """The walk's entries, caps and t_safe are never -0.0, so K6's shuffle
    trees of fminf give the plain walk's sequential mins by bits."""
    for x in xs:
        assert not (x.contiguous().view(torch.int32) == -2**31).any()


def _truncated(c, rng):
    """The candidates with each beam's used slots cut at a random count
    (0 for a third of the beams): unused slots as the walk leaves them."""
    Bb, K = c["lvl"].shape
    used = (c["lvl"] >= 0).sum(1)
    keep = torch.from_numpy((rng.random(Bb) * (used.numpy() + 1))
                            .astype(np.int64))
    keep[::3] = 0
    gone = torch.arange(K)[None] >= keep[:, None]
    out = dict(lvl=torch.where(gone, -1, c["lvl"]),
               off=torch.where(gone[..., None], 0, c["off"]),
               rgb=torch.where(gone[..., None], 0.0, c["rgb"]))
    assert (keep == 0).any() and ((keep > 0) & (keep < used)).any()
    return out


POS0 = (16.1234567, 16.0721311, -10.0412399)
POS1 = (5.3, 30.1, 4.2)
# (sides of each round on the state the kernel resumes)
BEAM_SIDES = dict(plain_then_kernel=("plain", "kernel", "kernel"),
                  kernel_then_plain=("kernel", "plain", "plain"))


@pytest.mark.parametrize("pos,yaw,pitch,K,steps,case", [
    pytest.param(POS0, 0.0137, 0.0213, 64, 2048, "rounds",
                 id="pos0-0.0137-0.0213-64-2048"),
    pytest.param(POS1, 0.8, -0.7, 8, 2048, "rounds",  # pauses on most tiles
                 id="pos1-0.8--0.7-8-2048"),
    pytest.param((16.5, 16.5, 16.5), 0.3, -0.2, 16, 40, "rounds",
                 id="pos2-0.3--0.2-16-40"),  # inside; the step budget
    # 21 beams: a warp's and a block's groups past the last beam
    pytest.param(POS0, 0.0137, 0.0213, 64, 2048, "ragged", id="ragged"),
    # K 8: a beam pauses after every expansion
    pytest.param(POS0, 0.0137, 0.0213, 8, 2048, "rounds", id="k8"),
    # the kernel resumes the plain walk's state, and the other way round
    pytest.param(POS1, 0.8, -0.7, 8, 24, "plain_then_kernel",
                 id="plain-then-kernel"),
    pytest.param(POS1, 0.8, -0.7, 8, 24, "kernel_then_plain",
                 id="kernel-then-plain"),
    # a third of the beams dead before the first call
    pytest.param(POS1, 0.8, -0.7, 8, 24, "dead", id="dead"),
    # K7 on beams without a candidate and on cut lists
    pytest.param(POS0, 0.0137, 0.0213, 64, 2048, "truncated",
                 id="truncated"),
    # the origin on cell planes: entries of +0.0
    pytest.param((16.0, 8.0, 4.0), 0.5, -0.3, 16, 2048, "rounds",
                 id="on-planes"),
    # a terrain of height 7 from the smoke's pose
    pytest.param(tuple(np.asarray(vcam.DEFAULT_POSE.pos) * 128 / 8192),
                 vcam.DEFAULT_POSE.yaw, vcam.DEFAULT_POSE.pitch, 32, 512,
                 "height7", id="height7"),
])
def test_beam_walk_and_resolve_source_equal_plain(host_kernels, clutter,
                                                  terrain7, pos, yaw, pitch,
                                                  K, steps, case):
    """K6 and K7 under the warp emulation against their plain versions:
    every candidate, the resumed state and the five resolve outputs by
    bits over three rounds, the resolve also into the running best of the
    rounds before, then once with an origin a ray."""
    w, aug = terrain7 if case == "height7" else clutter
    o, dt = _beam_tiles(pos, yaw, pitch,
                        *((56, 24) if case == "ragged" else (64, 40)))
    ob = o.expand(dt.shape[0], 3)
    pre = beam._beam_bounds(w.height, ob, ob, torch.amin(dt, 1),
                            torch.amax(dt, 1))
    init = beam._initial_state(w.root, w.height, pre["incoherent"])
    if case == "dead":
        init["alive"][::3] = False
    st_k = {k: v.clone() for k, v in init.items()}
    st_p = {k: v.clone() for k, v in init.items()}
    rng = np.random.default_rng(3)
    best_k = best_p = None
    for side in BEAM_SIDES.get(case, ("kernel",) * 3):
        if side == "kernel":
            got = _walk_host(host_kernels["beam_walk"], aug, w.height, pre,
                             st_k, K, steps)
        else:
            got = beam.beam_walk_plain(aug, w.height, pre, st_k, K, steps)
        want = beam.beam_walk_plain(aug, w.height, pre, st_p, K, steps)
        _same_bits(got, want)
        _same_bits(st_k, st_p)
        _no_negative_zero(st_k["entry_stk"], st_k["cap"], got["t_safe"])
        c = _truncated(want, rng) if case == "truncated" else want
        res = _resolve_host(host_kernels["beam_resolve"], c, o, dt,
                            w.height)
        ref = beam.resolve_candidates_plain(c["lvl"], c["off"], c["rgb"], o,
                                            dt, w.height)
        _same_bits(res, ref)
        if best_k is None:
            best_k = {k: v.clone() for k, v in res.items()}
            best_p = {k: v.clone() for k, v in ref.items()}
        else:
            _resolve_host(host_kernels["beam_resolve"], c, o, dt, w.height,
                          best=best_k)
            beam.resolve_candidates_plain(c["lvl"], c["off"], c["rgb"], o,
                                          dt, w.height, best=best_p)
            _same_bits(best_k, best_p)
    # a later round's hit at the same t does not take the ray: the same
    # boxes in other colours leave the running best as it was
    again = dict(c, rgb=c["rgb"] + 0.5)
    best = _resolve_host(host_kernels["beam_resolve"], again, o, dt, w.height,
                         best={k: v.clone() for k, v in ref.items()})
    _same_bits(best, ref)
    assert (want["lvl"] >= 0).any() or bool(st_p["alive"].any())
    if case == "dead":
        assert not init["alive"][::3].any() and init["alive"].any()
    # one origin a ray (the shadow pass): hit points toward a sun
    sun = torch.tensor([0.3, 0.9, 0.2])
    sun = sun / torch.linalg.norm(sun)
    r = beam.resolve_candidates_plain(want["lvl"], want["off"], want["rgb"],
                                      o, dt, w.height)
    p = (o + dt * r["t"][..., None] - dt * 1e-3).contiguous()
    sd = sun.expand(p.shape).contiguous()
    res = _resolve_host(host_kernels["beam_resolve"], want, p, sd, w.height)
    ref = beam.resolve_candidates_plain(want["lvl"], want["off"], want["rgb"],
                                        p, sd, w.height)
    _same_bits(res, ref)
    # rays of a beam with other direction signs: each ray mirrors the
    # candidates itself (K7's per-ray path)
    dm = dt.clone()
    dm[:, ::3, 0] = -dm[:, ::3, 0]
    dm[:, 1::5, 2] = -dm[:, 1::5, 2]
    res = _resolve_host(host_kernels["beam_resolve"], want, o, dm, w.height)
    ref = beam.resolve_candidates_plain(want["lvl"], want["off"], want["rgb"],
                                        o, dm, w.height)
    _same_bits(res, ref)


def _bit_host(fn, bw, size, start, d, dist, active, skip_t0, fetch):
    """K8 (the walker of bit_walk.cuh on the lane fetch) through the host
    build; every output starts as garbage."""
    B = d.shape[0]
    got = dict(hit=torch.full((B,), True), t=torch.full((B,), 7.0),
               normal=torch.full((B, 3), 7.0),
               voxel=torch.full((B, 3), 7, dtype=torch.int32))
    counter = torch.zeros((1,), dtype=torch.int32)
    err = fn(bw[0].data_ptr(), bw[0].shape[0], bw[1].data_ptr(),
             bw[2].data_ptr(), size, start.data_ptr(), d.data_ptr(),
             dist.data_ptr(), None if active is None else active.data_ptr(),
             skip_t0, got["hit"].data_ptr(), got["t"].data_ptr(),
             got["normal"].data_ptr(), got["voxel"].data_ptr(), B,
             counter.data_ptr(), *fetch, None)
    assert err == 0
    return got


@pytest.mark.parametrize("fetch", FETCHES)
@pytest.mark.parametrize("B,frac,skip_t0", [(1, 1.0, 1), (777, 0.5, 1),
                                            (4099, None, 0)])
def test_bit_dda_source_equals_plain(host_kernels, B, frac, skip_t0, fetch):
    """K8's walker on the lane fetch against the plain version, by bits,
    under every lane-fetch setting: random starts inside and outside the
    grid (an eighth on integer points), random caps and masks."""
    from voxtracer_torch.world import bitgrid

    rng = np.random.default_rng(B)
    solid = rng.random((64, 64, 64)) < 0.1
    grid = bitgrid.from_dense(solid)
    bw = grid.to_device("cpu")
    start = rng.random((B, 3)).astype(np.float32) * 160 - 45
    start[: B // 8] = np.floor(start[: B // 8])
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dist = np.where(rng.random(B) < 0.3, rng.random(B) * 90.0,
                    1e12).astype(np.float32)
    start, d, dist = (torch.from_numpy(a) for a in (start, d, dist))
    active = None if frac is None else torch.from_numpy(rng.random(B) < frac)
    got = _bit_host(host_kernels["bit_dda"], bw, grid.size, start, d, dist,
                    active, skip_t0, fetch)
    want = bitdda.bitgrid_raycast_plain(*bw, grid.size, start, d, dist,
                                        bool(skip_t0), active)
    for key in want:
        assert np.array_equal(got[key].numpy().view(np.uint8),
                              want[key].numpy().view(np.uint8)), key
    if B > 1:
        assert want["hit"].any()


# ---- K9 (csrc/path_trace.cu): the bounce loop, one thread a path ----


K9_SUN = np.float32([0.5, 0.8, 0.33]) / np.float32(
    np.linalg.norm([0.5, 0.8, 0.33]))


@pytest.fixture(scope="module")
def k9_worlds():
    """A 32^3 terrain world for each of K9's engines: its node table, its
    pack, and for the edited engine the table after a dig and a white
    slab, with the box that covers them; the sun maps of the unedited
    terrain (the heightfield engine's option, "maps"); the bit grid of the
    unedited terrain, given with the pack and the maps that it wins over
    ("bit")."""
    from voxtracer_torch.core.spectra import build_wl_to_rgb_lut
    from voxtracer_torch.kernels import sunshadow
    from voxtracer_torch.world import bitgrid

    space = worldgen.generate(log2_size=5, verbose=False, device="cpu")
    h0 = np.asarray(space.heights).copy()
    dev = space.serialize()
    plain_w = svo.upload(dev.table, dev.root, dev.height, "cpu")
    pack = heightfield.build_height_mips(h0, device="cpu")
    cx, cz = np.unravel_index(np.argmax(h0[6:26, 6:26]), (20, 20))
    cx, cz = int(cx) + 6, int(cz) + 6
    top = int(h0[cx, cz])
    space.set((cx, top - 1, cz), None)
    for dx in range(3):
        for dz in range(3):
            space.set((cx + dx, top + 1, cz + dz), (1.0, 1.0, 1.0))
    ed = space.serialize()
    edited_w = svo.upload(ed.table, ed.root, ed.height, "cpu")
    bounds = torch.tensor([[cx - 1, top - 2, cz - 1], [cx + 4, top + 3, cz + 4]],
                          dtype=torch.float32)
    lut = torch.from_numpy(build_wl_to_rgb_lut(256))
    hf_kw = dict(hf_mips=pack[0], hf_offsets=pack[1],
                 terrain_rgb=space.terrain_rgb)
    maps = sunshadow.upload(sunshadow.build(h0, K9_SUN), "cpu")
    grid = bitgrid.from_heightmap(h0)
    return dict(svo=(plain_w, {}), hf=(plain_w, hf_kw),
                edited=(edited_w, dict(hf_kw, hf_edit_bounds=bounds)),
                maps=(plain_w, dict(hf_kw, sun_maps=maps)),
                bit=(plain_w, dict(hf_kw, sun_maps=maps,
                                   bitworld=grid.to_device("cpu"),
                                   bit_size=grid.size)),
                lut=lut, heights=h0, site=(cx, top, cz))


K9_BOUNCES, K9_FOG = 6, 8


def _k9_paths(k9_worlds, engine, B=512, primary=False, seed=9):
    """Paths from above and beside the terrain and the edit site: some
    aimed at the sky (they miss at bounce 0), the rest anywhere."""
    rng = np.random.default_rng(seed)
    w, kw = k9_worlds[engine]
    cx, top, cz = k9_worlds["site"]
    start = rng.uniform(2, 30, (B, 3)).astype(np.float32)
    start[:, 1] = rng.uniform(top + 2, 31, B)
    start[: B // 4] = np.float32([cx + 1.5, top + 5.5, cz + 1.5])
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[B // 4: B // 2, 1] = -np.abs(d[B // 4: B // 2, 1]) - 1.0
    d[-B // 8:, 1] = np.abs(d[-B // 8:, 1]) + 2.0
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wl = rng.random(B).astype(np.float32)
    state = rng.integers(0, 2**32, (B, 3), dtype=np.uint32)
    args = (w.table, w.root, w.height, k9_worlds["lut"],
            torch.from_numpy(start), torch.from_numpy(d), torch.from_numpy(wl),
            torch.from_numpy(K9_SUN), torch.from_numpy(state.astype(np.int64)),
            K9_BOUNCES, K9_FOG)
    prim = None
    if primary:
        pr = heightfield.hf_raycast(kw["hf_mips"], kw["hf_offsets"], w.height,
                                    args[4], args[5])
        prim = dict(hit=pr["hit"], t=pr["t"], normal=pr["normal"],
                    rgb=torch.as_tensor(kw["terrain_rgb"], dtype=torch.float32)
                    .expand(B, 3))
    return args, kw, prim


def _k9_host(fn, args, kw, prim, extra=0, fetch=None, stats=False):
    """K9's stages and its burn pass through the host build: (state,
    radiance, each path's last bounce, the work count, and each bounce's
    queue lengths: live, march, sun-march, shadow, the edited engine's
    two re-casts). ``stats``: the build that counts SIMT steps."""
    k9_kw = dict(primary=prim, hf_mips=kw.get("hf_mips"),
                 hf_offsets=kw.get("hf_offsets"),
                 terrain_rgb=kw.get("terrain_rgb"),
                 hf_edit_bounds=kw.get("hf_edit_bounds"),
                 sun_maps=kw.get("sun_maps"), bitworld=kw.get("bitworld"),
                 bit_size=kw.get("bit_size", 0), extra_draws=extra,
                 stats=stats)
    if fetch is not None:
        k9_kw["fetch"] = fetch
    c_args, outs = integrator.k9_args(*args, **k9_kw)
    assert fn(*c_args, None) == 0
    state, color = integrator.k9_result(outs)
    return (state, color, outs[3]["last"], outs[3]["work"],
            outs[3]["counters"][:, :len(integrator.K9_QUEUES)])


def _golden(img, want):
    img, want = img.numpy(), want.numpy()
    assert np.isfinite(img).all()
    assert (np.abs(img - want) > 1e-3).mean() <= 5e-3
    assert abs(img.mean() / want.mean() - 1.0) <= 1e-3


K9_CASES = [("hf", False), ("hf", True), ("svo", False), ("edited", False),
            ("maps", False), ("bit", False), ("bit", True)]


@pytest.mark.parametrize("engine,primary", K9_CASES)
def test_path_trace_source_matches_plain(host_kernels, k9_worlds, engine,
                                         primary, monkeypatch):
    """K9's stages on each engine against the masked loop: the returned
    state by bits in every lane (the burn pass gives every path the draws
    of the loop's bounces), the radiance under the golden contract (the
    host's expf, logf, sinf and cosf are not torch's). Some paths miss at
    bounce 0, some die under roulette, some live through every bounce:
    roulette changes no path's geometry or draws, so the paths that end
    sooner than with roulette off are the ones it killed. The queues: a
    bounce's live queue holds the paths that reach it, the march queues
    the marches the scatter-free test left, the shadow queue live lanes
    only; every lane-fetch step is a fog segment or a walk step. With
    the sun maps, K9's state and radiance equal its own without them by
    bits, and the lanes it counts as settled by the maps are the ones
    that leave its shadow queue and the masked loop's count of the
    lanes sun_clear proves lit."""
    args, kw, prim = _k9_paths(k9_worlds, engine, primary=primary)
    steps = (heightfield.plain_lane_steps, traverse.plain_lane_steps,
             bitdda.plain_lane_steps, integrator.plain_sun_lit)
    st, col, last, work, queues = _k9_host(host_kernels["path_trace"], args,
                                           kw, prim)
    st_p, col_p = integrator.trace_paths_plain(*args, primary=prim, **kw)
    w = dict(zip(integrator.K9_WORK, work.tolist()))
    # the kernel's count of its walk steps: the masked loop's walks take
    # the same steps (up to the paths the host's libm sends elsewhere)
    plain = (heightfield.plain_lane_steps - steps[0],
             traverse.plain_lane_steps - steps[1],
             bitdda.plain_lane_steps - steps[2])
    for name, want in zip(("hf_steps", "svo_steps", "bit_steps"), plain):
        assert abs(w[name] - want) <= 0.02 * want, name
    assert (w["bit_steps"] > 0) == (engine == "bit")
    assert w["bounces"] == int(last.sum()) + len(last)
    assert torch.equal(st, st_p)
    _golden(col, col_p)
    assert w["sun_lit"] == integrator.plain_sun_lit - steps[3]
    assert (w["sun_lit"] > 0) == (engine == "maps")
    if engine == "maps":
        no_maps = dict(kw, sun_maps=None)
        st_n, col_n, last_n, work_n, queues_n = _k9_host(
            host_kernels["path_trace"], args, no_maps, prim)
        for g, want in ((st, st_n), (col, col_n), (last, last_n)):
            assert torch.equal(g, want)
        assert int(queues_n[:, 3].sum() - queues[:, 3].sum()) == w["sun_lit"]
    assert queues[:, 0].tolist() == [int((last >= b).sum())
                                     for b in range(K9_BOUNCES)]
    assert int(queues[:, 1].sum()) == w["marches"] - w["marches_free"]
    assert int(queues[:, 2].sum()) == w["sun_marches"] - w["sun_marches_free"]
    assert (queues[:, 3] <= queues[:, 0]).all() and queues[:, 3].sum() > 0
    assert (queues[:, 4:].sum() > 0) == (engine == "edited")
    assert w["marches_free"] > 0 and w["sun_marches_free"] > 0
    # the stats build: the same outputs and counts, and its SIMT steps
    # (each a fog segment or a walk step)
    n = len(integrator.K9_COUNTS)
    got = _k9_host(host_kernels["path_trace"], args, kw, prim, stats=True)
    for g, want in zip(got[:3] + (got[3][:n], got[4]),
                       (st, col, last, work[:n], queues)):
        assert np.array_equal(g.numpy().view(np.uint8),
                              want.numpy().view(np.uint8))
    assert not work[n:].any()
    w = dict(zip(integrator.K9_WORK, got[3].tolist()))
    assert w["march_lane_steps"] + w["sun_march_lane_steps"] \
        == w["fog_segments"]
    assert sum(w[f"{s}_lane_steps"] for s in ("cast", "shadow", "recast",
                                               "shadow_recast")) \
        == w["hf_steps"] + w["svo_steps"] + w["bit_steps"]
    for stage in integrator.K9_STAGES:
        assert w[f"{stage}_lane_steps"] <= 32 * w[f"{stage}_warp_steps"]
    consts = integrator._K9_CONSTS.copy()
    consts[9] = 0.0  # RR_THRESHOLD: no light is below it
    monkeypatch.setattr(integrator, "_K9_CONSTS", consts)
    last_off = _k9_host(host_kernels["path_trace"], args, kw, prim)[2]
    assert ((last == 0) & (last_off == 0)).any()  # missed at bounce 0
    assert (last < last_off).any()  # killed by roulette
    assert (last == K9_BOUNCES - 1).any()
    assert (col.sum(-1) == 0).any() and (col.sum(-1) > 0).any()


@pytest.mark.parametrize("engine,primary", K9_CASES)
def test_path_trace_source_is_fetch_invariant(host_kernels, k9_worlds,
                                              engine, primary):
    """Which thread runs which path, and when, changes no bit of K9's
    outputs, under every lane-fetch setting: state, radiance, last
    bounces, queue lengths, and every work count but the warp steps (a
    warp's steps are its longest thread's, which the schedule decides)."""
    args, kw, prim = _k9_paths(k9_worlds, engine, B=300, primary=primary,
                               seed=5)
    fn = host_kernels["path_trace"]
    per_path = [k for k, name in enumerate(integrator.K9_WORK)
                if "_warp_" not in name]
    want = _k9_host(fn, args, kw, prim)
    for fetch in FETCHES:
        got = _k9_host(fn, args, kw, prim, fetch=fetch)
        for g, w in zip(got[:3] + (got[3][per_path], got[4]),
                        want[:3] + (want[3][per_path], want[4])):
            assert np.array_equal(g.numpy().view(np.uint8),
                                  w.numpy().view(np.uint8)), fetch


def test_path_trace_source_fused_state(host_kernels, k9_worlds):
    """The fused bounce/NEE's 3 more draws in the burn pass: the radiance
    of the unfused call by bits, every lane's state 3 pcg3d steps ahead,
    as the plain version's fused state."""
    from voxtracer_torch.core import rng as trng

    args, kw, prim = _k9_paths(k9_worlds, "hf", B=300, seed=6)
    fn = host_kernels["path_trace"]
    st, col = _k9_host(fn, args, kw, prim)[:2]
    st_f, col_f = _k9_host(fn, args, kw, prim, extra=3)[:2]
    assert torch.equal(col, col_f)
    assert torch.equal(trng.pcg3d(trng.pcg3d(trng.pcg3d(st))), st_f)
    st_p, _ = integrator.trace_paths_plain(*args, fuse_nee=True, **kw)
    assert torch.equal(st_f, st_p)
