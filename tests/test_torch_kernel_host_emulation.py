"""The CUDA sources of K2 (csrc/svo_cast.cu) and K1 (csrc/fog_march.cu),
lane fetch (csrc/lanes.cuh) included, compiled for the host and run under
a small emulation of the CUDA features they use: every thread of a block
is a std::thread, the 32 threads of a warp meet at a barrier for each
warp collective (__ballot_sync, __shfl_sync, __syncwarp), blocks run one
after another, and the "card" has 2 SMs of 2 blocks. It runs the
kernels' real scheduling code on the CPU: the round-robin and claimed
lanes, the per-warp queue, the refills, and the outputs of inactive
lanes.

K2 must equal its plain version bit for bit (its float operations are
IEEE on both sides). K1 calls expf, and the host's expf differs from
torch.exp in the last bit for ~1% of inputs, so K1 is held bit for bit
to itself under every lane-fetch setting and mask; against its plain
version, its codes may differ on 0.5% of the lanes, a planet hit's t by
an ulp of the planet-scale terms it cancels, and a scatter point by
about one segment.

Needs g++ with C++20 (<barrier>); skips without it.
"""

import ctypes
import re
import shutil
import subprocess

import numpy as np
import pytest
import torch

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.core.spectra import fog_density
from voxtracer_torch.kernels import build, fog, traverse
from voxtracer_torch.world import svo, worldgen

torch.set_num_threads(2)

SHIM = r"""
#pragma once
#include <algorithm>
#include <atomic>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <thread>
#include <vector>
#define __global__
#define __device__
#define __forceinline__ inline
#define __restrict__
#define __launch_bounds__(...)
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
template <class K, class... A>
void emu_launch(K kernel, int blocks, int threads, size_t smem, cudaStream_t,
                A... args) {
  blockDim.x = threads;
  gridDim.x = blocks;
  std::vector<int> dyn(smem / sizeof(int) + 1);
  for (int b = 0; b < blocks; ++b) {
    std::barrier<> block_bar(threads);
    g_block_bar = &block_bar;
    g_dyn_smem = dyn.data();
    std::vector<EmuWarp> warps((threads + 31) / 32);
    std::vector<std::thread> ts;
    for (int x = 0; x < threads; ++x)
      ts.emplace_back([&, x, b] {
        threadIdx.x = x;
        blockIdx.x = b;
        t_warp = &warps[x / 32];
        kernel(args...);
      });
    for (auto& t : ts) t.join();
  }
}
"""

# lane-fetch settings (static percent, chunk, refill): the wrappers' and
# the corners
FETCHES = [(traverse.STATIC_PCT, traverse.CHUNK, traverse.REFILL),
           (fog.STATIC_PCT, fog.CHUNK, fog.REFILL), (0, 32, 32),
           (100, 64, 1), (50, 96, 16)]


def _host_source(src: str) -> str:
    src = src.replace("extern __shared__ int smem[];",
                      "int* smem = g_dyn_smem;")
    return re.sub(r"(\w+)<<<([^>]*)>>>\(", r"emu_launch(\1, \2, ", src)


@pytest.fixture(scope="module")
def host_kernels(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the kernels for the host")
    out = tmp_path_factory.mktemp("host_kernels")
    (out / "cuda_runtime.h").write_text(SHIM)
    (out / "lanes.cuh").write_text((build.CSRC / "lanes.cuh").read_text())
    libs = {}
    procs = []
    for name in ("svo_cast", "fog_march"):
        cpp = out / f"{name}.cpp"
        cpp.write_text(_host_source((build.CSRC / f"{name}.cu").read_text()))
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
        fn = getattr(lib, f"voxt_{name}")
        fn.argtypes = list(build.SIGNATURES[f"voxt_{name}"])
        fn.restype = ctypes.c_int
        libs[name] = fn
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


def _fog_host(fn, args, active, n_steps, fetch):
    B = args[0].shape[0]
    code = torch.full((B,), 7, dtype=torch.int32)
    t = torch.full((B,), 7.0)
    counter = torch.zeros(1, dtype=torch.int32)
    err = fn(*(a.data_ptr() for a in args),
             None if active is None else active.data_ptr(), code.data_ptr(),
             t.data_ptr(), B, n_steps, fog.PLANET_R_F, fog.PLANET_R2_F,
             fog.FOG_R2_F, fog.FOG_FACTOR_F, counter.data_ptr(), *fetch, None)
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
    for fetch in FETCHES:
        c_all, t_all = _fog_host(fn, args, None, n_steps, fetch)
        assert torch.equal(c_all, code) and torch.equal(t_all, t)
        c_m, t_m = _fog_host(fn, args, active, n_steps, fetch)
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
