"""Old against new kernels on one card, in turns, and the device split of
a batch-8 main-path call.

    # K1/K2 of this tree against those of another tree's csrc/ (the
    # parent's C entry points, as of the kernels before their redesign),
    # timed old, new, new, old on the smoke's sets; ptxas reports of both;
    # with --sweep, new K1/K2 times over the lane fetch's static share,
    # chunk and refill
    python -m voxtracer_torch.tools.kernel_ab kernels --old-csrc DIR [--sweep]

    # ms per batch-8 sample_batch call at 1024^3, 853x480, and one
    # torch.profiler window over such a call, for whichever voxtracer_torch
    # is first on the path (so PYTHONPATH=<other tree> times that tree)
    python voxtracer_torch/tools/kernel_ab.py e2e [--reps N]

Every line it prints names the card and its power limit; it fails when
torch sees no card.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
# the C entry points of K1 and K2 before the persistent lane-fetch redesign
OLD_SIGNATURES = {
    "voxt_fog_march": (_P, _P, _P, _P, _P, _P, _I, _I, _F, _F, _F, _F, _P),
    "voxt_svo_cast": (_P, _I, _I, _P, _P, _P, _P, _I,
                      _P, _P, _P, _P, _P, _I, _P),
}
KERNEL_NAMES = ("svo_cast_kernel", "fog_march_kernel", "resolve_fold_kernel")
# (static percent, chunk, refill) of the lane fetch
SWEEP = [(p, c, r) for p in (0, 75, 90) for c in (32, 64)
         for r in (4, 8, 16)]


def card() -> str:
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
        check=True).stdout.strip().splitlines()[0]


def profile_call(fn):
    """Run ``fn`` once under torch.profiler. Returns a dict: wall ms, the
    union of device activity in ms and its share of the wall, the number
    of device kernels, and per kernel of KERNEL_NAMES its device ms and
    launches. Raises when the profiler records no device activity."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.monotonic() - t0)
    dev = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    spans = sorted((e.time_range.start, e.time_range.end) for e in dev)
    busy, end = 0.0, -1.0
    for a, b in spans:  # union of the device intervals, in microseconds
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    out = dict(wall_ms=wall, busy_ms=busy / 1e3, busy_share=busy / 1e3 / wall,
               device_events=len(dev), kernels={})
    for name in KERNEL_NAMES:
        mine = [e for e in dev if name in e.name]
        out["kernels"][name] = dict(
            ms=sum(e.time_range.end - e.time_range.start for e in mine) / 1e3,
            launches=len(mine))
    return out


def _ms(fn, reps: int) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def _old_library(old_csrc: Path):
    from voxtracer_torch.kernels import build

    out = build.BUILD_DIR / f"ab_old_{build._source_hash(old_csrc)}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = build.compile_library(old_csrc, out)
    lib = ctypes.CDLL(str(out))
    for name, argtypes in OLD_SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    return lib, report


def _ptxas_lines(report: str):
    """(source, registers, stack/spill line) for each kernel entry."""
    src, rows, props = None, [], None
    for line in report.splitlines():
        if line.startswith("== "):
            src = line[3:]
        elif "bytes stack frame" in line:
            props = line.strip()
        elif "Used" in line and "registers" in line:
            rows.append((src, line.split("Used")[1].strip(), props))
    return rows


class _Svo:
    """Old and new K2 on one set, preallocated outputs, direct calls."""

    def __init__(self, old, new, world, start, d, dist, active):
        import torch

        B = d.shape[0]
        dev = d.device
        self.old, self.new, self.w = old, new, world
        self.args = (start, d, dist, active)
        self.counter = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.outs = [dict(hit=torch.empty(B, dtype=torch.bool, device=dev),
                          t=torch.empty(B, device=dev),
                          node=torch.empty(B, dtype=torch.int32, device=dev),
                          normal=torch.empty((B, 3), device=dev),
                          voxel=torch.empty((B, 3), dtype=torch.int32,
                                            device=dev)) for _ in range(2)]

    def _common(self, out):
        import torch

        start, d, dist, active = self.args
        w = self.w
        return [w.table.data_ptr(), int(w.root), int(w.height),
                start.data_ptr(), d.data_ptr(), dist.data_ptr(),
                None if active is None else active.data_ptr(), 1,
                out["hit"].data_ptr(), out["t"].data_ptr(),
                out["node"].data_ptr(), out["normal"].data_ptr(),
                out["voxel"].data_ptr(), d.shape[0]], \
            torch.cuda.current_stream().cuda_stream

    def run_old(self):
        args, stream = self._common(self.outs[0])
        assert self.old.voxt_svo_cast(*args, stream) == 0

    def run_new(self, fetch=None):
        from voxtracer_torch.kernels import traverse as m

        args, stream = self._common(self.outs[1])
        self.counter.zero_()
        assert self.new.voxt_svo_cast(
            *args, self.counter.data_ptr(),
            *(fetch or (m.STATIC_PCT, m.CHUNK, m.REFILL)), stream) == 0

    def equal(self):
        import torch

        return all(torch.equal(self.outs[0][k], self.outs[1][k])
                   for k in self.outs[0])


class _Fog:
    """Old K1 (no mask: every lane marched) and new K1 (masked)."""

    def __init__(self, old, new, args, active):
        import torch

        B = args[0].shape[0]
        dev = args[0].device
        self.old, self.new, self.args, self.active = old, new, args, active
        self.counter = torch.zeros((1,), dtype=torch.int32, device=dev)
        self.outs = [(torch.empty(B, dtype=torch.int32, device=dev),
                      torch.empty(B, device=dev)) for _ in range(2)]

    def _consts(self):
        from voxtracer_torch.kernels import fog

        return (fog.PLANET_R_F, fog.PLANET_R2_F, fog.FOG_R2_F,
                fog.FOG_FACTOR_F)

    def run_old(self):
        import torch

        code, t = self.outs[0]
        assert self.old.voxt_fog_march(
            *(a.data_ptr() for a in self.args), code.data_ptr(),
            t.data_ptr(), code.shape[0], 64, *self._consts(),
            torch.cuda.current_stream().cuda_stream) == 0

    def run_new(self, fetch=None):
        import torch

        from voxtracer_torch.kernels import fog

        code, t = self.outs[1]
        self.counter.zero_()
        assert self.new.voxt_fog_march(
            *(a.data_ptr() for a in self.args),
            None if self.active is None else self.active.data_ptr(),
            code.data_ptr(), t.data_ptr(), code.shape[0], 64, *self._consts(),
            self.counter.data_ptr(),
            *(fetch or (fog.STATIC_PCT, fog.CHUNK, fog.REFILL)),
            torch.cuda.current_stream().cuda_stream) == 0

    def equal(self):
        import torch

        code, t = self.outs[0]
        if self.active is not None:
            code = torch.where(self.active, code, 0)
            t = torch.where(self.active, t, 0.0)
        return torch.equal(code, self.outs[1][0]) and \
            torch.equal(t, self.outs[1][1])


def run_kernels(old_csrc: Path, sweep: bool, reps: int):
    import torch

    sys.path.insert(0, str(Path.cwd()))
    import chip_smoke as cs
    from voxtracer_torch.kernels import build
    from voxtracer_torch.world import svo, worldgen

    smi = card()
    print(smi)
    dev = torch.device("cuda")
    old, old_report = _old_library(old_csrc)
    new = build.library()
    for tag, report in (("old", old_report), ("new", build.ptxas_report())):
        for src, regs, props in _ptxas_lines(report):
            print(f"ptxas {tag} {src}: {regs}; {props}")

    rng = np.random.default_rng(20261016)
    space = worldgen.generate(log2_size=cs.LOG2_SIZE, verbose=False,
                              device=dev).serialize()
    world = svo.upload(space.table, space.root, space.height, dev)
    cases = [(f"svo_cast {name} ({int(d.shape[0])} lanes, "
              f"{int(d.shape[0]) if a is None else int(a.sum())} active)",
              _Svo(old, new, world, s, d, dist, a))
             for name, s, d, dist, a in cs._svo_sets(rng, world, dev)]
    fog_cases = [("409440", cs._fog_inputs(rng, cs.RAYS, dev), [None])]
    wide = cs._fog_inputs(rng, cs.WIDE, dev)
    fog_cases.append((str(cs.WIDE), wide,
                      [m for _, m in cs._masks(rng, cs.WIDE, dev)]))
    for size, args, masks in fog_cases:
        for m in masks:
            share = "all" if m is None else f"{float(m.float().mean()):.2f}"
            cases.append((f"fog_march {size} lanes, active {share} (old "
                          "marches every lane)", _Fog(old, new, args, m)))

    for name, case in cases:
        case.run_old()
        case.run_new()
        torch.cuda.synchronize()
        if not case.equal():
            raise AssertionError(f"{name}: old and new kernels differ")
        times = [_ms(case.run_old, reps), _ms(case.run_new, reps),
                 _ms(case.run_new, reps), _ms(case.run_old, reps)]
        print(json.dumps(dict(case=name, card=smi, old_ms=[times[0], times[3]],
                              new_ms=[times[1], times[2]], equal=True)))
    if sweep:
        for name, case in cases:
            row = {"/".join(map(str, f)): _ms(lambda: case.run_new(f), reps)
                   for f in SWEEP}
            print(json.dumps(dict(sweep=name, card=smi,
                                  static_chunk_refill_ms=row)))


def run_e2e(reps: int):
    import torch

    import voxtracer_torch
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.render.driver import Renderer
    from voxtracer_torch.world import worldgen

    smi = card()
    dev = torch.device("cuda")
    s = 1024 / 8192.0
    cam = vcam.Camera(pos=tuple(np.asarray(vcam.DEFAULT_POSE.pos) * s),
                      yaw=vcam.DEFAULT_POSE.yaw, pitch=vcam.DEFAULT_POSE.pitch)
    sun = np.asarray([0.8, 10.2743, 3.7])
    space = worldgen.generate(log2_size=10, verbose=False, device=dev)
    r = Renderer(space.serialize(), 853, 480, seed=0, device=dev)
    r.sample_batch(cam, sun, 8)  # build, soup, bins, warm-up
    ms = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        r.sample_batch(cam, sun, 8)
        torch.cuda.synchronize()
        ms.append(1e3 * (time.monotonic() - t0))
    prof = profile_call(lambda: r.sample_batch(cam, sun, 8))
    print(json.dumps(dict(package=str(Path(voxtracer_torch.__file__).parent),
                          card=smi, batch8_call_ms=ms,
                          paths_per_px_per_s=[8e3 / m for m in ms],
                          profile=prof)))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--old-csrc", type=Path, required=True)
    k.add_argument("--sweep", action="store_true")
    k.add_argument("--reps", type=int, default=10)
    e = sub.add_parser("e2e")
    e.add_argument("--reps", type=int, default=3)
    a = ap.parse_args(argv)
    if a.mode == "kernels":
        run_kernels(a.old_csrc, a.sweep, a.reps)
    else:
        run_e2e(a.reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
