"""Old against new kernels on one card, in turns, and the device split of
a batch-8 main-path call.

    # the resolve fold (K3) of this tree against that of another tree's
    # csrc/ (one block per tile, no ray tile, no spans), timed old, new,
    # new, old with one clock (an event pair a call, behind a spin on the
    # card) on the smoke's five explicit-list cases, then the two main
    # folds again with the new kernel in its segment form; ptxas reports
    # of both; with --sweep, new K3 times over ray tile and spans
    python -m voxtracer_torch.tools.kernel_ab kernels --old-csrc DIR \
        [--sweep]

    # the heightfield walk (K4) of this tree against that of a tree from
    # before its redesign (one float a step from device memory, tile_log
    # a runtime int) and against variant trees (a copy of this tree's
    # csrc/ with hf_cast.cu or lanes.cuh edited; K4 alone is built from
    # each), on the smoke's K4 sets at 1024^3, or with --log2-size 13 the
    # main path's at 8192^3; in turns (old, new, each variant, then the
    # reverse), every output held equal; ptxas reports of each
    python -m voxtracer_torch.tools.kernel_ab hf_cast --old-csrc DIR \
        [--variant DIR ...] [--log2-size L] [--reps N]

    # the envelope lookup (K5) of this tree against that of a tree from
    # before its redesign (a thread a lane, a binary search of the row)
    # and against variant trees (copies of this tree's csrc/ with
    # sky_tmin.cu edited; --edits adds the named edits of SKY_EDITS made
    # here), K5 alone built from each; at 8192^3 on tiers 0 and 1, the
    # camera rays and batch-8 primaries at 853x480 and a 1920x1080
    # frame's camera rays; in turns (old, new in image order, new in lane
    # order, each variant, then the reverse), every output equal by bits
    # to the old kernel's; ptxas reports of each, and the row search's L2
    # sectors a lane and L1 lines a warp (chip_smoke._k5_search_reads)
    python -m voxtracer_torch.tools.kernel_ab sky_tmin --old-csrc DIR \
        [--variant DIR ...] [--edits] [--reps N]

    # the bounce loop (K9) of this tree against that of another tree's
    # csrc/ with the same C entry (the stage kernels) and against variant
    # trees (copies of a csrc/ with path_trace.cu edited; K9 alone is
    # built from each), on the captured trace_paths call of one batch-8
    # sample_batch at each of chip_smoke.phase_path_kernel's
    # configurations (1024^3 default Renderer, SVO engine, edit session;
    # 8192^3 main path; with --configs bit, the 1024^3 bit grid's batch-8
    # render_samples call); in turns (old, new, each variant, then the
    # reverse), radiance, state and last bounces equal by bits and the
    # work counts equal; --fetch P,C,R adds this tree's K9 under other
    # lane-fetch settings; ptxas reports of each; each side's host time
    # to enqueue its launches, its kernels' device ms and launches and
    # each bounce's device ms (one profiled run); the new K9's queue
    # lengths, settled shares and SIMT efficiency by stage; and the new
    # K9's launches as one CUDA graph (captured once, replayed: outputs
    # equal by bits, the replay's host time and device ms); --reps 0
    # times nothing
    python -m voxtracer_torch.tools.kernel_ab path_trace --old-csrc DIR \
        [--variant DIR ...] [--fetch P,C,R ...] [--reps N] \
        [--configs NAME ...]

    # the bit-grid DDA (K8) of this tree (bit_walk.cuh's walker on the
    # lane fetch) against that of a tree from before its redesign (one
    # thread a ray, the first form's C entry) and against variant trees
    # (copies of this tree's csrc/ with bit_dda.cu or bit_walk.cuh
    # edited), K8 alone built from each, on chip_smoke's K8 sets at
    # 1024^3 (camera, random, random with 10% active, batch-8 NEE); in
    # turns (old, new, each variant, this tree's K8 under each --fetch,
    # then the reverse), every output equal by bits; ptxas reports
    python -m voxtracer_torch.tools.kernel_ab bit_dda --old-csrc DIR \
        [--variant DIR ...] [--fetch P,C,R ...] [--reps N]

    # ms per batch-8 sample_batch call and per Renderer.preview_frame
    # (a shaded frame on the rasterizer, bins cached) at 1024^3, 853x480,
    # and one torch.profiler window over each, for whichever
    # voxtracer_torch is first on the path (so PYTHONPATH=<other tree>
    # times that tree). --engine hf | svo sets the Renderer's use_hf (the
    # heightfield walk K4, or the SVO cast K2, for bounce and shadow
    # rays); both runs hf, svo, svo, hf in turns in this one process;
    # package (the default) passes nothing, so a tree from before the
    # switch runs too. --log2-size 13 is the hf-only world (no preview
    # timing there: it has no bins).
    python voxtracer_torch/tools/kernel_ab.py e2e [--reps N] \
        [--engine package|hf|svo|both] [--log2-size L]

    # the beam engine's walk (K6) and resolve (K7) of this tree against
    # another tree's csrc/ (K6 and K7 alone built from each; K7's entry
    # with or without the running best), on every round of the 1920x1080
    # beam frame (tile 8, K 64, 512 steps, 6 rounds) at 1024^3 and
    # 8192^3: in turns (old, new, new, old), candidates, resumed state
    # and the five resolve outputs equal by bits; each round's live beams
    # and used slots; from the second round, the resolve and merge as the
    # frame runs them (old: the kernel, then _merge; new: into the
    # running best); ptxas reports of both
    python -m voxtracer_torch.tools.kernel_ab beam --old-csrc DIR \
        [--reps N] [--log2-size L ...]

    # the 1920x1080 beam frame (beam_primary_frame_cast) of whichever
    # voxtracer_torch is first on the path: ms a frame and K2's per-ray
    # cast of the same rays, host reads a frame, each round's live beams
    # and used slots, the fallback's tiles and pixels, and one profiled
    # frame (K6, K7 and K2 device ms in launch order, the other device
    # events by stretch of the frame, device-busy share); run the two
    # trees in turns (PYTHONPATH=<other tree>, then this one, then ...)
    python voxtracer_torch/tools/kernel_ab.py beam_frame [--reps N] \
        [--log2-size L ...]

    # the envelope build (K10) against its plain version on the 8192^3
    # world at the smoke pose, tiers 0 and 1, in turns (plain, K10, K10,
    # plain), E and S equal by bits: wall and host ms a build, K10's
    # device ms, one profiled build of each (device ms, device events)
    python -m voxtracer_torch.tools.kernel_ab env_build [--reps N]

    # K4 (and K2 beside it) on the smoke's ray sets over lane-fetch
    # settings (static percent, lanes per claim, idle threads to refill;
    # csrc/lanes.cuh): a choice of schedule, the results do not change
    python -m voxtracer_torch.tools.kernel_ab fetch [--reps N]

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
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
_L = ctypes.c_longlong
# the old tree's C entry point: K3 as one block per tile
OLD_RESOLVE_FOLD = (_P, _P, _P, _P, _P, _L, _P, _F, _F, _F, _F, _F,
                    _P, _P, _P, _I, _I, _I, _P)
# the old tree's K5 entry: E, bins, K, dir, n, bin_w, log2_d0, log2_g,
# far, t_min, stream
OLD_SKY_TMIN = (_P, _I, _I, _P, _I, _F, _F, _F, _F, _P, _P)
# K8's first C entry (one thread a ray, no lane fetch): top, top_words,
# regions, bricks, size, start, dir, distance, active, skip_t0, hit, t,
# normal, voxel, n, stream
OLD_BIT_DDA = (_P, _I, _P, _P, _I, _P, _P, _P, _P, _I, _P, _P, _P, _P, _I,
               _P)
# K9's stage kernels and its burn pass (csrc/path_trace.cu)
K9_KERNELS = ("path_bounce_kernel", "path_march_kernel", "path_cast_kernel",
              "path_recast_kernel", "path_shade_kernel", "path_shadow_kernel",
              "path_burn_kernel")
KERNEL_NAMES = ("svo_cast_kernel", "fog_march_kernel", "resolve_fold_kernel",
                "hf_cast_kernel", "sky_tmin_kernel") + K9_KERNELS
# (ray tile, spans) of the resolve fold; 0 is the launcher's own choice
FOLD_SWEEP = [(0, 0)] + [(rt, sp) for rt in (2, 4) for sp in (1, 2, 4, 8, 16)]


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
    launches, and under "path_trace" those of K9's kernels summed. Raises
    when the profiler records no device activity."""
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
    k9 = [out["kernels"][name] for name in K9_KERNELS]
    out["kernels"]["path_trace"] = dict(
        ms=sum(k["ms"] for k in k9), launches=sum(k["launches"] for k in k9))
    return out


def _old_library(old_csrc: Path):
    from voxtracer_torch.kernels import build

    out = build.BUILD_DIR / f"ab_old_{build._source_hash(old_csrc)}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = build.compile_library(old_csrc, out)
    lib = ctypes.CDLL(str(out))
    lib.voxt_resolve_fold.argtypes = list(OLD_RESOLVE_FOLD)
    lib.voxt_resolve_fold.restype = ctypes.c_int
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


class _Fold:
    """Old and new K3 on one explicit-list case, preallocated outputs,
    direct calls. ``old`` may be None where only the new kernel runs."""

    def __init__(self, old, new, carry, rows, valid, d, cam, tree_height):
        import torch

        self.old, self.new = old, new
        self.carry = tuple(c.contiguous() for c in carry)
        self.rows, self.valid, self.d = (rows.contiguous(),
                                         valid.contiguous(), d.contiguous())
        self.consts = (*(float(c) for c in cam), float(1 << tree_height),
                       1.0e12)
        self.outs = [tuple(torch.empty_like(c) for c in self.carry)
                     for _ in range(2)]

    def _args(self, out):
        import torch

        N, R = self.carry[0].shape
        K = self.rows.shape[-2]
        return [*(c.data_ptr() for c in self.carry), self.rows.data_ptr(),
                self.valid.data_ptr(), 0 if self.rows.dim() == 2 else K,
                self.d.data_ptr(), *self.consts,
                *(o.data_ptr() for o in out), N, R, K], \
            torch.cuda.current_stream().cuda_stream

    def run_old(self):
        args, stream = self._args(self.outs[0])
        assert self.old.voxt_resolve_fold(*args, stream) == 0

    def run_new(self, setting=(0, 0)):
        """``setting``: (ray tile, spans) forced on the launcher; 0 is
        its own choice."""
        args, stream = self._args(self.outs[1])
        assert self.new.voxt_resolve_fold(*args, *setting, stream) == 0

    def restore(self):
        """Nothing: neither kernel writes what it reads."""

    def equal(self):
        import torch

        return all(torch.equal(a, b) for a, b in zip(*self.outs))


class _FoldSeg(_Fold):
    """The same fold, old as above (its list gathered beforehand, as the
    old raster_bins did), new in the segment form: the sorted pair array
    read in place and the carry updated in place, restored before every
    call."""

    def __init__(self, old, new, carry, rows, valid, d, cam, tree_height,
                 bins, ok):
        import torch

        super().__init__(old, new, carry, rows, valid, d, cam, tree_height)
        self.bins, self.ok, self.cam, self.h = bins, ok, cam, tree_height
        self.state = tuple(torch.empty_like(c) for c in self.carry)
        self.outs[1] = self.state

    def restore(self):
        for s, c in zip(self.state, self.carry):
            s.copy_(c)

    def run_new(self):
        from voxtracer_torch.kernels import resolve as m

        b = self.bins
        m.resolve_fold_seg(*self.state, b["spairs"], None, b["seg_start"],
                           b["cand_k"], b["dmin_bits"], b["quantum"], self.d,
                           self.ok, self.cam, self.h, 1.0e12)


def _fold_ab(old, new, smi, sweep: bool, reps: int):
    """K3 old against new: the smoke's five explicit-list cases, then the
    two main folds again with the new kernel in its segment form."""
    import torch

    import chip_smoke as cs
    from voxtracer_torch.kernels import raster
    from voxtracer_torch.world import boxes, worldgen

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)
    dsvo = worldgen.generate(log2_size=cs.LOG2_SIZE, verbose=False,
                             device=dev).serialize()
    soup = boxes.extract_boxes(dsvo)
    soup_t = raster.soup_to_device(soup.lo, soup.size, soup.leaf, soup.rgb,
                                   dev)
    inp = cs._fold_inputs(rng, soup_t, dev)
    raw = cs._fold_cases(rng, inp, dev)
    cases = []
    for name, carry, rows, valid, d, cam in raw:
        N, R = carry[0].shape
        K = rows.shape[-2]
        bound = cs._fold_bound(N, R, K, 1 if rows.dim() == 2 else N)
        cases.append((f"resolve_fold {name}", bound,
                      _Fold(old, new, carry, rows, valid, d, cam,
                            cs.LOG2_SIZE)))
    for (name, carry, rows, valid, d, cam), bins, ok in (
            (raw[0], inp["bins"], inp["ok64"]),
            (raw[1], inp["binsj"], inp["ok512"])):
        N, R = carry[0].shape
        cases.append((f"resolve_fold {name}, new in the segment form",
                      cs._fold_bound(N, R, rows.shape[-2], N),
                      _FoldSeg(old, new, carry, rows, valid, d, cam,
                               cs.LOG2_SIZE, bins, ok)))
    for name, (bound_ms, bound_by), case in cases:
        # one clock for both sides; restore() is outside the event pairs
        def ms(fn):
            return cs._ms_fresh(case.restore, fn, reps)

        case.run_old()
        case.restore()
        case.run_new()
        torch.cuda.synchronize()
        if not case.equal():
            raise AssertionError(f"{name}: old and new kernels differ")
        row = dict(case=name, card=smi, bound_ms=bound_ms, bound_by=bound_by)
        if isinstance(case, _FoldSeg):
            # the in-place form moves less than the function the old
            # kernel computes: its own bound, for this run's data
            N, R = case.carry[0].shape
            better = int((case.state[0] < case.carry[0]).sum())
            row["new_bound_ms"], row["new_bound_by"] = cs._fold_seg_bound(
                N, R, case.rows.shape[-2], better)
        times = [ms(case.run_old), ms(case.run_new), ms(case.run_new),
                 ms(case.run_old)]
        print(json.dumps(dict(row, old_ms=[times[0], times[3]],
                              new_ms=[times[1], times[2]], equal=True)))
    if sweep:
        for name, _, case in cases:
            if isinstance(case, _FoldSeg):
                continue
            R = case.carry[0].shape[1]
            K = case.rows.shape[-2]
            row = {}
            for rt, sp in FOLD_SWEEP:
                if (rt == 4 and R % 128) or (sp > 1 and K // sp < 8):
                    continue
                row[f"{rt}/{sp}"] = cs._ms_fresh(
                    case.restore, lambda: case.run_new((rt, sp)), reps)
                torch.cuda.synchronize()
                if not case.equal():
                    raise AssertionError(f"{name}: differs at {rt}/{sp}")
            print(json.dumps(dict(sweep=name, card=smi,
                                  ray_tile_spans_ms=row)))


class _Hf:
    """K4 of several libraries on one ray set: direct calls, preallocated
    outputs a library, the lane counter zeroed before every call (a call
    with a spent counter walks no lane and keeps the last outputs)."""

    def __init__(self, libs, pack, start, d, distance, active):
        import torch

        from voxtracer_torch.kernels import heightfield as hf

        self.libs = libs
        self.tiles, self.offsets, self.height = pack
        self.rays = (start, d, distance, active)
        dev = d.device
        self.rows = hf.row_starts(self.offsets, dev)
        self.hmax_w = hf.terrain_max(self.tiles, self.offsets)
        B = d.shape[0]
        self.outs = [dict(
            hit=torch.empty((B,), dtype=torch.bool, device=dev),
            t=torch.empty((B,), dtype=torch.float32, device=dev),
            normal=torch.empty((B, 3), dtype=torch.float32, device=dev),
            voxel=torch.empty((B, 3), dtype=torch.int32, device=dev))
            for _ in libs]
        self.counter = torch.zeros((1,), dtype=torch.int32, device=dev)

    def restore(self):
        self.counter.zero_()

    def run(self, k):
        import torch

        from voxtracer_torch.kernels import heightfield as hf

        start, d, distance, active = self.rays
        out = self.outs[k]
        assert self.libs[k].voxt_hf_cast(
            self.tiles.data_ptr(), self.offsets[0], len(self.offsets) - 1,
            self.rows.data_ptr(), self.height, self.hmax_w.data_ptr(),
            start.data_ptr(), d.data_ptr(), distance.data_ptr(),
            None if active is None else active.data_ptr(), None, 1, 0,
            out["hit"].data_ptr(), out["t"].data_ptr(),
            out["normal"].data_ptr(), out["voxel"].data_ptr(), d.shape[0],
            self.counter.data_ptr(), hf.STATIC_PCT, hf.CHUNK, hf.REFILL,
            torch.cuda.current_stream().cuda_stream) == 0

    def equal(self, k, ref):
        import torch

        return all(torch.equal(self.outs[k][key], self.outs[ref][key])
                   for key in self.outs[k])


def _hf_library(csrc: Path):
    """K4 alone, built from ``csrc`` (hf_cast.cu and lanes.cuh; its C
    entry as this tree's, unchanged since K4 was first ported) into its
    own library; returns it and ptxas's report."""
    from voxtracer_torch.kernels import build

    out = build.BUILD_DIR / f"ab_hf_{build._source_hash(csrc)}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = build.compile_library(csrc, out, sources=("hf_cast.cu",))
    lib = ctypes.CDLL(str(out))
    lib.voxt_hf_cast.argtypes = list(build.SIGNATURES["voxt_hf_cast"])
    lib.voxt_hf_cast.restype = ctypes.c_int
    return lib, report


def run_hf(old_csrc: Path, variants, reps: int, log2_size: int):
    """K4 of this tree against a tree from before its redesign and against
    variant trees, on the smoke's K4 sets: at 1024^3 all of K2's sets, at
    8192^3 the main path's (chip_smoke.FULL_HF_SETS). Timed in turns
    (old, new, each variant, then the reverse), every output held equal
    to the new kernel's."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as cs
    from voxtracer_torch.kernels import build
    from voxtracer_torch.kernels import heightfield as hf
    from voxtracer_torch.world import svo, worldgen

    smi = card()
    print(smi)
    new = build.library()
    # the old tree and every variant built at once, one nvcc each
    trees = [old_csrc, *variants]
    with ThreadPoolExecutor(len(trees)) as pool:
        built = list(pool.map(_hf_library, trees))
    names = ["old", "new", *(v.name for v in variants)]
    libs = [built[0][0], new, *(lib for lib, _ in built[1:])]
    reports = [built[0][1], build.ptxas_report(),
               *(report for _, report in built[1:])]
    for name, report in zip(names, reports):
        for src, regs, props in _ptxas_lines(report):
            if src == "hf_cast.cu":
                print(f"ptxas {name} {src}: {regs}; {props}")

    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016 if log2_size == cs.LOG2_SIZE
                                else 20261017)
    space = worldgen.generate(log2_size=log2_size, verbose=False,
                              backend="native", device=dev)
    dsvo = space.serialize()
    world = svo.upload(dsvo.table, dsvo.root, dsvo.height, dev)
    pack = hf.build_height_mips(space.heights, device=dev)
    del space, dsvo
    turns = list(range(len(libs)))
    turns += turns[::-1]
    for name, start, d, distance, active in cs._svo_sets(rng, world, dev,
                                                         log2_size):
        if log2_size != cs.LOG2_SIZE and name not in cs.FULL_HF_SETS:
            continue
        case = _Hf(libs, pack, start, d, distance, active)
        for k in range(len(libs)):
            case.restore(k)
            case.run(k)
        torch.cuda.synchronize()
        for k in range(len(libs)):
            if not case.equal(k, 1):
                raise AssertionError(f"hf_cast {name}: {names[k]} differs "
                                     "from new")
        walk = {}
        before = hf.plain_lane_steps
        hf.hf_raycast_plain(*pack, start, d, distance, True, active,
                            walk=walk)
        steps = hf.plain_lane_steps - before
        bound_ms, bound_by = cs._hf_bound(pack, steps, d.shape[0], active,
                                          None)
        ms = {n: [] for n in names}
        for k in turns:
            ms[names[k]].append(cs._ms_fresh(case.restore,
                                             lambda k=k: case.run(k), reps))
        print(json.dumps(dict(case=f"hf_cast {name} at {1 << log2_size}^3",
                              card=smi, lanes=int(d.shape[0]),
                              lane_steps=steps, walk=cs._walk_shape(walk),
                              bound_ms=bound_ms, bound_by=bound_by, ms=ms,
                              equal=True)))
        sys.stdout.flush()


# K5 variants made from this tree's sky_tmin.cu: lists of (old text,
# new text). The search edits put another search that sets ks in place
# of the two binary searches (from _SEARCH_START to _SEARCH_END): one
# binary search over E, the first form's (bsearch-tiles: the order's
# effect alone); the summary counted with float4 loads, then the block
# (count-two-level: 2 dependent reads; K a multiple of 64, as the A/B's
# tables); the summary counted, then a binary search in the block
# (count-then-bsearch). direct-tiles: image order, but each thread reads
# its direction and writes its t_min itself (what the staging through
# shared memory buys); float-staging: the directions staged a float a
# thread, each float's segment and offset computed apart; with-fmod: the
# azimuth through fmodf(atan2f, 2 pi), the identity on atan2f's range.
# Diagnostic edits change the output and are not held equal: no-search
# (a rung from the slope's sign, no table read) times the kernel without
# its search.
_SEARCH_START = ("  // level 1: c = the summary entries below tan_adj, the "
                 "blocks of the\n")
_SEARCH_END = "  if (ks == 0) return 0.0f;\n"
_BELOW4 = ("(v.x < tan_adj) + (v.y < tan_adj) + (v.z < tan_adj) + "
           "(v.w < tan_adj)")
_COUNT_SUMMARY = (
    "  const int nblk = (a.K + kBlk - 1) / kBlk;\n"
    "  const float4* s4 =\n"
    "      reinterpret_cast<const float4*>(a.S + (int64_t)cb * a.sw);\n"
    "  int c = 0;\n"
    "#pragma unroll 8\n"
    "  for (int j = 0; j < (a.sw >> 2); ++j) {\n"
    "    const float4 v = __ldg(s4 + j);\n"
    f"    c += {_BELOW4};\n"
    "  }\n")
_SEARCHES = {
    "bsearch-tiles": (
        "  const float* row = a.E + (int64_t)cb * a.K;\n"
        "  int lo = 0, hi = a.K;\n"
        "  while (lo < hi) {\n"
        "    const int mid = (lo + hi) >> 1;\n"
        "    if (__ldg(row + mid) < tan_adj) lo = mid + 1; else hi = mid;\n"
        "  }\n"
        "  const int ks = lo;\n"),
    "count-two-level": _COUNT_SUMMARY + (
        "  int ks = a.K;\n"
        "  if (c < nblk) {\n"
        "    const float4* b4 = reinterpret_cast<const float4*>(\n"
        "        a.E + (int64_t)cb * a.K + c * kBlk);\n"
        "    const int quads = (min(kBlk, a.K - c * kBlk) + 3) >> 2;\n"
        "    int cnt = 0;\n"
        "#pragma unroll\n"
        "    for (int j = 0; j < kBlk / 4; ++j)\n"
        "      if (j < quads) {\n"
        "        const float4 v = __ldg(b4 + j);\n"
        f"        cnt += {_BELOW4};\n"
        "      }\n"
        "    ks = c * kBlk + cnt;\n"
        "  }\n"),
    "count-then-bsearch": _COUNT_SUMMARY + (
        "  int ks = a.K;\n"
        "  if (c < nblk) {\n"
        "    const float* row = a.E + (int64_t)cb * a.K;\n"
        "    int hi = min(c * kBlk + kBlk, a.K) - 1;\n"
        "    ks = c * kBlk;\n"
        "    while (ks < hi) {\n"
        "      const int mid = (ks + hi) >> 1;\n"
        "      if (__ldg(row + mid) < tan_adj) ks = mid + 1; else hi = mid;\n"
        "    }\n"
        "  }\n"),
    "no-search": "  const int ks = tan_adj < 0.0f ? 1 : a.K / 2;\n",
}
SKY_EDITS = {name: [(_SEARCH_START, code + "#if 0\n" + _SEARCH_START),
                    (_SEARCH_END, "#endif\n" + _SEARCH_END)]
             for name, code in _SEARCHES.items()}
SKY_EDITS["direct-tiles"] = [
    ("  if (mine) {\n    float* p = sdir",
     "  if (false) {\n    float* p = sdir"),
    ("      const float* p = sdir + r * kSegPad + 3 * xl;\n"
     "      sout[r * kOutPad + xl] = ray_tmin(p[0], p[1], p[2], a);",
     "      const int i = ((s0 + ss) * a.img_h + y0 + yy) * a.img_w + x0 + xl;"
     "\n      const float* p = a.dir + 3 * i;\n"
     "      a.t_min[i] = ray_tmin(p[0], p[1], p[2], a);"),
    ("  if (mine) a.t_min[pix] =", "  if (false) a.t_min[pix] =")]
SKY_EDITS["float-staging"] = [
    ("  if (mine) {\n    float* p = sdir",
     "  for (int f = threadIdx.x; f < kSegs * kSeg; f += kThreads) {\n"
     "    const int qf = f / kSeg, ef = f - qf * kSeg;\n"
     "    const int sf = s0 + (qf >> a.ty_log);\n"
     "    const int yf = y0 + (qf & ((1 << a.ty_log) - 1));\n"
     "    if (sf < a.img_s && yf < a.img_h &&\n"
     "        ef < 3 * min(kTileX, a.img_w - x0))\n"
     "      sdir[qf * kSegPad + ef] = a.dir[((int64_t)sf * a.img_h + yf)"
     " * a.img_w * 3 + 3 * x0 + ef];\n"
     "  }\n"
     "  if (false) {\n    float* p = sdir")]
SKY_EDITS["with-fmod"] = [("  float m = atan2f(dz, dx);\n",
                           "  float m = fmodf(atan2f(dz, dx), kTwoPi);\n")]
SKY_DIAGNOSTIC = ("no-search",)


def _sky_edit_tree(name: str) -> Path:
    """A copy of this tree's csrc/ with the SKY_EDITS edit ``name`` made
    to sky_tmin.cu, under the build directory; returns its path."""
    from voxtracer_torch.kernels import build

    src = (build.CSRC / "sky_tmin.cu").read_text()
    for old, new in SKY_EDITS[name]:
        if src.count(old) != 1:
            raise ValueError(f"edit {name}: {old!r} not found once")
        src = src.replace(old, new)
    out = build.BUILD_DIR / "ab_sky_edits" / name
    out.mkdir(parents=True, exist_ok=True)
    (out / "sky_tmin.cu").write_text(src)
    return out


def _sky_library(csrc: Path, old: bool):
    """K5 alone, built from ``csrc`` into its own library; returns it and
    ptxas's report. ``old``: the entry of the first form (OLD_SKY_TMIN)."""
    from voxtracer_torch.kernels import build

    out = build.BUILD_DIR / f"ab_sky_{build._source_hash(csrc)}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = build.compile_library(csrc, out, sources=("sky_tmin.cu",))
    lib = ctypes.CDLL(str(out))
    lib.voxt_sky_tmin.argtypes = list(
        OLD_SKY_TMIN if old else build.SIGNATURES["voxt_sky_tmin"])
    lib.voxt_sky_tmin.restype = ctypes.c_int
    return lib, report


def run_sky(old_csrc: Path, variants, edits: bool, reps: int):
    """K5 of this tree against a tree from before its redesign and
    against variant trees, on the envelope tiers 0 and 1 of the 8192^3
    world at the smoke pose: camera rays and batch-8 primaries at
    853x480, a 1920x1080 frame's camera rays. Timed in turns, every
    output equal by bits to the old kernel's; one JSON line a set."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as cs
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import build
    from voxtracer_torch.kernels import heightfield as hf
    from voxtracer_torch.kernels import skyline
    from voxtracer_torch.render.driver import Renderer
    from voxtracer_torch.world import worldgen

    smi = card()
    print(smi)
    variants = list(variants) + ([_sky_edit_tree(n) for n in SKY_EDITS]
                                 if edits else [])
    trees = [old_csrc, Path(build.CSRC), *variants]
    with ThreadPoolExecutor(len(trees)) as pool:
        built = list(pool.map(_sky_library, trees,
                              [True] + [False] * (len(trees) - 1)))
    vnames = [v.name for v in variants]
    for name, (_, report) in zip(["old", "new", *vnames], built):
        for src, regs, props in _ptxas_lines(report):
            print(f"ptxas {name} {src}: {regs}; {props}")
    old_lib, new_lib = built[0][0], built[1][0]
    # (name, library, image order)
    runs = [("old", old_lib, False), ("new", new_lib, True),
            ("new, lane order", new_lib, False),
            *((n, lib, True) for n, (lib, _) in zip(vnames, built[2:]))]

    dev = torch.device("cuda")
    L = cs.FULL_LOG2_SIZE
    pack = hf.build_height_mips(worldgen.heightmap(L, device=dev), device=dev)
    levels = skyline.sky_levels_from_hf(*pack)
    cam = cs._smoke_camera(L)
    _, cd = cs._camera_rays(cam, dev)
    _, hd = vcam.generate_rays(cam, 1920, 1080, device=dev)
    sets = [("camera rays", cd, (1, cs.HEIGHT, cs.WIDTH)),
            ("batch-8 primaries", cs._batch8_primaries(None, cam, dev),
             (8, cs.HEIGHT, cs.WIDTH)),
            ("1920x1080 camera rays", hd.reshape(-1, 3).contiguous(),
             (1, 1080, 1920))]
    stream = torch.cuda.current_stream().cuda_stream
    for tier in (0, 1):
        env = skyline.build_skyline_env_device(
            levels, np.asarray(cam.pos, np.float64),
            **Renderer.SKY_TIERS[tier][0])
        E, S = env["E"], env["S"]
        bins, K = E.shape
        consts = skyline._consts(bins, env["d0"], env["g"])
        for set_name, d, shape in sets:
            B = d.shape[0]
            outs = [torch.empty((B,), dtype=torch.float32, device=dev)
                    for _ in runs]

            def call(k):
                _, lib, image = runs[k]
                if lib is old_lib:
                    err = lib.voxt_sky_tmin(
                        E.data_ptr(), bins, K, d.data_ptr(), B, *consts,
                        skyline.FAR, outs[k].data_ptr(), stream)
                else:
                    err = lib.voxt_sky_tmin(
                        E.data_ptr(), S.data_ptr(), bins, K, S.shape[1],
                        d.data_ptr(), B, *(shape if image else (0, 0, 0)),
                        *consts, skyline.FAR, outs[k].data_ptr(), stream)
                assert err == 0

            for k in range(len(runs)):
                call(k)
            torch.cuda.synchronize()
            for k in range(1, len(runs)):
                if runs[k][0] in SKY_DIAGNOSTIC:
                    continue
                if not torch.equal(outs[k].view(torch.int32),
                                   outs[0].view(torch.int32)):
                    n = int((outs[k].view(torch.int32)
                             != outs[0].view(torch.int32)).sum())
                    raise AssertionError(f"sky_tmin {set_name} tier {tier}: "
                                         f"{runs[k][0]} differs from old in "
                                         f"{n} lanes")
            turns = list(range(len(runs)))
            turns += turns[::-1]
            ms = {name: [] for name, _, _ in runs}
            for k in turns:
                ms[runs[k][0]].append(cs._ms_fresh(
                    lambda: None, lambda k=k: call(k), reps))
            bound_ms, bound_by = cs._sky_bound(d, E, consts[0])
            print(json.dumps(dict(
                case=f"sky_tmin {set_name} at {1 << L}^3, tier {tier}",
                card=smi, lanes=B, table=[bins, K], summary=list(S.shape),
                bound_ms=bound_ms, bound_by=bound_by,
                search_reads=cs._k5_search_reads(E, S, d, shape, consts[0]),
                ms=ms, equal_to_old_by_bits=[
                    n for n, _, _ in runs[1:] if n not in SKY_DIAGNOSTIC],
                diagnostic_not_held_equal=[
                    n for n, _, _ in runs if n in SKY_DIAGNOSTIC])))
            sys.stdout.flush()


def run_env_build(reps: int):
    """K10 against the plain envelope build (skyline._env_device) on the
    8192^3 world at the smoke pose, the Renderer's tiers 0 and 1, in
    turns (plain, K10, K10, plain): E and S equal by bits; each side's
    wall ms of a synchronised build and host ms to enqueue one (host
    clock, medians of ``reps``), K10's ms on CUDA events (a pair a build
    behind a spin), and one profiled build of each side (device busy ms,
    device events). One JSON line a tier."""
    sys.path.insert(0, str(Path.cwd()))
    import statistics

    import torch

    import chip_smoke as cs
    from voxtracer_torch.kernels import heightfield as hf
    from voxtracer_torch.kernels import skyline
    from voxtracer_torch.render.driver import Renderer
    from voxtracer_torch.world import worldgen

    smi = card()
    print(smi)
    dev = torch.device("cuda")
    L = cs.FULL_LOG2_SIZE
    levels = skyline.sky_levels_from_hf(*hf.build_height_mips(
        worldgen.heightmap(L, device=dev), device=dev))
    origin = np.asarray(cs._smoke_camera(L).pos, np.float64)
    for tier in (0, 1):
        kw = Renderer.SKY_TIERS[tier][0]

        def plain(kw=kw):
            E = skyline._env_device(
                levels["flat"], levels["coarse"], origin, levels["offsets"],
                kw["bins"], kw["ratio"], kw["K"], 4.0, L, 1.0)
            return E, skyline.env_summary(E)

        def k10(kw=kw):
            env = skyline.build_skyline_env_device(levels, origin, **kw)
            return env["E"], env["S"]

        sides = dict(plain=plain, K10=k10)
        (Ep, Sp), (Ek, Sk) = plain(), k10()
        torch.cuda.synchronize()
        if not (torch.equal(Ep, Ek) and torch.equal(Sp, Sk)):
            raise AssertionError(f"env_build tier {tier}: K10's table "
                                 "differs from the plain build's")
        wall = {k: [] for k in sides}
        host = {k: [] for k in sides}
        for name in ("plain", "K10", "K10", "plain"):
            w, h = [], []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                sides[name]()
                t1 = time.perf_counter()
                torch.cuda.synchronize()
                w.append(1e3 * (time.perf_counter() - t0))
                h.append(1e3 * (t1 - t0))
            wall[name].append(statistics.median(w))
            host[name].append(statistics.median(h))
        prof = {k: profile_call(fn) for k, fn in sides.items()}
        print(json.dumps(dict(
            case=f"env_build tier {tier} at {1 << L}^3", card=smi, kw=kw,
            equal_by_bits=True, wall_ms=wall, host_ms=host,
            k10_event_ms=cs._ms_fresh(lambda: None, k10, reps),
            device_busy_ms={k: p["busy_ms"] for k, p in prof.items()},
            device_events={k: p["device_events"] for k, p in prof.items()})))
        sys.stdout.flush()


def run_kernels(old_csrc: Path, sweep: bool, reps: int):
    sys.path.insert(0, str(Path.cwd()))
    from voxtracer_torch.kernels import build

    smi = card()
    print(smi)
    old, old_report = _old_library(old_csrc)
    new = build.library()
    for tag, report in (("old", old_report), ("new", build.ptxas_report())):
        for src, regs, props in _ptxas_lines(report):
            print(f"ptxas {tag} {src}: {regs}; {props}")
    _fold_ab(old, new, smi, sweep, reps)


def _bit_library(csrc: Path):
    """K8 alone, built from ``csrc`` into its own library: (lib, ptxas's
    report, whether its C entry is the first form's)."""
    from voxtracer_torch.kernels import build

    first = "run_lanes" not in (csrc / "bit_dda.cu").read_text()
    out = build.BUILD_DIR / f"ab_bit_{build._source_hash(csrc)}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = build.compile_library(csrc, out, sources=("bit_dda.cu",))
    lib = ctypes.CDLL(str(out))
    lib.voxt_bit_dda.argtypes = list(
        OLD_BIT_DDA if first else build.SIGNATURES["voxt_bit_dda"])
    lib.voxt_bit_dda.restype = ctypes.c_int
    return lib, report, first


def run_bit(old_csrc: Path, variants, reps: int, fetches=()):
    """K8 of this tree against a tree's from before its redesign and
    against variant trees on chip_smoke's K8 sets, in turns, every output
    equal by bits."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as cs
    from voxtracer_torch.kernels import bitdda, build
    from voxtracer_torch.world import bitgrid, svo, worldgen

    smi = card()
    print(smi)
    build.library()
    trees = [old_csrc, Path(build.CSRC), *variants]
    with ThreadPoolExecutor(len(trees)) as pool:
        built = list(pool.map(_bit_library, trees))
    tags = ["old", "new", *(v.name for v in variants)]
    for tag, (_, report, _) in zip(tags, built):
        for src, regs, props in _ptxas_lines(report):
            if src == "bit_dda.cu":
                print(f"ptxas {tag} {src}: {regs}; {props}")
    # a side: (lib, first form, lane-fetch settings)
    default = (bitdda.STATIC_PCT, bitdda.CHUNK, bitdda.REFILL)
    sides = [(lib, first, default) for lib, _, first in built]
    for fetch in fetches:
        sides.append((built[1][0], False, fetch))
        tags.append("new@" + "/".join(map(str, fetch)))
    turns = list(range(len(sides)))
    turns += turns[::-1]
    dev = torch.device("cuda")
    space = worldgen.generate(log2_size=cs.LOG2_SIZE, verbose=False,
                              backend="native", device=dev)
    d_svo = space.serialize()
    world = svo.upload(d_svo.table, d_svo.root, d_svo.height, dev)
    grid = bitgrid.from_heightmap(np.asarray(space.heights))
    top, regions, bricks = grid.to_device(dev)
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    for name, start, d, active in cs._bit_sets(world, dev):
        B = d.shape[0]
        dist = torch.full((B,), 1e12, dtype=torch.float32, device=dev)
        outs = [dict(hit=torch.empty((B,), dtype=torch.bool, device=dev),
                     t=torch.empty((B,), dtype=torch.float32, device=dev),
                     normal=torch.empty((B, 3), dtype=torch.float32,
                                        device=dev),
                     voxel=torch.empty((B, 3), dtype=torch.int32, device=dev))
                for _ in sides]

        def run(k):
            lib, first, fetch = sides[k]
            o = outs[k]
            fetch = () if first else (counter.data_ptr(), *fetch)
            err = lib.voxt_bit_dda(
                top.data_ptr(), top.shape[0], regions.data_ptr(),
                bricks.data_ptr(), grid.size, start.data_ptr(), d.data_ptr(),
                dist.data_ptr(), None if active is None else active.data_ptr(),
                1, o["hit"].data_ptr(), o["t"].data_ptr(),
                o["normal"].data_ptr(), o["voxel"].data_ptr(), B, *fetch,
                torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"bit_dda side {k}: CUDA error {err}")

        for k in range(len(sides)):
            counter.zero_()
            run(k)
        torch.cuda.synchronize()
        for k in range(len(sides)):
            if not all(torch.equal(outs[k][key], outs[1][key])
                       for key in outs[1]):
                raise AssertionError(f"bit_dda {name}: {tags[k]} differs "
                                     "from new")
        ms = {t: [] for t in tags}
        for k in turns:
            ms[tags[k]].append(cs._ms_fresh(counter.zero_,
                                            lambda k=k: run(k), reps))
        print(json.dumps(dict(case=f"bit_dda {name} at {grid.size}^3",
                              card=smi, lanes=B,
                              active=B if active is None
                              else int(active.sum()), ms=ms,
                              equal_by_bits=True)))
        sys.stdout.flush()


def _k9_library(csrc: Path):
    """K9 alone, built from ``csrc`` into its own library; returns it and
    ptxas's report. The tree must have this tree's C entry."""
    from voxtracer_torch.kernels import build

    if "bit_walk.cuh" not in (csrc / "path_trace.cu").read_text():
        raise ValueError(f"{csrc}: K9 before its bit-grid engine and sun "
                         "maps (another C entry)")
    out = build.BUILD_DIR / f"ab_k9_{build._source_hash(csrc)}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = build.compile_library(csrc, out, sources=("path_trace.cu",))
    lib = ctypes.CDLL(str(out))
    lib.voxt_path_trace.argtypes = list(build.SIGNATURES["voxt_path_trace"])
    lib.voxt_path_trace.restype = ctypes.c_int
    return lib, report


class _K9:
    """One captured trace_paths call run through K9 libraries: each side
    (lib, lane fetch or None for the default) its own outputs and zeroed
    counters."""

    def __init__(self, libs, args, kw):
        from voxtracer_torch.kernels import integrator

        self.inputs = integrator.k9_inputs(args, kw)
        self.libs = libs
        self.sides = []
        for _, fetch in libs:
            c_args, outs = integrator.k9_args(
                *self.inputs, **({} if fetch is None else dict(fetch=fetch)))
            self.sides.append((c_args, outs, outs[3]["zeroed"]))

    def restore(self, k):
        """Zero what side k's kernel must find zeroed."""
        for z in self.sides[k][2]:
            z.zero_()

    def run(self, k):
        import torch

        err = self.libs[k][0].voxt_path_trace(
            *self.sides[k][0], torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K9 side {k}: CUDA error {err}")

    def outputs(self, k):
        outs = self.sides[k][1]
        return outs[0], outs[1], outs[3]["last"]

    def equal(self, k, j):
        import torch

        return all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(self.outputs(k), self.outputs(j)))

    def work(self, k):
        return self.sides[k][1][3]["work"]

    def stats_run(self, k):
        """Side k once more with its stats build: (work with SIMT steps,
        queue lengths)."""
        import torch

        from voxtracer_torch.kernels import integrator

        c_args, outs = integrator.k9_args(*self.inputs, stats=True)
        err = self.libs[k][0].voxt_path_trace(
            *c_args, torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"K9 side {k} with stats: CUDA error {err}")
        torch.cuda.synchronize()
        return outs[3]["work"], outs[3]["counters"]

    def graph(self, k, reps):
        """Side k's zeroing and launches captured once as a CUDA graph and
        replayed: (outputs equal by bits to an eager run's, host ms of one
        replay, device ms a replay, device ms an eager run in the same
        way)."""
        import torch

        import chip_smoke as cs

        self.restore(k)
        self.run(k)
        torch.cuda.synchronize()
        want = [x.clone() for x in self.outputs(k)]
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            self.restore(k)
            self.run(k)
        for x in self.outputs(k):
            x.fill_(7)
        torch.cuda.synchronize()
        t0 = time.monotonic()
        g.replay()
        host_ms = 1e3 * (time.monotonic() - t0)
        torch.cuda.synchronize()
        same = all(torch.equal(a.view(torch.int32), b.view(torch.int32))
                   for a, b in zip(self.outputs(k), want))
        graph_ms = cs._ms(g.replay, reps)
        eager_ms = cs._ms(lambda: (self.restore(k), self.run(k)), reps)
        del g
        return same, host_ms, graph_ms, eager_ms


def _launch_split(fn):
    """One run of ``fn`` under torch.profiler: each K9 kernel's device ms
    and launches, and the device ms of each launch in order (its kernel's
    short name with it)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA
                  and "path_" in e.name),
                 key=lambda e: e.time_range.start)
    per, seq = {}, []
    for e in dev:
        name = e.name.split("path_", 1)[1].split("(", 1)[0]
        ms = (e.time_range.end - e.time_range.start) / 1e3
        k = per.setdefault(name, [0.0, 0])
        k[0] += ms
        k[1] += 1
        seq.append((name, round(ms, 4)))
    return per, seq


def _path_configs(dev, names):
    """The captured trace_paths call of one batch-8 sample_batch at each of
    chip_smoke.phase_path_kernel's configurations named in ``names``:
    (name, args, kwargs), the 1024^3 ones first, one world at a time."""
    import torch

    import chip_smoke as cs
    from voxtracer_torch.render.driver import Renderer
    from voxtracer_torch.world import worldgen

    sun = np.asarray([0.8, 10.2743, 3.7])
    if any(n != "8192" for n in names):
        space = worldgen.generate(log2_size=cs.LOG2_SIZE, verbose=False,
                                  backend="native", device=dev)
        cam = cs._smoke_camera(cs.LOG2_SIZE)
        for name, kw in (("default", {}),
                         ("svo", dict(use_soup=False, use_hf=False))):
            if name in names:
                r = Renderer(space.serialize(), cs.WIDTH, cs.HEIGHT, seed=0,
                             device=dev, **kw)
                r.sample_batch(cam, sun, 8)
                yield (f"1024^3 {name}", *cs._capture_call(
                    lambda: r.sample_batch(cam, sun, 8)))
                del r
        if "bit" in names:
            from voxtracer_torch.core.spectra import build_wl_to_rgb_lut
            from voxtracer_torch.kernels import integrator
            from voxtracer_torch.world import bitgrid, svo

            d_svo = space.serialize()
            w = svo.upload(d_svo.table, d_svo.root, d_svo.height, dev)
            grid = bitgrid.from_heightmap(np.asarray(space.heights))
            bw = grid.to_device(dev)
            lut = torch.from_numpy(build_wl_to_rgb_lut()).to(dev)
            seeds = np.arange(24, dtype=np.uint32).reshape(8, 3) + 7
            call = (w.table, w.root, w.height, lut,
                    np.asarray(cam.pos, np.float32), cam.basis(),
                    cs._sun(dev), seeds, cs.WIDTH, cs.HEIGHT)
            yield ("1024^3 bit grid", *cs._capture_call(
                lambda: integrator.render_samples(*call, bitworld=bw,
                                                  bit_size=grid.size)))
            del w, bw
        if "edit" in names:
            r = Renderer(space.serialize(), cs.WIDTH, cs.HEIGHT, seed=0,
                         device=dev)
            r.preview_frame(cam, sun)
            r.sample_batch(cam, sun, 8)
            for batches in (cs._exact_edits(space, cam),
                            cs._bounds_edits(space, cam)):
                for batch in batches:
                    for pt, val in batch:
                        space.set(pt, val)
                    r.apply_edits(space, edits=[pt for pt, _ in batch])
            if r._hf_bounds() is None:
                raise AssertionError("the edits left no bounds box")
            yield ("1024^3 edit session", *cs._capture_call(
                lambda: r.sample_batch(cam, sun, 8)))
            del r
        del space
        torch.cuda.empty_cache()
    if "8192" in names:
        space = worldgen.generate(log2_size=cs.FULL_LOG2_SIZE, verbose=False,
                                  backend="native", device=dev)
        cam = cs._smoke_camera(cs.FULL_LOG2_SIZE)
        r = Renderer(space.serialize(), cs.WIDTH, cs.HEIGHT, seed=0,
                     device=dev)
        del space
        r.sample_batch(cam, sun, 8)
        yield ("8192^3 main path", *cs._capture_call(
            lambda: r.sample_batch(cam, sun, 8)))


def _bounce_ms(seq):
    """Device ms of each bounce from a run's launches in order (a bounce
    kernel ends one bounce and begins the next: launches up to and with
    it count to the bounce it ends), the burn pass last."""
    out, cur = [], 0.0
    for name, ms in seq:
        cur += ms
        if name.startswith(("bounce_kernel", "burn_kernel")):
            out.append(round(cur, 4))
            cur = 0.0
    return out


def run_path_trace(old_csrc: Path, variants, reps: int, names, fetches=()):
    """K9 of this tree against another tree's and variant trees, on the
    captured calls of ``names`` (module doc). Timed in turns, every
    output held equal to the new kernel's."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as cs
    from voxtracer_torch.kernels import build, integrator

    smi = card()
    print(smi)
    build.library()
    trees = [old_csrc, Path(build.CSRC), *variants]
    with ThreadPoolExecutor(len(trees)) as pool:
        built = list(pool.map(_k9_library, trees))
    tags = ["old", "new", *(v.name for v in variants)]
    for tag, (_, report) in zip(tags, built):
        for src, regs, props in _ptxas_lines(report):
            if src == "path_trace.cu":
                print(f"ptxas {tag} {src}: {regs}; {props}")
    libs = [(lib, None) for lib, _ in built]
    # this tree's K9 again under other lane-fetch settings
    for fetch in fetches:
        libs.append((built[1][0], fetch))
        tags.append("new@" + "/".join(map(str, fetch)))
    turns = list(range(len(libs)))
    turns += turns[::-1]
    dev = torch.device("cuda")
    for name, args, kw in _path_configs(dev, names):
        case = _K9(libs, args, kw)
        for k in range(len(libs)):
            case.restore(k)
            case.run(k)
        torch.cuda.synchronize()
        w = dict(zip(integrator.K9_WORK, case.work(1).tolist()))
        for k in range(len(libs)):
            if not case.equal(k, 1):
                raise AssertionError(f"path_trace {name}: {tags[k]} differs "
                                     "from new")
            # a variant may count more (stats): K9_COUNTS are the work
            n = len(integrator.K9_COUNTS)
            if case.work(k).tolist()[:n] != case.work(1).tolist()[:n]:
                raise AssertionError(f"path_trace {name}: {tags[k]}'s work "
                                     f"{case.work(k).tolist()} against the "
                                     f"new one's {w}")
        work_s, queues = case.stats_run(1)
        stats, _, eff = cs._k9_stats(work_s, queues, int(args[10]))
        ms = {t: [] for t in tags}
        for k in turns if reps > 0 else ():  # --reps 0: bits and counts
            ms[tags[k]].append(cs._ms_fresh(lambda k=k: case.restore(k),
                                            lambda k=k: case.run(k), reps))
        # the host's time to enqueue each side's launches
        host_ms = {}
        for k in range(len(libs)):
            case.restore(k)
            torch.cuda.synchronize()
            t0 = time.monotonic()
            case.run(k)
            host_ms[tags[k]] = 1e3 * (time.monotonic() - t0)
            torch.cuda.synchronize()
        # each kernel's device ms, and each launch's, of one run of a side
        split = {}
        for k in range(len(libs)):
            case.restore(k)
            split[tags[k]] = _launch_split(lambda k=k: case.run(k))
        row = dict(case=f"path_trace {name}", card=smi,
                   paths=int(args[5].numel() // 3), ms=ms, host_ms=host_ms,
                   equal=True, work=w, simt=eff, stats=stats,
                   kernels={t: v[0] for t, v in split.items()},
                   bounce_ms={t: _bounce_ms(v[1]) for t, v in split.items()},
                   launches={t: v[1] for t, v in split.items()})
        if reps > 0:
            try:
                same, g_host, g_ms, e_ms = case.graph(1, reps)
                row["graph"] = dict(equal=same, replay_host_ms=g_host,
                                    replay_ms=g_ms, eager_ms=e_ms)
            except RuntimeError as e:  # a capture the driver refuses
                same, row["graph"] = True, dict(error=str(e)[:400])
        print(json.dumps(row))
        if reps > 0 and not same:
            raise AssertionError(f"path_trace {name}: the graph's outputs "
                                 "differ from an eager run's")
        sys.stdout.flush()
        del case


def run_e2e(reps: int, engine: str = "package", log2_size: int = 10):
    import torch

    import voxtracer_torch
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.render.driver import Renderer
    from voxtracer_torch.world import worldgen

    smi = card()
    dev = torch.device("cuda")
    s = (1 << log2_size) / 8192.0
    cam = vcam.Camera(pos=tuple(np.asarray(vcam.DEFAULT_POSE.pos) * s),
                      yaw=vcam.DEFAULT_POSE.yaw, pitch=vcam.DEFAULT_POSE.pitch)
    sun = np.asarray([0.8, 10.2743, 3.7])
    space = worldgen.generate(log2_size=log2_size, verbose=False, device=dev)
    dev_svo = space.serialize()
    turns = dict(both=("hf", "svo", "svo", "hf")).get(engine, (engine,))
    renderers = {}
    for name in turns:
        if name in renderers:
            continue
        kw = {} if name == "package" else dict(use_hf=name == "hf")
        r = Renderer(dev_svo, 853, 480, seed=0, device=dev, **kw)
        r.sample_batch(cam, sun, 8)  # build, soup, bins, pack, warm-up
        renderers[name] = r
    for name in turns:
        r = renderers[name]
        ms = []
        for _ in range(reps):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            r.sample_batch(cam, sun, 8)
            torch.cuda.synchronize()
            ms.append(1e3 * (time.monotonic() - t0))
        prof = profile_call(lambda: r.sample_batch(cam, sun, 8))
        row = dict(package=str(Path(voxtracer_torch.__file__).parent),
                   card=smi, engine=name, log2_size=log2_size,
                   batch8_call_ms=ms,
                   paths_per_px_per_s=[8e3 / m for m in ms], profile=prof)
        # the shaded preview frame: the rasterizer without its bins (cached
        # per pose), K3 and the PyTorch code around it
        if r.preview_frame(cam, sun) is not None and log2_size < 12:
            frame_ms = []
            for _ in range(10 * reps):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                r.preview_frame(cam, sun)
                torch.cuda.synchronize()
                frame_ms.append(1e3 * (time.monotonic() - t0))
            row.update(preview_frame_ms=frame_ms, preview_profile=profile_call(
                lambda: r.preview_frame(cam, sun)))
        print(json.dumps(row))


# (static percent, chunk, refill) of the persistent lane fetch
FETCH_SWEEP = [(75, 32, 4), (90, 32, 4), (90, 32, 8), (100, 32, 4),
               (75, 128, 4), (90, 128, 4), (90, 256, 8), (97, 128, 4),
               (97, 512, 4)]


def run_fetch(reps: int):
    """K4's and K2's ms on the smoke's ray sets for every setting of
    FETCH_SWEEP, one JSON line a set; the outputs must not change."""
    sys.path.insert(0, str(Path.cwd()))
    import torch

    import chip_smoke as cs
    from voxtracer_torch.kernels import heightfield, traverse
    from voxtracer_torch.world import svo, worldgen

    smi = card()
    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)
    space = worldgen.generate(log2_size=cs.LOG2_SIZE, verbose=False,
                              device=dev)
    dsvo = space.serialize()
    world = svo.upload(dsvo.table, dsvo.root, dsvo.height, dev)
    pack = heightfield.build_height_mips(space.heights, device=dev)
    casts = {
        "hf_cast": (heightfield, lambda *a, **k: heightfield.hf_raycast(
            *pack, *a, **k)),
        "svo_cast": (traverse, lambda *a, **k: traverse.svo_raycast(
            world.table, world.root, world.height, *a, **k)),
    }
    for name, start, d, distance, active in cs._svo_sets(rng, world, dev):
        for kernel, (mod, cast) in casts.items():
            keep = (mod.STATIC_PCT, mod.CHUNK, mod.REFILL)
            want = cast(start, d, distance, active=active)
            row = {}
            for fetch in FETCH_SWEEP:
                mod.STATIC_PCT, mod.CHUNK, mod.REFILL = fetch
                got = cast(start, d, distance, active=active)
                if not all(torch.equal(got[k], want[k]) for k in want):
                    raise AssertionError(f"{kernel} {name}: {fetch} changed "
                                         "an output")
                row["/".join(map(str, fetch))] = cs._ms(
                    lambda: cast(start, d, distance, active=active), reps)
            mod.STATIC_PCT, mod.CHUNK, mod.REFILL = keep
            print(json.dumps(dict(fetch_sweep=name, kernel=kernel, card=smi,
                                  lanes=int(d.shape[0]),
                                  pct_chunk_refill_ms=row)))


BEAM_KERNELS = ("beam_walk_kernel", "beam_resolve_kernel", "svo_cast_kernel")
# K7's C entry before the running best (no merge argument): lvl, off, rgb,
# origin, origin_per_ray, dir, height, skip_t0, hit, t, normal, rgb_out,
# voxel, n_beams, P, K, stream
OLD_BEAM_RESOLVE = (_P, _P, _P, _P, _I, _P, _I, _I, _P, _P, _P, _P, _P, _I,
                    _I, _I, _P)


def _smoke():
    """chip_smoke from the working directory, behind the voxtracer_torch
    already on the path (its beam frame: BEAM_KW, BEAM_WIDTH x
    BEAM_HEIGHT, the pose)."""
    if str(Path.cwd()) not in sys.path:
        sys.path.append(str(Path.cwd()))
    import chip_smoke

    return chip_smoke


def _beam_world(log2_size: int, dev):
    """The native terrain at 2^log2_size, its SVO on the card, the beam
    engine's augmented rows, the smoke's pose and its beam-frame rays."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import beam
    from voxtracer_torch.world import svo, worldgen

    cs = _smoke()
    space = worldgen.generate(log2_size=log2_size, verbose=False,
                              backend="native", device=dev)
    d_svo = space.serialize()
    world = svo.upload(d_svo.table, d_svo.root, d_svo.height, dev)
    aug = torch.from_numpy(beam.build_aug_table(d_svo.table,
                                                d_svo.solid_leaf)).to(dev)
    cam = cs._smoke_camera(log2_size)
    o, d = vcam.generate_rays(cam, cs.BEAM_WIDTH, cs.BEAM_HEIGHT, device=dev)
    return world, aug, np.asarray(cam.pos, np.float32), o, d


def _beam_profile(fn, rounds: int):
    """One run of a beam frame under torch.profiler: wall and device-busy
    ms; K6, K7 and K2's device ms in launch order; the other device
    events by the stretch they fall in (before the first walk; between a
    round's walk and its resolve; after a round's resolve and before the
    next walk; after the last resolve), each as [ms, events]."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        wall = 1e3 * (time.monotonic() - t0)
    dev = sorted((e for e in prof.events()
                  if e.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda e: e.time_range.start)
    if not dev:
        raise RuntimeError("torch.profiler recorded no device activity")
    busy, end = 0.0, -1.0
    for e in dev:
        a, b = e.time_range.start, e.time_range.end
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    kern = {k: [] for k in BEAM_KERNELS}
    other, stretch = {}, 0
    for e in dev:
        ms = (e.time_range.end - e.time_range.start) / 1e3
        name = next((k for k in BEAM_KERNELS if k in e.name), None)
        if name is not None:
            kern[name].append(round(ms, 5))
            if name != "svo_cast_kernel":
                stretch += 1
            continue
        key = ("setup" if stretch == 0 else "end" if kern["svo_cast_kernel"]
               or stretch == 2 * rounds else
               f"walk {stretch // 2} to resolve" if stretch % 2 else
               f"resolve {stretch // 2 - 1} to walk")
        cur = other.setdefault(key, [0.0, 0])
        cur[0] = round(cur[0] + ms, 5)
        cur[1] += 1
    return dict(wall_ms=wall, busy_ms=busy / 1e3, busy_share=busy / 1e3 / wall,
                device_events=len(dev), kernels=kern, other=other)


def _beam_rounds(world, aug, op, d):
    """Each round of the 1080p frame through ``beam_walk``: beams alive
    at its start, beams with a candidate, candidate slots used."""
    import torch

    from voxtracer_torch.kernels import beam

    kw = _smoke().BEAM_KW
    dt = beam._group(d, kw["tile"]).contiguous()
    o = torch.as_tensor(op, device=d.device)
    ob = o.expand(dt.shape[0], 3)
    d_lo, d_hi = torch.amin(dt, 1), torch.amax(dt, 1)
    pre = beam._beam_bounds(world.height, ob, ob, d_lo, d_hi)
    state = beam._initial_state(world.root, world.height, pre["incoherent"])
    rows = []
    for _ in range(kw["rounds"]):
        alive = int(state["alive"].sum())
        c, state = beam.beam_walk(aug, world.root, world.height, ob, ob, d_lo,
                                  d_hi, K=kw["K"], max_steps=kw["max_steps"],
                                  state=state)
        used = c["lvl"] >= 0
        rows.append(dict(alive=alive, beams_with_candidates=int(
            used.any(1).sum()), slots_used=int(used.sum()),
            done=int(c["ok"].sum())))
    return rows


def run_beam_frame(reps: int, log2_sizes):
    """``beam_primary_frame_cast`` at chip_smoke's beam frame for whichever
    voxtracer_torch is first on the path: ms a frame (host clock around a
    synchronized call), K2's per-ray cast of the same rays, the host reads
    a frame (calls that synchronize, under torch's sync debug mode), one
    profiled frame, each round's live beams and used slots, the fallback."""
    import warnings

    import torch

    import voxtracer_torch
    from voxtracer_torch.kernels import beam, traverse

    smi = card()
    cs = _smoke()
    dev = torch.device("cuda")
    for log2_size in log2_sizes:
        world, aug, op, o, d = _beam_world(log2_size, dev)
        w = (world.table, world.root, world.height)

        def frame():
            return beam.beam_primary_frame_cast(*w[:1], aug, *w[1:], op, d,
                                                **cs.BEAM_KW)

        def ms_of(fn):
            fn()
            out = []
            for _ in range(reps):
                torch.cuda.synchronize()
                t0 = time.monotonic()
                fn()
                torch.cuda.synchronize()
                out.append(round(1e3 * (time.monotonic() - t0), 4))
            return out

        frame_ms = ms_of(frame)
        k2_ms = ms_of(lambda: traverse.svo_raycast(*w, o, d))
        stats = dict(beam.last_frame_stats)
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            torch.cuda.set_sync_debug_mode("warn")
            try:
                frame()
            finally:
                torch.cuda.set_sync_debug_mode(0)
        reads = sum("synchroniz" in str(x.message) for x in caught)
        print(json.dumps(dict(
            case=f"beam frame {cs.BEAM_WIDTH}x{cs.BEAM_HEIGHT} at "
                 f"{1 << log2_size}^3",
            package=str(Path(voxtracer_torch.__file__).parent), card=smi,
            kw=cs.BEAM_KW, frame_ms=frame_ms, k2_frame_ms=k2_ms,
            host_reads=reads, fallback=stats,
            rounds=_beam_rounds(world, aug, op, d),
            profile=_beam_profile(frame, cs.BEAM_KW["rounds"]))))
        sys.stdout.flush()
        del world, aug
        torch.cuda.empty_cache()


def _beam_library(csrc: Path):
    """K6 and K7 alone, built from ``csrc`` into their own library:
    (lib, ptxas's report, whether K7's entry takes the running best)."""
    from voxtracer_torch.kernels import build

    merge = "int merge" in (csrc / "beam_resolve.cu").read_text()
    out = build.BUILD_DIR / f"ab_beam_{build._source_hash(csrc)}.so"
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    report = build.compile_library(
        csrc, out, sources=("beam_walk.cu", "beam_resolve.cu"))
    lib = ctypes.CDLL(str(out))
    lib.voxt_beam_walk.argtypes = list(build.SIGNATURES["voxt_beam_walk"])
    lib.voxt_beam_resolve.argtypes = list(
        build.SIGNATURES["voxt_beam_resolve"] if merge else OLD_BEAM_RESOLVE)
    for fn in (lib.voxt_beam_walk, lib.voxt_beam_resolve):
        fn.restype = ctypes.c_int
    return lib, report, merge


def run_beam(old_csrc: Path, reps: int, log2_sizes):
    """K6 and K7 of this tree against another tree's, in turns (old, new,
    new, old), on every round of the 1080p beam frame: each round's walk
    from the state the rounds before left, every candidate and the
    resumed state equal by bits; each round's resolve on its candidates,
    the five outputs equal by bits; and the round's resolve and merge as
    the frame runs them: the old kernel and ``_merge``, the new kernel
    into the running best (rounds after the first)."""
    import torch

    from voxtracer_torch.kernels import beam, build

    cs = _smoke()
    smi = card()
    print(smi)
    build.library()
    built = [_beam_library(t) for t in (old_csrc, Path(build.CSRC))]
    for tag, (_, report, _) in zip(("old", "new"), built):
        for src, regs, props in _ptxas_lines(report):
            print(f"ptxas {tag} {src}: {regs}; {props}")
    dev = torch.device("cuda")
    K, steps = cs.BEAM_KW["K"], cs.BEAM_KW["max_steps"]
    for log2_size in log2_sizes:
        world, aug, op, _, d = _beam_world(log2_size, dev)
        H = world.height
        dt = beam._group(d, cs.BEAM_KW["tile"]).contiguous()
        o = torch.as_tensor(op, device=dev)
        ob = o.expand(dt.shape[0], 3)
        pre = beam._beam_bounds(H, ob, ob, torch.amin(dt, 1),
                                torch.amax(dt, 1))
        state = beam._initial_state(world.root, H, pre["incoherent"])
        Bb, P = dt.shape[:2]
        stream = torch.cuda.current_stream().cuda_stream
        best = None
        for r in range(cs.BEAM_KW["rounds"]):
            start = {k: v.clone() for k, v in state.items()}
            sts = [{k: v.clone() for k, v in start.items()} for _ in built]
            cands = [dict(lvl=torch.empty((Bb, K), dtype=torch.int32,
                                          device=dev),
                          off=torch.empty((Bb, K, 3), dtype=torch.int32,
                                          device=dev),
                          rgb=torch.empty((Bb, K, 3), device=dev),
                          ok=torch.empty((Bb,), dtype=torch.bool, device=dev),
                          t_safe=torch.empty((Bb,), device=dev))
                     for _ in built]

            def walk(k):
                st, c = sts[k], cands[k]
                err = built[k][0].voxt_beam_walk(
                    aug.data_ptr(), H, pre["olo"].data_ptr(),
                    pre["ohi"].data_ptr(), pre["ilo"].data_ptr(),
                    pre["ihi"].data_ptr(), pre["mirror"].data_ptr(),
                    pre["incoherent"].data_ptr(), K, steps, 1,
                    st["h"].data_ptr(), st["ids_stk"].data_ptr(),
                    st["mask_stk"].data_ptr(), st["entry_stk"].data_ptr(),
                    st["words"].data_ptr(), st["cap"].data_ptr(),
                    st["alive"].data_ptr(), c["lvl"].data_ptr(),
                    c["off"].data_ptr(), c["rgb"].data_ptr(),
                    c["ok"].data_ptr(), c["t_safe"].data_ptr(), Bb, stream)
                if err != 0:
                    raise RuntimeError(f"beam_walk side {k}: CUDA error {err}")

            def restore(k):
                for key in start:
                    sts[k][key].copy_(start[key])

            for k in range(len(built)):
                walk(k)
            torch.cuda.synchronize()
            for key in cands[0]:
                if not torch.equal(cands[0][key], cands[1][key]):
                    raise AssertionError(f"beam_walk round {r}: {key} differs")
            for key in start:
                if not torch.equal(sts[0][key], sts[1][key]):
                    raise AssertionError(f"beam_walk round {r}: state {key} "
                                         "differs")
            state = sts[1]
            c = cands[1]
            outs = [{key: torch.empty_like(v) for key, v in dict(
                hit=torch.empty((Bb, P), dtype=torch.bool, device=dev),
                t=torch.empty((Bb, P), device=dev),
                normal=torch.empty((Bb, P, 3), device=dev),
                rgb=torch.empty((Bb, P, 3), device=dev),
                voxel=torch.empty((Bb, P, 3), dtype=torch.int32,
                                  device=dev)).items()}
                for _ in range(3)]

            def resolve(k, out, merge=0):
                lib, takes_merge = built[k][0], built[k][2]
                extra = (merge,) if takes_merge else ()
                err = lib.voxt_beam_resolve(
                    c["lvl"].data_ptr(), c["off"].data_ptr(),
                    c["rgb"].data_ptr(), o.data_ptr(), 0, dt.data_ptr(), H, 1,
                    *extra, out["hit"].data_ptr(), out["t"].data_ptr(),
                    out["normal"].data_ptr(), out["rgb"].data_ptr(),
                    out["voxel"].data_ptr(), Bb, P, K, stream)
                if err != 0:
                    raise RuntimeError(f"beam_resolve side {k}: CUDA error "
                                       f"{err}")

            resolve(0, outs[0])
            resolve(1, outs[1])
            torch.cuda.synchronize()
            for key in outs[0]:
                if not torch.equal(outs[0][key], outs[1][key]):
                    raise AssertionError(f"beam_resolve round {r}: {key} "
                                         "differs")
            ms = dict(walk_old=[], walk_new=[], resolve_old=[],
                      resolve_new=[], merged_old=[], merged_new=[])
            for k in (0, 1, 1, 0):
                tag = ("old", "new")[k]
                ms[f"walk_{tag}"].append(cs._ms_fresh(
                    lambda k=k: restore(k), lambda k=k: walk(k), reps))
                ms[f"resolve_{tag}"].append(cs._ms(
                    lambda k=k: resolve(k, outs[k]), reps))
            merged = None
            if best is not None:
                # the round as the frame runs it, into the running best
                merged = {key: v.clone() for key, v in best.items()}
                if built[1][2]:
                    resolve(1, merged, merge=1)
                want = beam._merge(best, outs[1])
                torch.cuda.synchronize()
                if built[1][2]:
                    for key in want:
                        if not torch.equal(merged[key], want[key]):
                            raise AssertionError(f"beam_resolve round {r}: "
                                                 f"merged {key} differs")

                def fold_old():
                    resolve(0, outs[2])
                    beam._merge(best, outs[2])

                def fresh_best():
                    for key in best:
                        outs[2][key].copy_(best[key])

                for k in (0, 1, 1, 0):
                    if k and built[1][2]:
                        t = cs._ms_fresh(fresh_best, lambda: resolve(
                            1, outs[2], merge=1), reps)
                    else:
                        t = cs._ms_fresh(lambda: None, fold_old, reps)
                    ms[f"merged_{('old', 'new')[k]}"].append(t)
                best = want
            else:
                best = {key: v.clone() for key, v in outs[1].items()}
            used = c["lvl"] >= 0
            print(json.dumps(dict(
                case=f"beam round {r} at {1 << log2_size}^3", card=smi,
                beams=Bb, alive=int(start["alive"].sum()),
                beams_with_candidates=int(used.any(1).sum()),
                slots_used=int(used.sum()), ms=ms, equal_by_bits=True)))
            sys.stdout.flush()
        del world, aug
        torch.cuda.empty_cache()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    sub = ap.add_subparsers(dest="mode", required=True)
    k = sub.add_parser("kernels")
    k.add_argument("--old-csrc", type=Path, required=True)
    k.add_argument("--sweep", action="store_true")
    k.add_argument("--reps", type=int, default=10)
    h = sub.add_parser("hf_cast")
    h.add_argument("--old-csrc", type=Path, required=True)
    h.add_argument("--variant", type=Path, action="append", default=[])
    h.add_argument("--reps", type=int, default=10)
    h.add_argument("--log2-size", type=int, default=10)
    k5 = sub.add_parser("sky_tmin")
    k5.add_argument("--old-csrc", type=Path, required=True)
    k5.add_argument("--variant", type=Path, action="append", default=[])
    k5.add_argument("--edits", action="store_true")
    k5.add_argument("--reps", type=int, default=20)
    b = sub.add_parser("bit_dda")
    b.add_argument("--old-csrc", type=Path, required=True)
    b.add_argument("--variant", type=Path, action="append", default=[])
    b.add_argument("--fetch", action="append", default=[],
                   type=lambda x: tuple(int(v) for v in x.split(",")),
                   help="static percent,chunk,refill of another side")
    b.add_argument("--reps", type=int, default=10)
    pt = sub.add_parser("path_trace")
    pt.add_argument("--old-csrc", type=Path, required=True)
    pt.add_argument("--variant", type=Path, action="append", default=[])
    pt.add_argument("--fetch", action="append", default=[],
                    type=lambda x: tuple(int(v) for v in x.split(",")),
                    help="static percent,chunk,refill of another side")
    pt.add_argument("--reps", type=int, default=3)
    pt.add_argument("--configs", nargs="+",
                    choices=("default", "svo", "bit", "edit", "8192"),
                    default=["default", "svo", "edit", "8192"])
    e = sub.add_parser("e2e")
    e.add_argument("--reps", type=int, default=3)
    e.add_argument("--engine", choices=("package", "hf", "svo", "both"),
                   default="package")
    e.add_argument("--log2-size", type=int, default=10)
    f = sub.add_parser("fetch")
    f.add_argument("--reps", type=int, default=10)
    bm = sub.add_parser("beam")
    bm.add_argument("--old-csrc", type=Path, required=True)
    bm.add_argument("--reps", type=int, default=10)
    bm.add_argument("--log2-size", type=int, nargs="+", default=[10, 13])
    eb = sub.add_parser("env_build")
    eb.add_argument("--reps", type=int, default=10)
    bf = sub.add_parser("beam_frame")
    bf.add_argument("--reps", type=int, default=5)
    bf.add_argument("--log2-size", type=int, nargs="+", default=[10, 13])
    a = ap.parse_args(argv)
    if a.mode == "kernels":
        run_kernels(a.old_csrc, a.sweep, a.reps)
    elif a.mode == "hf_cast":
        run_hf(a.old_csrc, a.variant, a.reps, a.log2_size)
    elif a.mode == "sky_tmin":
        run_sky(a.old_csrc, a.variant, a.edits, a.reps)
    elif a.mode == "bit_dda":
        run_bit(a.old_csrc, a.variant, a.reps, a.fetch)
    elif a.mode == "path_trace":
        run_path_trace(a.old_csrc, a.variant, a.reps, a.configs, a.fetch)
    elif a.mode == "fetch":
        run_fetch(a.reps)
    elif a.mode == "beam":
        run_beam(a.old_csrc, a.reps, a.log2_size)
    elif a.mode == "beam_frame":
        run_beam_frame(a.reps, a.log2_size)
    elif a.mode == "env_build":
        run_env_build(a.reps)
    else:
        run_e2e(a.reps, a.engine, a.log2_size)
    return 0


if __name__ == "__main__":
    sys.exit(main())
