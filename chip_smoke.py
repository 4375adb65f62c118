#!/usr/bin/env python3
"""Smoke run of the PyTorch port (voxtracer_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs nvcc

Phases, each printing its lines; any failure exits non-zero:

1. card: fails unless torch sees a CUDA device; prints nvidia-smi's name
   and power limit.
2. build: compiles kernels K1 (fog march), K2 (SVO cast), K3 (resolve
   fold), K4 (heightfield walk), K5 (the horizon envelope's per-ray
   t_min), K6 (beam walk), K7 (beam resolve), K8 (bit-grid DDA) and K9
   (the bounce loop: its stage kernels and burn pass) from
   voxtracer_torch/kernels/csrc with
   nvcc, one process per source, loads them, and prints ptxas's
   registers, stack frame and spills for each; compiles the native world
   builder (native/svo_native.cpp) with g++.
3. kernels against their plain PyTorch versions, on the card, at the main
   path's shapes, every output bit for bit: K1 at 409,440 rays (one
   853x480 sample) and at ragged sizes, each unmasked and with half the
   lanes active, and at batch-8 width (3,275,520 lanes) with 1%, 10% and
   50% of the lanes active; K2 on a 1024^3 world with camera rays, random
   rays with random caps, and a random active mask, the three casts of a
   main-path bounce from the camera hits (the fog-capped indirect cast of
   cosine-hemisphere directions, the NEE cast capped at NEE_NEAR and the
   full NEE cast toward sun-cone directions, each with its mask, and the
   heightfield engine's one NEE cast), and random rays at batch-8 width
   with 1%, 10% and 50% active; K3 on
   the 1024^3 world's raster bins at 853x480, in its explicit-list form
   (R = 64 pixel-center rays and R = 512, 8 jittered samples, K = 16; a
   widen-shaped call, 512 tiles x K = 1024; the near pre-pass's shared
   list; random records with invalid rows around a camera inside a box)
   and in its segment form (the sorted pair array read where it lies,
   the carry updated in place, the per-tile max: the main fold and the
   pose's real widen rounds at R = 64 and R = 512, tile lists as
   raster_cast finds them, a list of one tile, a ragged K); K4 on K2's
   409,440-lane and batch-8 sets (strict caps), on walks resumed in
   certified air, on rays that start inside solid and, through
   hf_raycast_edited, on an edited world, each also held to K2 on the
   same rays up to the edge-graze budget; every K4 line gives the shape
   of the walk the plain version counted (steps a walking lane: mean,
   p99, max; lane-steps by walk level and by move). Times both with CUDA
   events; each kernel's bound is computed from this run's inputs.
4. goldens: the 64^3 scene of tests/test_golden.py on the card:
   primary_64w and shadow_64w through the SVO cast, primary_64w through
   the rasterizer, and the fixed-seed path sample.
5. shaded frame at 1024^3, 853x480: the rasterizer against the per-ray
   SVO cast, with its fallback on K2 and on K4; fails above
   EDGE_GRAZE_BUDGET differing pixels. Prints the
   rasterizer's ms/frame, its bins, and the frame on ready bins split
   into K3's device time and launches and the rest, and its host reads a
   frame.
6. paths at 1024^3: Renderer at 853x480 (the default: rasterized
   primaries, bounce and shadow casts on the heightfield) and
   headless_run for 2 frames x 16 samples in batches of 8: K9 and K3
   must have launched and K1 not (the masked loop is off the path), and
   no sample may be retried. Then the SVO engine (use_soup=False,
   use_hf=False, 1 frame x 8 samples: K9 alone), and
   ms/sample at batch 1 and 8 with rasterized and SVO primaries, from the
   same process. Then the two engines in turns (heightfield, SVO, SVO,
   heightfield; same seeds): the radiance equal up to the graze budget,
   ms per batch-8 call, and one torch.profiler window over a call of
   each: every kernel's device ms and launches, the device busy share.
7. edits at 1024^3 (soup on): blocks placed and deleted through
   Renderer.apply_edits on a Renderer that rasterizes its primaries:
   heightfield-exact edits (the pack and soup patched, the pure walk
   kept), then a floating block and a hole (a bounds box, the hybrid
   cast). After each phase the preview frame and a batch-8 path sample
   equal those of a Renderer built fresh on the edited world: bit for bit
   while the heightfield stays exact, up to the graze budget once the
   engines differ; the previews up to the rays either rasterized preview
   leaves unresolved. Prints the edit-to-preview latency (set, apply,
   preview) p50/p90/max.
8. main path at full width: worldgen.generate(log2_size=13,
   backend="native"), the reference's 8192^3 world, a Renderer in hf-only
   mode (no soup: primaries are the K4 cast resumed by the pose's horizon
   envelope through K5), headless_run for 2
   frames x 16 samples at 853x480, 24 bounces, 64 fog steps, batches of 8,
   EXR writes and a checkpoint at the end of each frame, the last one
   read back (the resumed accumulator equal bit for bit). K9, K4 and K5
   must have launched, K1 not. K4 on that world at the main path's shapes (camera
   rays, a bounce-1 indirect cast, the NEE cast, batch-8 width with 1%,
   10% and 50% active) against its plain version and K2, each with its
   bound and walk shape. K5 on each envelope tier's table at 409,440
   camera rays and at batch-8 width against its plain version, each set
   in image order (pixel tiles, as the main path calls it) and in lane
   order, the two equal by bits (rung counts up to the graze share,
   t_min within 1e-6 relative; the bound charges the table rows the rays
   reach; the row search's L2 sectors a lane and L1 lines a warp
   replayed from the set's indices in both orders, for the binary and
   the two-level search), the walks it resumes equal to the full walks
   in every lane; each tier's build
   ms. Prints worldgen, octree and pack seconds, device memory in use,
   paths/px/s, the checkpoint's seconds and size, a batch-8 call with and
   without the envelope (equal radiance by bits; ms in turns), the
   preview frame's ms with and without the envelope, and a profile window
   over a batch-8 call.

9. the per-pose culled view at 1024^3 (run between 6 and 7;
   world/active.py, which the Renderer does not rasterize through): its
   share of the soup, the horizon build, the cull and the jittered bins
   on the view against bins on the full soup (ms), raster_cast_exact on
   the view against the full soup (0 pixels in any output), the batch-8
   call's jittered primaries on the view equal by bits to the full
   soup's on every lane where that is the SVO cast's hit (the lanes off
   the SVO cast on either soup within GRAZE_SHARE), and a rasterized
   preview after each move of a walk on either soup. Then ROADMAP A10:
   the default Renderer against one in hf-only mode at 1024^3, previews
   at a held pose and after moves, and ms per batch-8 call, in turns.
10. a scripted interactive session (app/interactive.py) at 1024^3,
   853x480 (after 7): moves, a look, del, place, r and save; ms of each
   fast preview after a move and after an edit, of each sample; every
   pick held by bits to the plain SVO cast of the same ray on the card.
11. BASELINE config 1: the 256^3 grid from_heightmap at 640x360,
   dense_raycast against K2 on the grid's from_dense octree (hit, normal
   and voxel up to GRAZE_SHARE, t to the raster parity tolerance), with
   the ms of each.
12. multi-device rendering (voxtracer_torch/dist; before 7, on the
   unedited world, and in 8 at 8192^3) on the mesh [cuda:0] * 4: at 1024^3 the sample-sharded step
   with the default Renderer's soup and heightfield pack equal by bits
   to the mesh-order sum of four render_sample calls (K9 and K3
   launched, K1 not), the tile-sharded step (K3 on the bands' tile runs) equal
   by bits to the full frame, Renderer(devices=[cuda:0] * 4).sample()
   against four single samples (the first step by bits, the second
   within rtol 1e-5 / atol 1e-4), a two-process job (torch.multiprocessing,
   gloo named, both ranks on cuda:0, 2 shards each: ranks equal by bits,
   within rtol 1e-6 / atol 1e-6 of the one-process step; its tile step
   gathered through the host equal to the full frame) and a one-rank
   NCCL group's all_reduce (equal by bits); at 8192^3 the hf-only steps
   with the envelope as call args equal those without, the serial sum
   and the full frame by bits, and 7 bands (483 rows cropped to 480);
   K9, K4 and K5 launched, K1 not. ms per step against the serial calls (in
   turns), ms of the sum and of the all_reduce, and a world replica's
   bytes, each with the card's name and power limit.

13. the JAX package's selectable engines. At 1024^3 (before 7, on the
   unedited world): the beam engine at the JAX bench's 1920x1080 (tile 8,
   K 64, 512 steps, 6 rounds; 853 is not a multiple of 8): K6 (walk) and
   K7 (resolve) equal by bits to their plain versions in all 6 rounds
   (candidates, resumed state, all resolve outputs, the resolve into the
   running best), each round's live beams, used slots, K6 and K7 ms and
   bounds (K7's on the used slots), ptxas's registers; the frame against
   K2's per-ray cast (GRAZE_SHARE) with its rounds and fallback tiles,
   the shadow frame against the per-ray one (SHADOW_SHARE), the CLI's
   render --engine beam once, and beam_primary_frame with K6's and K7's
   counts read around it (6 and 6); the bit-grid DDA on the pyramid built from
   the heightmap: K8 (bit_walk.cuh's walker on the lane fetch) equal by
   bits to its plain version and against K2 (hit, t at rtol 1e-5 / atol
   2e-4, voxel, normal: GRAZE_SHARE) on camera, random, masked (10%
   active) and batch-8 NEE sets, each timed with K2 and its bound, with
   ptxas's registers; one batch-8 render_samples(bitworld=) call (K9
   launched, K1 and K8 not) against the SVO engine's radiance under the
   golden contract, and K9 on the bit grid (14). After 11: the card's
   heightmap against the CPU's at 2^10 and 2^13, by bits. In 8, at
   8192^3: sun maps through the Renderer's VOXT_SUNMAPS=1 (K9 with the
   maps, 14; batch-8 radiance and trace_paths' state equal by bits with
   and without, the share of NEE lanes proved lit, K4's NEE launch with
   and without), hf_frame_cast with cone=, sky=, sky_env= and their
   compositions equal by bits to the unprefixed frame (ms each), and the
   beam engine on the 8192^3 octree (K6 and K7 on the first round, the
   frame against K2).

14. K9 (phase_path_kernel) at six configurations, each on the inputs
   of one batch-8 call (853x480, 3,275,520 paths, 24 bounces, 64 fog
   steps): the 1024^3 default Renderer and SVO engine (after 6), the
   1024^3 bit grid (render_samples(bitworld=), in 13), the 1024^3 edit
   session once bounds-tracked edits put it on the edited heightfield
   (in 7), and the 8192^3 main path without and with the sun maps (in
   8). At each, K9 against trace_paths_plain (the masked loop on K1, K2,
   K4 and K8): the returned state by bits in every lane, the radiance by
   bits (lanes that differ, up to GRAZE_SHARE, printed with their values;
   none at all on the bit grid and with the sun maps),
   the K9 call made under torch.cuda.set_sync_debug_mode("error") so
   that a host read inside it fails the run; ms of the trace_paths call
   and of the whole batch-8 call, K9 and the masked loop in turns, and
   the host time to enqueue the trace_paths call and its C call alone; a
   profile of the call
   with each (wall, device busy ms and share, device events, K9's own ms
   and each of its stage kernels' ms and launches, 6 x bounces + 2
   launches, 8 x bounces + 2 on the edited engine); K9's own counts read
   after the timed window: queue lengths by bounce, the share of bounce
   and sun marches the scatter-free test settled, segments marched
   against those the marches define, and from one more call with stats
   on each lane-fetch stage's SIMT efficiency; K9's bound from its counts of
   walk steps, segments, tests and bounces, beside it the path state
   its stages move and the full-march bound (every segment the marches
   define, no tests). After 8, ptxas's registers and spills for each of
   K9's stage kernels and a line per configuration.

15. api (after 4): the public helpers the main path does not call, on
   the card against their own CPU results with the tolerances of
   tests/test_torch_api.py: uniform_hemisphere (state by bits, at most
   3% of direction components beyond 2 ulp, all within 64),
   cos_hemisphere_pdf (2 ulp), sun_pdf (by bits off the cone edge),
   srgb_decode (relative 1e-6), vdot (2 ulp), length (2 ulp of the
   value), vec3 (by bits, on the card); then utils.profiling.timed
   around one K9 call (its synchronize on CUDA), its line beside the
   card's name and power limit.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import re
import subprocess
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
WIDTH, HEIGHT = 853, 480
LOG2_SIZE = 10
FULL_LOG2_SIZE = 13  # the reference's 8192^3 world (worldgen.rs:17)
# BASELINE config 1: primary rays into a dense 256^3 grid at 640x360
DENSE_LOG2_SIZE, DENSE_WIDTH, DENSE_HEIGHT = 8, 640, 360
RAYS = WIDTH * HEIGHT  # 409,440 paths per sample
WIDE = 8 * RAYS  # the lanes of a batch-8 call
MASK_SHARES = (0.01, 0.10, 0.50)  # live lanes in the masked wide sets
# golden contract (tests/test_torch_integrator.py): fraction of values
# beyond 1e-3, and the relative difference of the image means
GOLDEN_FRAC, GOLDEN_MEAN_REL = 5e-3, 1e-3
# the card's published peaks (H100 SXM data sheet): device memory rate
# and float32 rate outside the tensor cores
HBM_BYTES_PER_S, FP32_OPS_PER_S = 3.35e12, 67e12
# float operations per unit of each kernel's work (counted in the .cu
# sources): K1 per ray setup and per marched segment, K2 per loop step of
# a lane, K3 per (ray, candidate) slab test
K1_SETUP_OPS, K1_STEP_OPS, K2_STEP_OPS, K3_PAIR_OPS = 30, 30, 30, 27
# K4 per ray setup and per walk step of a lane (hf_cast.cu's own count)
K4_SETUP_OPS, K4_STEP_OPS = 60, 40
# K5 per ray (azimuth bin, slope, t_min) and per step of its row search
K5_RAY_OPS, K5_STEP_OPS = 50, 2
# K10 per cell of its fold (counted in sky_env.cu, libdevice's sequences
# included): the level lookup, the window index and the ladder's gate (two
# box distances, a hypotf each) ~60; a selected cell's height, bound,
# five atan2f (~45 each), five fmodf, two log2f, a hypotf and four
# divisions ~400 more
K10_CELL_OPS, K10_SEL_OPS = 60, 400
# K9 per bounce of a path besides its walk steps and fog segments (counted
# in path_trace.cu): 11 random3 draws ~345 integer operations, two
# hemisphere samples ~110, the sun sample ~50, two march setups 60, two
# walk setups 120, the planet normal, NEE, emissive, bounce and roulette
# terms ~75
K9_BOUNCE_OPS = 760
# the scatter-free test of one march (fog_walk.cuh, scatter_bound), in
# float64: 3 square roots, 3 exponentials, 2 expm1 and 3 divisions (~20-25
# operations each) and ~40 products, sums and comparisons
K9_CERT_OPS = 300
# the card's float64 rate outside the tensor cores (H100 SXM data sheet)
FP64_OPS_PER_S = 34e12
# bytes of path state K9's stages move for one path (counted in
# path_trace.cu: each field read or written once, a queue entry 4 B): the
# bounce kernel ends a bounce and starts the next (reads flags, light,
# colour, normal, sun direction, direction, state, rgba; writes light,
# colour, direction, state; reads state, position, direction, density,
# writes state and (code, t) or y0; a queue entry in, one or two out);
# the cast (its entry, position, direction, (code, t) in; the world hit,
# t, normal and albedo out) and, for the same entries, the shade kernel
# (the world hit, position, direction, state, (code, t), density in;
# position, normal, sun direction, state, rgba, flags and y0 out, two
# appends); a march (its entry, position, direction, density, y0 in,
# (code, t) or a flag out); the shadow cast (its entry, position, sun
# direction, a flag read and written); the edited engine's re-casts as
# the cast and the shadow cast
K9_STATE_BYTES = dict(bounce=212, cast=68, shade=168, march=44, shadow=36)
# the cone prefix (plain PyTorch, kernels/conemarch.py) per bundle a march
# step: the cell and its exits ~20, the fit and level tests ~15, the
# gather's index ~8, the clearance and selects ~10
CONE_STEP_OPS = 50
# lanes in which the heightfield walk may differ from the SVO cast: rays
# through a voxel edge or corner, where the two walks break the tie on
# the last ulp apart. The JAX package's engine-parity tests allow 2 lanes
# in 4096 (tests/test_heightfield.py:76); the share grows with the world
# (a float32 has 10 fraction bits left at 8192)
GRAZE_SHARE = 2 / 4096
# shaded 1024^3 frame: pixels where the rasterizer's image may differ from
# the per-ray SVO cast's. Edge grazes flip winners only at degenerate
# cameras (integer positions, axis-aligned views); the smoke pose is not
# one, both engines round every operation alike, and its first run found
# 0 of 409,440 (PERF.md)
EDGE_GRAZE_BUDGET = 0
CARD = "card not read"  # nvidia-smi's name and power limit (phase_card)


def _ms(fn, reps: int) -> float:
    """Mean milliseconds per call on the card (CUDA events), after one
    warm-up call."""
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


def _bound(nbytes: float, ops: float):
    """The least time the card could take: (ms, "bytes" | "operations")."""
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / FP32_OPS_PER_S
    return (1e3 * max(t_bytes, t_ops),
            "bytes" if t_bytes >= t_ops else "operations")


def _smoke_camera(log2_size):
    from voxtracer_torch.core import camera as vcam

    s = (1 << log2_size) / 8192.0
    return vcam.Camera(pos=tuple(np.asarray(vcam.DEFAULT_POSE.pos) * s),
                       yaw=vcam.DEFAULT_POSE.yaw, pitch=vcam.DEFAULT_POSE.pitch)


def phase_card():
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: no card")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    line = smi.stdout.strip().splitlines()[0]
    print(line)
    return line


def phase_build():
    from voxtracer_torch.kernels import build

    t0 = time.monotonic()
    path = build.build()
    build.library()
    print(f"build: {time.monotonic() - t0:.1f} s -> {path.relative_to(REPO)}")
    src = None
    for line in build.ptxas_report().splitlines():
        if line.startswith("== "):
            src = line[3:]
        elif "stack frame" in line or "registers" in line:
            print(f"ptxas {src}: {line.strip()}")
    from voxtracer_torch.world import native

    t0 = time.monotonic()
    path = native.build()
    native.load_library()
    print(f"build: {time.monotonic() - t0:.1f} s -> {path.relative_to(REPO)} "
          "(g++, the native world builder)")


def _fog_inputs(rng, B, dev):
    import torch

    from voxtracer_torch.core.spectra import fog_density

    start = rng.random((B, 3), np.float32) * np.float32(1 << LOG2_SIZE)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wl = torch.as_tensor(rng.random(B, np.float32), device=dev)
    u = rng.integers(0, 1 << 16, B).astype(np.float32) / np.float32(65536)
    y0 = -np.log(np.float32(1) - u)
    t = lambda a: torch.as_tensor(a, device=dev).contiguous()  # noqa: E731
    return t(start), t(d), fog_density(wl).contiguous(), t(y0)


def _fog_bound(args, n_steps, active):
    """K1's bound for these rays: (ms, by, segments, settled lanes), from
    one launch's own counts (fog.last_work: the marches the scatter-free
    test settled, the segments marched). Every lane's outputs (8 B) and
    mask byte; the inputs (40 B) and, of the active lanes, the
    scatter-free test (float64) and the segments marched."""
    from voxtracer_torch.kernels import fog

    B = args[0].shape[0]
    n_act = B if active is None else int(active.sum())
    fog.fog_march(*args, n_steps=n_steps, active=active)
    n_set, segs = (int(x) for x in fog.last_work.tolist())
    ms, by = _bound(B * (8 + (0 if active is None else 1)) + n_act * 40,
                    n_act * K1_SETUP_OPS + segs * K1_STEP_OPS
                    + n_act * K9_CERT_OPS * FP32_OPS_PER_S / FP64_OPS_PER_S)
    return ms, by, segs, n_set


def _masks(rng, B, dev):
    """Scattered random lane masks at the shares of live lanes a batch-8
    call's later bounces see."""
    import torch

    return [(f"{int(100 * f)}%", torch.as_tensor(rng.random(B) < f,
                                                 device=dev))
            for f in MASK_SHARES]


def _check_fog(name, args, steps, active, rec):
    import torch

    from voxtracer_torch.kernels import fog

    code_k, t_k = fog.fog_march(*args, n_steps=steps, active=active)
    code_p, t_p = fog.fog_march_plain(*args, n_steps=steps, active=active)
    torch.cuda.synchronize()
    if not torch.equal(code_k, code_p):
        n = int((code_k != code_p).sum())
        raise AssertionError(f"fog_march {name} n={steps}: {n} codes differ")
    # both sides build without FMA contraction and in one expression
    # order, so t is held bit for bit, as K2's outputs are
    err = float((t_k - t_p).abs().max())
    if not torch.equal(t_k, t_p):
        raise AssertionError(f"fog_march {name} n={steps}: t differs, max "
                             f"diff {err}")
    rec["max_abs_err"] = max(rec["max_abs_err"], err)


def phase_fog(rng, dev):
    """K1 against fog_march_plain, unmasked and masked, at 409,440 rays,
    at ragged sizes and at batch-8 width; returns the JSON record
    fields."""
    from voxtracer_torch.kernels import fog

    rec = dict(max_abs_err=0.0)
    for B, steps in [(b, s) for b in (RAYS, 1, 100, 1000) for s in (64, 16)]:
        args = _fog_inputs(rng, B, dev)
        mask = _masks(rng, B, dev)[2][1]  # half of the lanes
        for active in (None, mask):
            name = f"B={B}" + ("" if active is None else " masked 50%")
            _check_fog(name, args, steps, active, rec)
            line = f"fog_march {name} n_steps={steps}: codes and t equal"
            if B == RAYS:
                ms = _ms(lambda: fog.fog_march(*args, n_steps=steps,
                                               active=active), 20)
                line += f", kernel {ms:.4f} ms"
                if steps == 64:  # the production march
                    bound_ms, bound_by, segs, n_set = _fog_bound(
                        args, steps, active)
                    line += (f", {n_set} marches settled by the "
                             f"scatter-free test, {segs} segments marched, "
                             f"bound {bound_ms:.4f} ms ({bound_by})")
                    if active is None:
                        plain_ms = _ms(lambda: fog.fog_march_plain(
                            *args, n_steps=steps), 3)
                        rec.update(ms=ms, plain_ms=plain_ms,
                                   bound_ms=bound_ms, bound_by=bound_by,
                                   library_ms=None)
                        line += f", plain {plain_ms:.4f} ms"
            print(line)
    args = _fog_inputs(rng, WIDE, dev)
    for share, active in _masks(rng, WIDE, dev):
        _check_fog(f"B={WIDE} {share}", args, 64, active, rec)
        ms = _ms(lambda: fog.fog_march(*args, n_steps=64, active=active), 10)
        bound_ms, bound_by, segs, n_set = _fog_bound(args, 64, active)
        print(f"fog_march B={WIDE} masked {share} n_steps=64: codes and t "
              f"equal, kernel {ms:.4f} ms, {n_set} marches settled, {segs} "
              f"segments marched, bound {bound_ms:.4f} ms ({bound_by})")
    return rec


def _svo_sets(rng, world, dev, log2_size=LOG2_SIZE):
    """The K2 ray sets as (name, start, d, distance, active), flat:
    camera rays, random rays with random caps, and those with a random
    mask, at 409,440 lanes; the casts of a main-path bounce from the
    camera hits (the SVO engine's two-stage NEE, and the heightfield
    engine's one NEE cast); and random rays at batch-8 width with sparse
    masks. ``world``: the SVO world of edge 2^log2_size."""
    import torch

    from voxtracer_torch.core import sampling
    from voxtracer_torch.core.spectra import fog_density
    from voxtracer_torch.core.vecmath import dot
    from voxtracer_torch.kernels import atmosphere
    from voxtracer_torch.kernels.integrator import NEE_NEAR
    from voxtracer_torch.kernels.traverse import FAR, svo_raycast

    n = float(1 << log2_size)
    cam = _smoke_camera(log2_size)
    o, d = _camera_rays(cam, dev)
    t = lambda a: torch.as_tensor(a, device=dev).contiguous()  # noqa: E731
    far = torch.full((RAYS,), FAR, dtype=torch.float32, device=dev)

    def random_rays(B):
        start = rng.random((B, 3), np.float32) * np.float32(n)
        rd = rng.normal(size=(B, 3)).astype(np.float32)
        rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
        cap = np.where(rng.random(B) < 0.25, np.float32(FAR),
                       rng.random(B, np.float32) * np.float32(2 * n))
        return t(start), t(rd), t(cap.astype(np.float32))

    rand = random_rays(RAYS)
    sets = [("camera", o, d, far, None), ("random", *rand, None),
            ("active", *rand, t(rng.random(RAYS) < 0.5))]

    # one main-path bounce from the camera hits (integrator.trace_paths):
    # the fog-capped indirect cast, then the two-stage NEE toward the sun
    prim = svo_raycast(world.table, world.root, world.height, o, d)
    hit = prim["hit"]
    pos = torch.where(hit[:, None], o + d * prim["t"][:, None], o)
    state = t(rng.integers(0, 2**32, (RAYS, 3), dtype=np.uint32)
              .astype(np.int64))
    density = fog_density(t(rng.random(RAYS, np.float32)))
    state, ind = sampling.cos_hemisphere(state, prim["normal"])
    state, planet = atmosphere.raycast_planet(state, pos, ind, density,
                                              active=hit)
    cap = torch.where(planet["hit"], planet["t"], FAR)
    sets.append(("bounce-1 indirect", pos, ind, cap, hit))
    state, sun_dir = sampling.sample_sun(state, _sun(dev))
    facing = hit & (dot(sun_dir, prim["normal"]) > 0.0)
    state, sun_planet = atmosphere.raycast_planet(state, pos, sun_dir,
                                                  density, active=facing)
    nee_act = facing & ~sun_planet["hit"]
    near = svo_raycast(world.table, world.root, world.height, pos, sun_dir,
                       NEE_NEAR, active=nee_act)["hit"]
    sets.append(("NEE near", pos, sun_dir,
                 torch.full((RAYS,), NEE_NEAR, device=dev), nee_act))
    sets.append(("NEE far", pos, sun_dir, far, nee_act & ~near))
    sets.append(("NEE", pos, sun_dir, far, nee_act))

    wide = random_rays(WIDE)
    sets += [(f"batch-8 width, {share} active", *wide, active)
             for share, active in _masks(rng, WIDE, dev)]
    return sets


def _camera_rays(cam, dev):
    from voxtracer_torch.core import camera as vcam

    o, d = vcam.generate_rays(cam, WIDTH, HEIGHT, device=dev)
    return (o.expand(d.shape).reshape(-1, 3).contiguous(),
            d.reshape(-1, 3).contiguous())


def _sun(dev):
    import torch

    sun = np.asarray([0.8, 10.2743, 3.7])
    return torch.as_tensor((sun / np.linalg.norm(sun)).astype(np.float32),
                           device=dev)


def _svo_bound(world, steps, B, active):
    """K2's bound: every lane's outputs (33 B) and mask byte, the inputs
    (28 B) of active lanes, the table once, and the loop steps of the
    active lanes (counted by the plain version)."""
    n_act = B if active is None else int(active.sum())
    nbytes = (B * (33 + (0 if active is None else 1)) + n_act * 28
              + world.table.numel() * 4)
    return _bound(nbytes, steps * K2_STEP_OPS)


def phase_svo(sets, world):
    """K2 against svo_raycast_plain, all five outputs bit for bit."""
    import torch

    from voxtracer_torch.kernels import traverse

    rec = dict(max_abs_err=0.0)
    w = (world.table, world.root, world.height)
    for name, start, d, distance, active in sets:
        def kernel():
            return traverse.svo_raycast(*w, start, d, distance, active=active)

        def plain():
            return traverse.svo_raycast_plain(*w, start, d, distance,
                                              active=active)

        B = d.shape[0]
        k = kernel()
        before = traverse.plain_lane_steps
        p = plain()
        steps = traverse.plain_lane_steps - before
        torch.cuda.synchronize()
        for key in ("hit", "t", "node", "normal", "voxel"):
            if not torch.equal(k[key], p[key]):
                bad = (k[key] != p[key]).reshape(B, -1).any(1).sum()
                raise AssertionError(f"svo_cast {name}: {key} differs in "
                                     f"{int(bad)} lanes")
        for key in ("t", "normal"):
            err = float((k[key] - p[key]).abs().max())
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        ms = _ms(kernel, 10)
        bound_ms, bound_by = _svo_bound(world, steps, B, active)
        n_act = B if active is None else int(active.sum())
        hits = float(p["hit"].float().sum()) / max(n_act, 1)
        line = (f"svo_cast {name} ({B} lanes, {n_act} active, {hits:.3f} of "
                f"them hit): all five outputs equal, kernel {ms:.4f} ms, "
                f"{steps} lane-steps, bound {bound_ms:.4f} ms ({bound_by})")
        if name == "random":  # incoherent capped rays, like bounce casts
            plain_ms = _ms(plain, 1)
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None)
            line += f", plain {plain_ms:.4f} ms"
        print(line)
    return rec


# the K4 sets of the main path at 8192^3 (of _svo_sets' names)
FULL_HF_SETS = ("camera", "bounce-1 indirect", "NEE") + tuple(
    f"batch-8 width, {int(100 * f)}% active" for f in MASK_SHARES)


def _walk_shape(w):
    """The plain version's record of a walk (hf_raycast_plain's ``walk``)
    in a line: steps a walking lane took (mean, p99, max), lane-steps by
    walk level and by move."""
    per = w["per_lane"]
    per = per[per > 0].double()
    if not per.numel():
        return "no lane walked"
    p99 = float(per.kthvalue(max(1, int(np.ceil(0.99 * per.numel()))))[0])
    total = sum(w["by_level"].values())
    levels = ", ".join(f"L{lv} {c} ({100 * c / total:.1f}%)"
                       for lv, c in sorted(w["by_level"].items()))
    moves = ", ".join(f"{m} {100 * c / total:.1f}%"
                      for m, c in w["moves"].items())
    return (f"steps a walking lane: mean {float(per.mean()):.2f}, p99 "
            f"{p99:.0f}, max {int(per.max())}; lane-steps by level: "
            f"{levels}; by move: {moves}")


def _hf_bound(pack, steps, B, active, t_min):
    """K4's bound: every lane's outputs (29 B) and mask byte, the inputs
    (28 B, 32 with a resume) of active lanes, the pack's floats the walk
    reads (one a walk step of an active lane, each float at most once),
    and the steps' operations (steps counted by the plain version)."""
    n_act = B if active is None else int(active.sum())
    nbytes = (B * (29 + (0 if active is None else 1))
              + n_act * (28 if t_min is None else 32)
              + min(steps, pack[0].numel()) * 4)
    return _bound(nbytes, n_act * K4_SETUP_OPS + steps * K4_STEP_OPS)


def _bits(x):
    """A float tensor's bits as int32 (other tensors as they are)."""
    import torch

    return x.view(torch.int32) if x.is_floating_point() else x


def _cast_mismatch(a, b):
    """Lanes where two casts differ, by kind: hit, then t, normal and
    voxel among the lanes both hit."""
    both = a["hit"] & b["hit"]
    kinds = dict(hit=a["hit"] != b["hit"], t=both & (a["t"] != b["t"]),
                 normal=both & (a["normal"] != b["normal"]).any(-1),
                 voxel=both & (a["voxel"] != b["voxel"]).any(-1))
    total = kinds["hit"] | kinds["t"] | kinds["normal"] | kinds["voxel"]
    return int(total.sum()), {k: int(v.sum()) for k, v in kinds.items()}


def _check_hf(name, pack, world, start, d, distance, active=None, t_min=None,
              init_desc=0, timed=False, want=None):
    """K4 against hf_raycast_plain, every output bit for bit, and against
    K2 on the same rays (K2's hits held to the cap first: its cap is
    advisory) up to GRAZE_SHARE of the active lanes. ``want``: a result
    the kernel's must equal too (the full walk of a resumed one). Returns
    (the kernel's result, kernel ms, lane-steps, bound ms, bound by, plain
    ms or None)."""
    import torch

    from voxtracer_torch.kernels import heightfield, traverse

    hmax_w = heightfield.terrain_max(pack[0], pack[1])

    def kernel():
        return heightfield.hf_raycast(*pack, start, d, distance,
                                      active=active, t_min=t_min,
                                      init_desc=init_desc, hmax_w=hmax_w)

    def plain(walk=None):
        return heightfield.hf_raycast_plain(*pack, start, d, distance, True,
                                            active, t_min, init_desc,
                                            walk=walk)

    def k2():
        return traverse.svo_raycast(world.table, world.root, world.height,
                                    start, d, distance, active=active)

    B = d.shape[0]
    k = kernel()
    before = heightfield.plain_lane_steps
    walk = {}
    p = plain(walk)
    steps = heightfield.plain_lane_steps - before
    shape = _walk_shape(walk)
    torch.cuda.synchronize()
    for other, what in ((p, "its plain version"), (want, "the full walk")):
        if other is None:
            continue
        for key in ("hit", "t", "normal", "voxel"):
            # bits: a -0.0 for a 0.0 differs
            if not torch.equal(_bits(k[key]), _bits(other[key])):
                bad = (k[key] != other[key]).reshape(B, -1).any(1).sum()
                raise AssertionError(f"hf_cast {name}: {key} differs from "
                                     f"{what} in {int(bad)} lanes")
    err = max(float((k[key] - p[key]).abs().max()) for key in ("t", "normal"))
    svo = k2()
    svo["hit"] = svo["hit"] & (svo["t"] <= distance)
    n_act = B if active is None else int(active.sum())
    budget = int(np.ceil(n_act * GRAZE_SHARE))
    n_bad, kinds = _cast_mismatch(svo, k)
    # an event pair a call behind a spin on the card (_ms_fresh): a
    # back-to-back loop of these short casts times the host's dispatch of
    # the wrapper's allocations, ~0.2 ms a call whatever the rays
    ms = _ms_fresh(lambda: None, kernel, 10)
    loop_ms = _ms(kernel, 10)
    bound_ms, bound_by = _hf_bound(pack, steps, B, active, t_min)
    hits = float(p["hit"].float().sum()) / max(n_act, 1)
    line = (f"hf_cast {name} ({B} lanes, {n_act} active, {hits:.3f} of them "
            f"hit): all four outputs equal the plain version's, kernel "
            f"{ms:.4f} ms ({loop_ms:.4f} in a back-to-back loop), {steps} "
            f"lane-steps, bound {bound_ms:.4f} ms "
            f"({bound_by}); {shape}; {n_bad} lanes differ from K2 {kinds} "
            f"(budget {budget})")
    plain_ms = None
    if timed:
        plain_ms = _ms(plain, 1)
        line += f", plain {plain_ms:.4f} ms"
    line += (f", K2 on the same rays {_ms_fresh(lambda: None, k2, 10):.4f} ms "
             "(the same clock)")
    print(line)
    if n_bad > budget:
        raise AssertionError(f"hf_cast {name}: {n_bad} lanes differ from K2, "
                             f"budget {budget}")
    return k, (ms, steps, bound_ms, bound_by, plain_ms, err)


def _edited_world(space, dev):
    """A second copy of the smoke's world with a 2x2 dig at the highest
    column near the camera and a white block above it: the edited node
    table on the card, the bounds box and the edit site."""
    from voxtracer_torch.world import svo, worldgen

    edited = worldgen.generate(log2_size=LOG2_SIZE, verbose=False,
                               backend="native", device=dev)
    if not np.array_equal(edited.heights, space.heights):
        raise AssertionError("worldgen is not reproducible")
    n = 1 << LOG2_SIZE
    cam = np.asarray(_smoke_camera(LOG2_SIZE).pos)
    x0, z0 = int(cam[0]) + 20, int(cam[2]) + 20
    win = space.heights[x0:x0 + 64, z0:z0 + 64]
    cx, cz = np.unravel_index(np.argmax(win), win.shape)
    cx, cz = int(cx) + x0, int(cz) + z0
    top = int(space.heights[cx, cz])
    if not (2 <= top < n - 4):
        raise AssertionError(f"edit site ({cx}, {cz}) has height {top}")
    edits = [(cx + dx, top - 1, cz + dz) for dx in range(2) for dz in range(2)]
    for e in edits:
        edited.set(e, None)
    edited.set((cx, top + 2, cz), (1.0, 1.0, 1.0))
    edits.append((cx, top + 2, cz))
    dsvo = edited.serialize()
    bounds = np.stack([np.min(edits, axis=0).astype(np.float32) - 1.0,
                       np.max(edits, axis=0).astype(np.float32) + 2.0])
    return (svo.upload(dsvo.table, dsvo.root, dsvo.height, dev), bounds,
            np.array([cx + 0.5, top + 0.5, cz + 0.5], np.float32))


def phase_hf(rng, sets, world, space, dev):
    """K4 against hf_raycast_plain, all four outputs bit for bit, and
    against K2 up to the graze budget: K2's sets, resumed walks, starts
    inside solid, and an edited world through hf_raycast_edited. Returns
    the JSON record fields (the random capped rays, as K2's) and the
    pack."""
    import torch

    from voxtracer_torch.kernels import heightfield, traverse

    t0 = time.monotonic()
    pack = heightfield.build_height_mips(space.heights, device=dev)
    torch.cuda.synchronize()
    print(f"heightfield pack 1024^3: {tuple(pack[0].shape)} float32 "
          f"({pack[0].numel() * 4 / 2**20:.1f} MiB), offsets {pack[1]}, built "
          f"in {time.monotonic() - t0:.2f} s")
    rec = dict(max_abs_err=0.0)
    for name, start, d, distance, active in sets:
        res, (ms, steps, bound_ms, bound_by, plain_ms, err) = _check_hf(
            name, pack, world, start, d, distance, active,
            timed=name in ("camera", "random"))
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        if name == "camera":
            full = res
        if name == "random":  # incoherent capped rays, like bounce casts
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None)

    # walks resumed in certified air: camera rays at a random fraction of
    # their own hit t (anywhere on the first diagonal for a miss)
    _, o, d, far, _ = sets[0]
    n = float(1 << LOG2_SIZE)
    frac = torch.as_tensor(rng.random(RAYS, np.float32), device=dev)
    t_min = torch.where(full["hit"], full["t"], n) * frac
    for init_desc in (0, 3):
        _check_hf(f"camera, resumed at t_min, init_desc {init_desc}", pack,
                  world, o, d, far, t_min=t_min, init_desc=init_desc,
                  want=full)

    # rays that start inside solid columns, half of them on voxel corners
    sx, sz = np.nonzero(space.heights >= 2)
    pick = rng.integers(0, len(sx), RAYS)
    x, z = sx[pick], sz[pick]
    y = space.heights[x, z] * rng.uniform(0.1, 0.9, RAYS)
    start = np.stack([x + rng.uniform(0.2, 0.8, RAYS), y,
                      z + rng.uniform(0.2, 0.8, RAYS)], -1).astype(np.float32)
    start[::2] = np.floor(start[::2])
    _check_hf("starts inside solid", pack, world,
              torch.as_tensor(start, device=dev), sets[1][2], sets[1][3])

    # an edited world: the pre-edit walk plus K2 for the lanes that can see
    # the edit, against K2 alone on the edited table
    edited, bounds, site = _edited_world(space, dev)
    cam = torch.as_tensor(np.asarray(_smoke_camera(LOG2_SIZE).pos,
                                     np.float32), device=dev)
    aim = torch.as_tensor(site, device=dev) + torch.as_tensor(
        rng.normal(size=(RAYS, 3)).astype(np.float32) * 6.0, device=dev)
    o = cam.expand(RAYS, 3).contiguous()
    o[RAYS // 2:] = torch.as_tensor(
        rng.random((RAYS - RAYS // 2, 3), np.float32) * n, device=dev)
    d = aim - o
    d = d / torch.sqrt((d * d).sum(-1, keepdim=True))
    hyb = heightfield.hf_raycast_edited(*pack, edited.table, edited.root,
                                        bounds, o, d)
    ref = traverse.svo_raycast(edited.table, edited.root, edited.height, o, d)
    pre = traverse.svo_raycast(world.table, world.root, world.height, o, d)
    torch.cuda.synchronize()
    n_bad, kinds = _cast_mismatch(ref, hyb)
    changed, _ = _cast_mismatch(ref, pre)
    n_aff = int(hyb["from_svo"].sum())
    budget = int(np.ceil(RAYS * GRAZE_SHARE))
    print(f"hf_raycast_edited, rays aimed at a dig and a placed block "
          f"({RAYS} lanes): {n_aff} re-cast on K2, the edit changed {changed} "
          f"lanes; {n_bad} lanes differ from K2 on the edited world {kinds} "
          f"(budget {budget})")
    if not 0 < n_aff < RAYS or not changed or n_bad > budget:
        raise AssertionError("hf_raycast_edited disagrees with the SVO cast")
    if not bool((hyb["node"][hyb["from_svo"] & hyb["hit"]] >= 0).all()):
        raise AssertionError("a re-cast hit carries no leaf")
    return rec, pack


def _random_fold_case(rng, dev, N, R, K):
    """Random records (a fifth invalid) around a camera inside the first
    box of every tile, and a carry that holds some hits."""
    import torch

    lo = rng.integers(0, 1000, (N, K, 3))
    size = rng.integers(1, 17, (N, K, 3))
    lo[:, 0], size[:, 0] = 500, 16
    rows = np.zeros((N, K, 8), np.int32)
    rows[..., 1] = rng.integers(0, 1 << 20, (N, K))
    rows[..., 2] = lo[..., 0] | (lo[..., 1] << 16)
    rows[..., 3] = lo[..., 2] | (size[..., 0] << 16)
    rows[..., 4] = size[..., 1] | (size[..., 2] << 16)
    rows[..., 5:8] = rng.random((N, K, 3), np.float32).view(np.int32)
    d = rng.normal(size=(N, R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t0 = np.where(rng.random((N, R)) < 0.3, rng.random((N, R)) * 900,
                  np.inf).astype(np.float32)
    g = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=dev)  # noqa: E731,E501
    carry = (g(t0), g(np.where(np.isfinite(t0), 8, -1).astype(np.int32)),
             g(np.zeros((N, R, 3), np.float32)))
    return carry, g(rows), g(rng.random((N, K)) >= 0.2), g(d), \
        np.float32([507.5, 505.25, 508.75])


def _ms_fresh(restore, fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the card when every call
    needs ``restore()`` first (a kernel that updates its input in place):
    one pair of CUDA events around each call, the restores outside. The
    card spins ~0.3 ms before each pair, so the host has queued the call
    by the time the first event fires and no host time is counted."""
    import torch

    restore()
    fn()
    pairs = []
    for _ in range(reps):
        restore()
        torch.cuda._sleep(500_000)
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        pairs.append((a, b))
    torch.cuda.synchronize()
    return sum(a.elapsed_time(b) for a, b in pairs) / reps


def _fold_bound(N, R, K, lists):
    """K3's bound: 52 bytes a ray (direction, carry in, carry out), 33 a
    listed record (its 8 ints and mask byte), and the slab tests."""
    return _bound(N * R * (12 + 20 + 20) + lists * K * 33,
                  N * R * K * K3_PAIR_OPS)


def _fold_seg_bound(S, R, K, better):
    """The segment form's own bound. It reads each listed ray's direction,
    t and real-pixel flag (17 bytes) and never its pl or rgb, writes the
    carry (20 bytes) only of the ``better`` rays that found a nearer hit,
    reads 32 bytes a record (it takes no mask), and per listed tile its
    index, start and next record's key and writes two floats (20 bytes).
    The slab tests are those of the explicit form."""
    return _bound(S * R * 17 + better * 20 + S * (K * 32 + 20),
                  S * R * K * K3_PAIR_OPS)


def _fold_inputs(rng, soup_t, dev):
    """The 1024^3 world's raster bins at the smoke pose (pixel-center and
    jittered) and its rays in tile layout: a dict."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import raster

    cam = _smoke_camera(LOG2_SIZE)
    op = np.asarray(cam.pos, np.float32)
    basis = cam.basis().to(dev)
    bins = raster.raster_bins(*soup_t, op, basis, LOG2_SIZE, WIDTH, HEIGHT)
    binsj = raster.raster_bins(*soup_t, op, basis, LOG2_SIZE, WIDTH, HEIGHT,
                               jittered=True)
    d64, ok64, _ = raster.tile_rays(basis, WIDTH, HEIGHT)
    py, px = vcam.pixel_grid(WIDTH, HEIGHT, dev)
    ld = vcam.pixel_ndc(px, py, WIDTH, HEIGHT)
    jit = torch.as_tensor(rng.random((8, HEIGHT, WIDTH, 2), np.float32),
                          device=dev)
    dirs8 = torch.stack([vcam.ray_directions(basis, ld, jitter=j,
                                             height=HEIGHT) for j in jit])
    d512, ok512, _ = raster.tile_rays(basis, WIDTH, HEIGHT, dirs8)
    return dict(op=op, bins=bins, binsj=binsj, d64=d64, ok64=ok64, d512=d512,
                ok512=ok512)


def _fresh_carry(n, r, dev):
    import torch

    return (torch.full((n, r), torch.inf, device=dev),
            torch.full((n, r), -1, dtype=torch.int32, device=dev),
            torch.zeros((n, r, 3), device=dev))


def _fold_cases(rng, inp, dev):
    """K3's explicit-list cases as (name, carry, rows, valid, d, cam): the
    main fold at R = 64 and R = 512, a widen-shaped call, the near
    pre-pass's shared list, and random records around a camera inside a
    box."""
    import torch

    from voxtracer_torch.kernels import resolve

    bins, binsj, op = inp["bins"], inp["binsj"], inp["op"]
    d64, d512 = inp["d64"], inp["d512"]
    DB = bins["dmin_bits"]
    NT = d64.shape[0]
    tix = torch.arange(NT, dtype=torch.int32, device=dev)

    def valid(rows, tiles):
        return (rows[..., 0] >> DB) == tiles[:, None]

    main64 = resolve.seg_rows(bins["spairs"], bins["seg_start"],
                              bins["cand_k"])
    main512 = resolve.seg_rows(binsj["spairs"], binsj["seg_start"],
                               binsj["cand_k"])
    wt = torch.as_tensor(np.sort(rng.choice(NT, min(512, NT), replace=False)),
                         dtype=torch.int32, device=dev)
    wrows = resolve.seg_rows(binsj["spairs"], binsj["seg_start"][wt] + 16,
                             1024)
    shared = binsj["spairs"][:64]
    rnd = _random_fold_case(rng, dev, 512, 64, 256)
    return [
        ("main R=64 K=16", _fresh_carry(NT, 64, dev), main64,
         valid(main64, tix), d64, op),
        ("main R=512 K=16", _fresh_carry(NT, 512, dev), main512,
         valid(main512, tix), d512, op),
        ("widen 512 tiles R=512 K=1024", _fresh_carry(wt.numel(), 512, dev),
         wrows, valid(wrows, wt), d512[wt.long()], op),
        ("near shared list R=512 K=64", _fresh_carry(NT, 512, dev), shared,
         torch.ones(64, dtype=torch.bool, device=dev), d512, op),
        ("random records, camera inside a box, R=64 K=256", *rnd),
    ]


def _check_fold_seg(name, carry, bins, tiles, start, k, d, ok, op, rec):
    """The segment form against its plain twin from the same carry: t, pl,
    rgb (every tile, so the unlisted ones too), the per-tile max and the
    next records' bounds bit for bit; times the kernel from that carry.
    Returns the folded carry, the per-tile max and bounds, and (kernel
    ms, plain ms, bound ms, bound by), the bound being this form's own
    for this run's data (``_fold_seg_bound``); the explicit form's
    yardstick for the same fold is printed beside it."""
    import torch

    from voxtracer_torch.kernels import resolve

    args = (bins["spairs"], tiles, start, k, bins["dmin_bits"],
            bins["quantum"], d, ok, op, LOG2_SIZE, 1.0e12)
    got = tuple(c.clone() for c in carry)
    want = tuple(c.clone() for c in carry)
    got_out = resolve.resolve_fold_seg(*got, *args)
    want_max, want_next = resolve.resolve_fold_seg_plain(*want, *args)
    torch.cuda.synchronize()
    for key, a, b in zip(("t", "pl", "rgb", "tile max", "next bound"),
                         got + got_out, want + (want_max, want_next)):
        if not torch.equal(a, b):
            raise AssertionError(f"resolve_fold_seg {name}: {key} differs in "
                                 f"{int((a != b).sum())} values")
    fin = torch.isfinite(want[0])
    if fin.any():
        rec["max_abs_err"] = max(rec["max_abs_err"], float(
            (got[0][fin] - want[0][fin]).abs().max()))

    def restore():
        for g, c in zip(got, carry):
            g.copy_(c)

    ms = _ms_fresh(restore, lambda: resolve.resolve_fold_seg(*got, *args), 20)
    plain_ms = _ms_fresh(restore, lambda: resolve.resolve_fold_seg_plain(
        *got, *args), 2)
    N = carry[0].shape[0] if tiles is None else int(tiles.numel())
    R = carry[0].shape[1]
    better = int((want[0] < carry[0]).sum())
    bound_ms, bound_by = _fold_seg_bound(N, R, k, better)
    print(f"resolve_fold_seg {name} ({N} tiles, R={R}, K={k}, {better} rays "
          f"improved): t, pl, rgb, tile max, next bound equal, kernel "
          f"{ms:.4f} ms, plain {plain_ms:.4f} ms, bound {bound_ms:.4f} ms "
          f"({bound_by}; the explicit form's, 52 bytes a ray: "
          f"{_fold_bound(N, R, k, N)[0]:.4f} ms)")
    return want, (want_max, want_next), (ms, plain_ms, bound_ms, bound_by)


def _seg_rounds(name, bins, d, ok, op, dev, rec):
    """The main fold and the widen rounds of one cast in the segment form,
    as raster_cast runs them, every step held against the plain twin;
    then a tile list of length 1 and a K that is no multiple of the ray
    tile or the stage. Returns the main fold's times."""
    import torch

    from voxtracer_torch.kernels import raster

    NT, R = ok.shape
    K = bins["cand_k"]
    seg_start = bins["seg_start"]
    carry, (tile_max, drop), main = _check_fold_seg(
        f"{name} main", _fresh_carry(NT, R, dev), bins, None, seg_start, K, d,
        ok, op, rec)
    if not torch.equal(drop, bins["drop_dmin"]):
        raise AssertionError("the main fold's next bounds are not the bins'")
    consumed = K
    wl, lists = None, []
    for k_extra in raster.WIDEN_K:
        sub = torch.nonzero(drop < tile_max).squeeze(1)
        wl = sub if wl is None else wl[sub]
        lists.append(int(wl.numel()))
        if not lists[-1]:
            break
        tiles = wl.to(torch.int32)
        start = seg_start[wl] + consumed
        if len(lists) == 1:  # one tile, and a ragged K, from the same carry
            _check_fold_seg(f"{name} one tile", carry, bins, tiles[:1],
                            start[:1], 37, d, ok, op, rec)
            _check_fold_seg(f"{name} ragged K", carry, bins, tiles, start,
                            203, d, ok, op, rec)
        carry, (tile_max, drop), _ = _check_fold_seg(
            f"{name} widen round {len(lists)}", carry, bins, tiles, start,
            k_extra, d, ok, op, rec)
        consumed += k_extra
    print(f"resolve_fold_seg {name}: tiles entering the widen rounds {lists}")
    return main, lists


def phase_resolve(rng, soup_t, dev):
    """K3 against its plain versions on the 1024^3 world's bins, every
    output bit for bit: the explicit-list form on five cases, and the
    segment form (the sorted pair array read in place, the carry updated
    in place, the per-tile max) on the main fold and the real widen
    rounds at R = 64 and R = 512. Returns the JSON record fields (the
    main path's batch-8 fold: the segment form, R = 512 rays per tile, K
    = 16)."""
    import torch

    from voxtracer_torch.kernels import resolve

    inp = _fold_inputs(rng, soup_t, dev)
    bins, binsj = inp["bins"], inp["binsj"]
    rec = dict(max_abs_err=0.0)
    for name, carry, rows, vld, d, cam_pos in _fold_cases(rng, inp, dev):
        args = (*carry, rows, vld, d, cam_pos, LOG2_SIZE, 1.0e12)
        k = resolve.resolve_fold(*args)
        p = resolve.resolve_fold_plain(*args)
        torch.cuda.synchronize()
        for key, a, b in zip(("t", "pl", "rgb"), k, p):
            if not torch.equal(a, b):
                raise AssertionError(f"resolve_fold {name}: {key} differs in "
                                     f"{int((a != b).sum())} values")
        fin = torch.isfinite(p[0])
        err = float((k[0][fin] - p[0][fin]).abs().max()) if fin.any() else 0.0
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        # event pairs behind a spin: the small cases end before the host
        # has queued the next call, and a plain loop would time the host
        ms = _ms_fresh(lambda: None, lambda: resolve.resolve_fold(*args), 20)
        plain_ms = _ms(lambda: resolve.resolve_fold_plain(*args), 2)
        N, R = carry[0].shape
        K = rows.shape[-2]
        bound_ms, bound_by = _fold_bound(N, R, K, 1 if rows.dim() == 2 else N)
        hits = float(torch.isfinite(p[0]).float().mean())
        print(f"resolve_fold {name} ({N} tiles, {hits:.3f} hit): t, pl, rgb "
              f"equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
              f"{bound_ms:.4f} ms ({bound_by})")
    _, lists64 = _seg_rounds("R=64", bins, inp["d64"], inp["ok64"],
                             inp["op"], dev, rec)
    main, _ = _seg_rounds("R=512", binsj, inp["d512"], inp["ok512"],
                          inp["op"], dev, rec)
    if len(lists64) != 3 or not all(lists64):
        raise AssertionError(f"the smoke pose entered widen rounds {lists64}, "
                             "expected three non-empty ones")
    rec.update(ms=main[0], plain_ms=main[1], bound_ms=main[2],
               bound_by=main[3], library_ms=None)
    print(f"raster bins at {WIDTH}x{HEIGHT}: {int(bins['n_pair'])} pairs "
          f"({int(binsj['n_pair'])} jittered), tiers {bins['n_tier']}")
    return rec


def _golden_close(name, img, atol=2e-5):
    """tests/test_golden.py:46-60's contract: fewer than 1e-4 of the
    values beyond atol."""
    want = np.load(REPO / "tests" / "golden" / f"{name}.npy")
    frac = float((np.abs(img - want) > atol).mean())
    ok = img.shape == want.shape and np.isfinite(img).all() and frac < 1e-4
    return ok, frac


def phase_golden(dev):
    """tests/test_golden.py's scene on the card: primary_64w and
    shadow_64w through the SVO cast, primary_64w through the rasterizer,
    and the fixed-seed path sample."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.core.spectra import build_wl_to_rgb_lut
    from voxtracer_torch.kernels import heightfield, raster, shade
    from voxtracer_torch.kernels.integrator import render_sample
    from voxtracer_torch.world import boxes, svo, worldgen

    dev_svo = worldgen.generate(log2_size=6, verbose=False,
                                device=dev).serialize()
    w = svo.upload(dev_svo.table, dev_svo.root, dev_svo.height, dev)
    cam = _smoke_camera(6)
    sun = _sun(dev)
    o, d = vcam.generate_rays(cam, 96, 56, device=dev)
    soup = boxes.extract_boxes(dev_svo)
    soup_t = raster.soup_to_device(soup.lo, soup.size, soup.leaf, soup.rgb,
                                   dev)
    frames = [
        ("primary_64w", "svo", shade.svo_primary_frame(
            w.table, w.root, w.height, o, d, sun)),
        ("shadow_64w", "svo", shade.svo_shadow_frame(
            w.table, w.root, w.height, o, d, sun)),
        ("primary_64w", "raster", raster.raster_primary_frame(
            *soup_t, w.height, np.asarray(cam.pos, np.float32), cam.basis(),
            sun, 96, 56, table=w.table, root=w.root)),
    ]
    for name, engine, img in frames:
        ok, frac = _golden_close(name, img.cpu().numpy())
        print(f"golden {name} ({engine}) on the card: {frac:.6f} of values "
              f"beyond 2e-5 (limit 1e-4)")
        if not ok:
            raise AssertionError(f"golden {name} ({engine}) not reproduced")

    lut = torch.as_tensor(build_wl_to_rgb_lut(256), device=dev)
    tiles, offsets, _ = heightfield.build_height_mips(dev_svo.space.heights,
                                                      device=dev)
    want = np.load(REPO / "tests" / "golden" / "path_sample_64w.npy")
    engines = (("SVO engine", {}), ("heightfield engine", dict(
        hf_mips=tiles, hf_offsets=offsets,
        terrain_rgb=dev_svo.space.terrain_rgb)))
    for engine, kw in engines:
        img = render_sample(w.table, w.root, w.height, lut,
                            np.asarray(cam.pos, np.float32), cam.basis(), sun,
                            np.array([101, 202, 303], np.uint32), 96, 56,
                            max_bounces=4, fog_steps=16, **kw).cpu().numpy()
        frac = float((np.abs(img - want) > 1e-3).mean())
        mean_rel = abs(float(img.mean()) / float(want.mean()) - 1.0)
        print(f"golden path_sample_64w on the card, {engine}: {frac:.6f} of "
              f"values beyond 1e-3 (limit {GOLDEN_FRAC}), means "
              f"{img.mean():.6f} vs {want.mean():.6f} (rel {mean_rel:.2e}, "
              f"limit {GOLDEN_MEAN_REL})")
        if not np.isfinite(img).all() or frac > GOLDEN_FRAC \
                or mean_rel > GOLDEN_MEAN_REL:
            raise AssertionError(f"golden path sample not reproduced on the "
                                 f"card ({engine})")


def _ulp_check(name, got, want, tol_ulp, share=0.0, scale=1.0):
    """Max |card - CPU| in ulp of 1.0 (times ``scale``); fails beyond
    ``tol_ulp``, or, with ``share``, when more than that share of the
    values lie beyond 2 ulp."""
    ulp1 = float(np.spacing(np.float32(1.0))) * scale
    diff = np.abs(got.astype(np.float64) - want.astype(np.float64)) / ulp1
    beyond = float((diff > 2).mean())
    print(f"api {name} on the card against the CPU: max {diff.max():.2f} "
          f"ulp (limit {tol_ulp}), {beyond:.4f} of values beyond 2 ulp"
          + (f" (limit {share})" if share else ""))
    if not np.isfinite(got).all() or diff.max() > tol_ulp \
            or (share and beyond > share):
        raise AssertionError(f"api {name}: the card's result is not the "
                             "CPU's")


def phase_api(dev):
    """The public helpers that the main path does not call, on the card
    against their own CPU results (tolerances of tests/test_torch_api.py):
    uniform_hemisphere (state by bits; directions at most 3% of
    components beyond 2 ulp, all within 64), cos_hemisphere_pdf (2 ulp),
    sun_pdf (by bits off the cone edge), srgb_decode (relative 1e-6),
    vdot (2 ulp), length (2 ulp of the value), vec3 (by bits, on the
    card); then a timed block around one K9 call."""
    import torch

    from voxtracer_torch.core import color, rng as vrng, sampling, vecmath
    from voxtracer_torch.core.spectra import build_wl_to_rgb_lut
    from voxtracer_torch.kernels import integrator
    from voxtracer_torch.utils.profiling import timed
    from voxtracer_torch.world import svo, worldgen

    gen = np.random.default_rng(16)
    n_lanes = 1 << 16
    unit = gen.normal(size=(2, n_lanes, 3)).astype(np.float32)
    unit /= np.linalg.norm(unit, axis=-1, keepdims=True)
    n_c, d_c = (torch.from_numpy(u) for u in unit)
    n_g, d_g = n_c.to(dev), d_c.to(dev)
    st = vrng.to_state(gen.integers(0, 2**32, (n_lanes, 3), dtype=np.uint32))

    s_c, u_c = sampling.uniform_hemisphere(st, n_c)
    s_g, u_g = sampling.uniform_hemisphere(st.to(dev), n_g)
    if not torch.equal(s_g.cpu(), s_c):
        raise AssertionError("api uniform_hemisphere: RNG state differs")
    _ulp_check("uniform_hemisphere", u_g.cpu().numpy(), u_c.numpy(), 64,
               share=0.03)
    _ulp_check("cos_hemisphere_pdf",
               sampling.cos_hemisphere_pdf(n_g, d_g).cpu().numpy(),
               sampling.cos_hemisphere_pdf(n_c, d_c).numpy(), 2)

    sun_c = n_c[0]
    _, in_cone = sampling.sample_sun(st, sun_c)
    d_sun = torch.cat([in_cone, d_c])
    p_c = sampling.sun_pdf(d_sun, sun_c).numpy()
    p_g = sampling.sun_pdf(d_sun.to(dev), sun_c.to(dev)).cpu().numpy()
    cos = (d_sun.numpy().astype(np.float64) * sun_c.numpy()).sum(-1)
    far = np.abs(cos - np.float32(sampling.COS_SUN_RADIUS)) > 2 * float(
        np.spacing(np.float32(1.0)))
    n_diff = int((p_c[far] != p_g[far]).sum())
    print(f"api sun_pdf on the card against the CPU: {n_diff} of "
          f"{int(far.sum())} lanes off the cone edge differ (limit 0), "
          f"{int((p_g > 0).sum())} inside the cone")
    if n_diff or not (p_g > 0).any() or (p_g > 0).all():
        raise AssertionError("api sun_pdf: the card's result is not the CPU's")

    v = torch.from_numpy(gen.random(n_lanes, np.float32))
    dec_c = color.srgb_decode(v).numpy()
    dec_g = color.srgb_decode(v.to(dev)).cpu().numpy()
    rel = float((np.abs(dec_g - dec_c) / np.maximum(np.abs(dec_c),
                                                     1e-30)).max())
    print(f"api srgb_decode on the card against the CPU: max relative "
          f"{rel:.3e} (limit 1e-6)")
    if not rel <= 1e-6:
        raise AssertionError("api srgb_decode: the card's result is not the "
                             "CPU's")

    a_c = torch.from_numpy(gen.normal(size=(n_lanes, 3)).astype(np.float32))
    a_g = a_c.to(dev)
    _ulp_check("vdot", vecmath.vdot(a_g, d_g).cpu().numpy(),
               vecmath.vdot(a_c, d_c).numpy(), 2,
               scale=float(a_c.abs().max()))
    len_c = vecmath.length(a_c).numpy()
    len_g = vecmath.length(a_g).cpu().numpy()
    off = float((np.abs(len_g - len_c) / np.spacing(len_c)).max())
    print(f"api length on the card against the CPU: max {off:.2f} ulp of "
          f"the value (limit 2)")
    if not off <= 2:
        raise AssertionError("api length: the card's result is not the CPU's")
    v3 = vecmath.vec3(a_g[:, 0], a_g[:, 1], a_g[:, 2])
    v3n = vecmath.vec3(1.0, -2.0, 0.5, device=dev)
    same = (v3.device.type == "cuda" and v3n.device.type == "cuda"
            and torch.equal(v3.cpu(), a_c)
            and torch.equal(v3n.cpu(), vecmath.vec3(1.0, -2.0, 0.5)))
    print(f"api vec3 on the card: equal by bits to the CPU's, on the card: "
          f"{same}")
    if not same:
        raise AssertionError("api vec3: the card's result is not the CPU's")

    dev_svo = worldgen.generate(log2_size=6, verbose=False,
                                device=dev).serialize()
    w = svo.upload(dev_svo.table, dev_svo.root, dev_svo.height, dev)
    cam = _smoke_camera(6)
    lut = torch.as_tensor(build_wl_to_rgb_lut(256), device=dev)
    before = _launches()['path_trace']
    logged = []
    with timed("api timed K9 call, 96x56, 4 bounces", log=logged.append):
        img = integrator.render_sample(
            w.table, w.root, w.height, lut, np.asarray(cam.pos, np.float32),
            cam.basis(), _sun(dev), np.array([7, 8, 9], np.uint32), 96, 56,
            max_bounces=4, fog_steps=16)
    fine = (len(logged) == 1 and _launches()['path_trace'] > before
            and re.fullmatch(r"api timed K9 call, 96x56, 4 bounces: "
                             r"\d+\.\d{3}s", logged[0]) is not None
            and bool(torch.isfinite(img).all()))
    for line in logged:
        print(f"{line} ({CARD})")
    if not fine:
        raise AssertionError(f"api timed: {logged}, K9 launches "
                             f"{_launches()['path_trace'] - before}")


def phase_shaded(soup_t, world, pack, dev):
    """The shaded frame at 1024^3, 853x480: rasterizer against the
    per-ray SVO cast (K2), both on the card; the rasterizer's fallback on
    K2 and on the heightfield walk (K4, ``pack``)."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.core.vecmath import dot
    from voxtracer_torch.kernels import raster, shade
    from voxtracer_torch.tools.kernel_ab import profile_call

    cam = _smoke_camera(LOG2_SIZE)
    op = np.asarray(cam.pos, np.float32)
    basis = cam.basis().to(dev)
    sun = _sun(dev)
    o, d = vcam.generate_rays(cam, WIDTH, HEIGHT, device=dev)
    w = (world.table, world.root, world.height)
    r = raster.raster_cast(*soup_t, op, basis, LOG2_SIZE, WIDTH, HEIGHT)
    fb_rays = int(r["fb_need"].sum())
    ex = raster.apply_fallback(r, *w, op, basis, WIDTH, HEIGHT) \
        if r["n_fallback"] else r
    img_r = ex["rgb"] * (dot(sun, ex["normal"]) / 2.0 + 1.0)[..., None] \
        * ex["hit"][..., None]
    img_s = shade.svo_primary_frame(*w, o, d, sun)
    same = torch.equal(img_r, raster.raster_primary_frame(
        *soup_t, LOG2_SIZE, op, basis, sun, WIDTH, HEIGHT, table=w[0],
        root=w[1]))
    diff = int((img_r != img_s).any(-1).sum())
    from voxtracer_torch.kernels import heightfield

    # the smoke pose leaves no tile open after the widen rounds, so the
    # two fallbacks are compared with the rasterizer starved: 4
    # candidates a tile and widen rounds of 8 records
    hf = (pack[0], pack[1], soup_t[2][0, 1:4])
    keep = raster.WIDEN_K
    raster.WIDEN_K = (8, 8, 8)
    try:
        few = raster.raster_bins(*soup_t, op, basis, LOG2_SIZE, WIDTH, HEIGHT,
                                 cand_k=4)
        launched = _launches()['hf_cast']
        exact = [raster.raster_cast_exact(
            *soup_t, op, basis, LOG2_SIZE, WIDTH, HEIGHT, bins=few, **kw)
            for kw in (dict(table=w[0], root=w[1]), dict(hf=hf))]
        launched = _launches()['hf_cast'] - launched
    finally:
        raster.WIDEN_K = keep
    n_fb = exact[0]["n_fallback"]
    starved_rays = int(exact[0]["fb_need"].sum())
    diff_hf = sum(int((exact[0][k] != exact[1][k]).reshape(RAYS, -1).any(-1)
                      .sum()) for k in ("hit", "t", "normal", "rgb"))
    diff_k2 = int(((exact[0]["hit"] != ex["hit"]) | (exact[0]["t"] != ex["t"]))
                  .sum())
    print(f"shaded frame 1024^3 {WIDTH}x{HEIGHT}, rasterizer starved (K = 4, "
          f"widen 8/8/8): {n_fb} fallback tiles / {starved_rays} rays; "
          f"fallback on "
          f"K4 ({launched} launch) against fallback on K2: {diff_hf} "
          f"differing pixels (budget 0); against the unstarved frame "
          f"{diff_k2} (budget {EDGE_GRAZE_BUDGET})")
    if diff_hf or diff_k2 > EDGE_GRAZE_BUDGET or launched != 1 or n_fb < 100:
        raise AssertionError("the K4 fallback disagrees with the K2 fallback")

    def frame(bins=None):
        return raster.raster_primary_frame(
            *soup_t, LOG2_SIZE, op, basis, sun, WIDTH, HEIGHT, table=w[0],
            root=w[1], bins=bins)

    def make_bins():
        return raster.raster_bins(*soup_t, op, basis, LOG2_SIZE, WIDTH,
                                  HEIGHT)

    bins = make_bins()
    bins_ms = _ms(make_bins, 3)
    raster_ms = _ms(frame, 3)
    cast_ms = _ms(lambda: frame(bins), 10)
    svo_ms = _ms(lambda: shade.svo_primary_frame(*w, o, d, sun), 5)
    raster.host_reads = 0
    frame()
    reads = raster.host_reads
    prof = profile_call(lambda: frame(bins))
    k3 = prof["kernels"]["resolve_fold_kernel"]
    print(f"shaded frame 1024^3 {WIDTH}x{HEIGHT}: {soup_t[0].shape[0]} boxes, "
          f"{int(r['n_pair'])} pairs, near {r['n_near']}, widen demand "
          f"{r['n_widen']}, fallback {r['n_fallback']} tiles / {fb_rays} rays, "
          f"{diff} of {RAYS} pixels differ from the SVO cast (budget "
          f"{EDGE_GRAZE_BUDGET}); raster {raster_ms:.3f} ms/frame: bins "
          f"{bins_ms:.3f} ms, and on the pose's bins {cast_ms:.3f} ms = "
          f"resolve {k3['ms']:.3f} ms of K3 on the device in "
          f"{k3['launches']} launches + the rest {cast_ms - k3['ms']:.3f} ms "
          f"({prof['device_events']} device events, device busy "
          f"{prof['busy_ms']:.3f} ms); {reads} host reads a frame, 1 of them "
          f"for the bins; SVO cast {svo_ms:.3f} ms/frame")
    if not same or not torch.isfinite(img_r).all():
        raise AssertionError("raster_primary_frame disagrees with its parts")
    if diff > EDGE_GRAZE_BUDGET:
        raise AssertionError(f"{diff} pixels differ, budget {EDGE_GRAZE_BUDGET}")


def _headless(renderer, cam, frames, frame_samples, batch, name,
              log2_size=LOG2_SIZE, checkpoint_every=None):
    """One headless_run with every launch count set to 0 just before and
    read just after; checks the EXRs; with ``checkpoint_every`` reads the
    last snapshot back and holds its accumulator to the renderer's bit
    for bit. Returns the counts."""
    import torch

    from voxtracer_torch.render import checkpoint, film
    from voxtracer_torch.render.driver import headless_run

    lines = []
    with tempfile.TemporaryDirectory() as tmp:
        ckpt = Path(tmp) / "render_state.npz"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _zero_launches()
        saves = []  # seconds of each checkpoint the run writes
        save = checkpoint.save_render_state

        def timed_save(*args):
            t = time.monotonic()
            save(*args)
            saves.append(time.monotonic() - t)

        checkpoint.save_render_state = timed_save
        t0 = time.monotonic()
        try:
            headless_run(renderer, cam, out_dir=tmp,
                         frame_samples=frame_samples, max_frames=frames,
                         batch=batch, checkpoint_every=checkpoint_every,
                         checkpoint_path=ckpt, log=lines.append)
        finally:
            checkpoint.save_render_state = save
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = {k: v for k, v in _launches().items()
                  if k not in ("beam_walk", "beam_resolve", "bit_dda")}
        peak = torch.cuda.max_memory_allocated()
        exrs = sorted(Path(tmp).glob("*.exr"))
        imgs = [film.load_exr(p)[..., :3] for p in exrs]
        if checkpoint_every:
            size = ckpt.stat().st_size
            t0 = time.monotonic()
            resumed, _, _ = checkpoint.load_render_state(
                ckpt, device=renderer.device)
            torch.cuda.synchronize()
            load_s = time.monotonic() - t0
            same = torch.equal(resumed.acc.buffer, renderer.acc.buffer) \
                and resumed.acc.samples == renderer.acc.samples \
                and torch.equal(resumed.world.table, renderer.world.table) \
                and resumed.host_rng.getstate() == renderer.host_rng.getstate()
            print(f"{name}: checkpoint of {renderer.world.table.shape[0]} "
                  f"node rows every {checkpoint_every} samples: "
                  f"{size / 2**20:.1f} MiB on disk, written in "
                  f"{[round(t, 2) for t in saves]} s, the last read back in "
                  f"{load_s:.2f} s; accumulator, count, table and RNG state "
                  f"equal: {same}")
            if not same or len(saves) != frames:
                raise AssertionError("the resumed render state differs")
            del resumed
    for line in lines:
        print(f"  headless: {line.strip()}")
    retries = sum("sample failed" in line for line in lines)
    samples = frames * frame_samples
    print(f"{name}: {frames} frames x {frame_samples} samples at "
          f"{WIDTH}x{HEIGHT}, {1 << log2_size}^3, batch {batch}: "
          f"{samples / wall:.3f} paths/px/s, {1e3 * wall / samples:.2f} "
          f"ms/sample (wall, EXR writes included"
          + (f"; {samples / (wall - sum(saves)):.3f} paths/px/s without the "
             f"{sum(saves):.1f} s of checkpoint writes" if saves else "")
          + f"), peak {peak / 2**20:.1f} MiB, launches {counts}")
    if retries:
        raise AssertionError(f"{retries} samples were retried")
    if len(imgs) != frames:
        raise AssertionError(f"{len(imgs)} EXRs written, expected {frames}")
    for p, img in zip(exrs, imgs):
        if img.shape != (HEIGHT, WIDTH, 3) or not np.isfinite(img).all() \
                or not img.mean() > 0:
            raise AssertionError(f"{p.name}: shape {img.shape}, finite "
                                 f"{np.isfinite(img).all()}, mean {img.mean()}")
        print(f"  {p.name}: finite, mean radiance {img.mean():.6f}")
    return counts


def _expect_launches(name, counts, on, off=()):
    """Fail unless every kernel of ``on`` launched on this path and none
    of ``off`` did."""
    for k in on:
        if counts[k] <= 0:
            raise AssertionError(f"{k} was not launched on the {name}")
    for k in off:
        if counts[k] != 0:
            raise AssertionError(f"{k} launched {counts[k]} times on the "
                                 f"{name}")


def _ptxas_regs(source):
    """ptxas's lines for one source of the library: (entry, registers,
    stack frame and spills) each."""
    from voxtracer_torch.kernels import build

    rows, src, entry, props = [], None, None, None
    for line in build.ptxas_report().splitlines():
        if line.startswith("== "):
            src = line[3:]
        elif src != source:
            continue
        elif "Compiling entry function" in line:
            entry = line.split("'")[1]
        elif "bytes stack frame" in line:
            props = line.strip()
        elif "Used" in line and "registers" in line:
            rows.append((entry, line.split("Used")[1].split(",")[0].strip(),
                         props))
    return rows


def _ptxas_k9():
    """ptxas's report for K9's stage kernels and burn pass (path_trace.cu):
    (entry, registers, stack frame and spills) each, the entry with its
    template arguments: the engine (0 heightfield, 1 SVO, 2 edited, 3 bit
    grid) and tile log of the walks, the march's sun, the re-cast's
    shadow, and the stats build."""
    rows = []
    for entry, regs, props in _ptxas_regs("path_trace.cu"):
        m = re.search(r"(path_[a-z]+_kernel)(I(?:L[ib]\d+E)+E)?", entry)
        if m:
            targs = re.findall(r"L[ib](\d+)E", m[2] or "")
            entry = m[1] + (f"<{', '.join(targs)}>" if targs else "")
        rows.append((entry, regs, props))
    return rows


def _capture_call(batch):
    """The trace_paths call of one batch-8 call ``batch()`` (a Renderer's
    sample_batch, or render_samples): its (args, kwargs), the inputs K9
    is given."""
    from voxtracer_torch.kernels import integrator

    seen = []
    real = integrator.trace_paths

    def spy(*a, **k):
        seen.append((a, k))
        return real(*a, **k)

    integrator.trace_paths = spy
    try:
        batch()
    finally:
        integrator.trace_paths = real
    if len(seen) != 1:
        raise AssertionError(f"the batch-8 call made {len(seen)} trace_paths "
                             "calls")
    return seen[0]


def _k9_bound(args, kw, work, queues):
    """K9's least time for one call, from what the function needs: the
    bytes of its per-path inputs and outputs and of the pack or node
    table once (the bit grid's pyramid and the sun maps not counted: what
    a walk or a lane reads of them depends on the data, so leaving them
    out keeps this a lower bound); the float32 operations of this run's
    walk steps, marched fog segments and bounces, and the float64 ones of
    its scatter-free tests (K9's own counts). Beside it, not in it: the
    path state the stage design moves between its kernels
    (K9_STATE_BYTES by this run's queue lengths), which a design that
    keeps the state in registers does not move, and the bound with those
    bytes; and the full-march bound
    (no tests, every segment the marches define: those marched plus
    fog_steps for each march the test settled). Returns (ms, bound_by,
    full-march ms, state bytes, ms with them, the counts)."""
    B = args[5].numel() // 3
    fog_steps = int(args[10])
    per_path = 12 * 3 + 4 + 12 + 12 + 12 + 4  # in: pos, dir, light,
    # density, state; out: color, state, last bounce
    if kw.get("primary") is not None:
        per_path += 1 + 4 + 12 + 12
    nbytes = B * per_path
    from voxtracer_torch.kernels import integrator

    engine = integrator.k9_engine(kw.get("hf_mips"), kw.get("hf_edit_bounds"),
                                  kw.get("bitworld"))
    if engine in ("hf", "edited"):
        nbytes += kw["hf_mips"].numel() * 4
    if engine != "hf":  # the SVO walks, the leaves, the bit grid's colours
        nbytes += args[0].numel() * 4
    w = dict(zip(integrator.K9_WORK, (int(x) for x in work.tolist())))
    q = queues.sum(0).tolist()  # live, march, sun-march, shadow and the
    # two re-cast queues' entries
    walk_ops = (w["hf_steps"] * K4_STEP_OPS + w["svo_steps"] * K2_STEP_OPS
                + w["bit_steps"] * K8_STEP_OPS + w["bounces"] * K9_BOUNCE_OPS)
    tests = w["marches"] + w["sun_marches"]
    ops = (walk_ops + w["fog_segments"] * K1_STEP_OPS
           + tests * K9_CERT_OPS * FP32_OPS_PER_S / FP64_OPS_PER_S)
    state = (w["bounces"] * K9_STATE_BYTES["bounce"]
             + q[0] * (K9_STATE_BYTES["cast"] + K9_STATE_BYTES["shade"])
             + (q[1] + q[2]) * K9_STATE_BYTES["march"]
             + (q[3] + q[5]) * K9_STATE_BYTES["shadow"]
             + q[4] * K9_STATE_BYTES["cast"])
    defined = w["fog_segments"] + fog_steps * (w["marches_free"]
                                               + w["sun_marches_free"])
    full_ms = _bound(nbytes, walk_ops + defined * K1_STEP_OPS)[0]
    counts = dict(w, full_march_segments=defined)
    return _bound(nbytes, ops) + (full_ms, state,
                                  _bound(nbytes + state, ops)[0], counts)


def _k9_profile(fn):
    """profile_call of ``fn``: wall, device busy ms and share, device
    events, and K9's own device ms and launches (its stage kernels and
    burn pass) with each kernel's."""
    from voxtracer_torch.tools.kernel_ab import K9_KERNELS, profile_call

    prof = profile_call(fn)
    k = prof["kernels"]
    return dict(wall_ms=prof["wall_ms"], busy_ms=prof["busy_ms"],
                busy_share=prof["busy_share"], events=prof["device_events"],
                k9_ms=k["path_trace"]["ms"],
                k9_launches=k["path_trace"]["launches"],
                stages={name: k[name] for name in K9_KERNELS})


def _k9_stats(work, queues, fog_steps):
    """K9's own counts of one call, as lines: the queue lengths by bounce,
    the share of the bounce and sun marches the scatter-free test
    settled, segments marched against those the marches define, and, for
    a call with stats on, each lane-fetch stage's SIMT efficiency (lane
    steps over 32 warp steps)."""
    from voxtracer_torch.kernels import integrator

    w = dict(zip(integrator.K9_WORK, (int(x) for x in work.tolist())))
    q = queues.tolist()
    live = [b for b, row in enumerate(q) if row[0] > 0]
    lines = [f"queue lengths by bounce 0..{live[-1] if live else 0}: "
             + "; ".join(f"{name} {[row[k] for row in q[:len(live)]]}"
                         for k, name in enumerate(integrator.K9_QUEUES)
                         if any(row[k] for row in q))]
    share = lambda a, b: a / b if b else 0.0  # noqa: E731
    lines.append(
        f"scatter-free test settled {w['marches_free']} of {w['marches']} "
        f"bounce marches ({100 * share(w['marches_free'], w['marches']):.1f}"
        f"%) and {w['sun_marches_free']} of {w['sun_marches']} sun marches "
        f"({100 * share(w['sun_marches_free'], w['sun_marches']):.1f}%); "
        f"fog segments marched {w['fog_segments']} of the "
        f"{fog_steps * (w['marches'] + w['sun_marches'])} the marches "
        f"define ({w['fog_segments'] + fog_steps * (w['marches_free'] + w['sun_marches_free'])} "
        "without the test)")
    if w["sun_lit"]:
        nee = w["sun_lit"] + sum(row[3] for row in q)
        lines.append(f"sun maps settled {w['sun_lit']} of the {nee} NEE "
                     f"lanes the sun planet cast left open "
                     f"({100 * share(w['sun_lit'], nee):.3f}%), which took no "
                     "shadow walk")
    steps = {k: w[k] for k in ("hf_steps", "svo_steps", "bit_steps") if w[k]}
    lines.append(f"walk steps {steps}")
    eff = {s: share(w[f"{s}_lane_steps"], 32 * w[f"{s}_warp_steps"])
           for s in integrator.K9_STAGES if w[f"{s}_warp_steps"]}
    if eff:
        lines.append("SIMT efficiency (lane steps / 32 warp steps; stats "
                     "build): " + ", ".join(
                         f"{s} {100 * e:.1f}% ({w[f'{s}_lane_steps']} / "
                         f"{w[f'{s}_warp_steps']})" for s, e in eff.items()))
    return lines, w, eff


def _k9_stats_run(args, kw):
    """One K9 call with stats on (the stages' lane and warp steps; a
    slower build, so after the timed window): its work and queues."""
    import torch

    from voxtracer_torch.kernels import build, integrator

    c_args, outs = integrator.k9_args(*integrator.k9_inputs(args, kw),
                                      stats=True)
    err = build.library().voxt_path_trace(
        *c_args, torch.cuda.current_stream().cuda_stream)
    build.check(err, "K9 with stats")
    torch.cuda.synchronize()
    return outs[3]["work"], outs[3]["counters"]


def _k9_c_host_ms(args, kw):
    """Host ms to enqueue K9's C call alone (its stage launches and burn
    pass), its arguments made beforehand."""
    import torch

    from voxtracer_torch.kernels import build, integrator

    c_args, _ = integrator.k9_args(*integrator.k9_inputs(args, kw))
    lib = build.library()
    stream = torch.cuda.current_stream().cuda_stream
    torch.cuda.synchronize()
    t0 = time.monotonic()
    err = lib.voxt_path_trace(*c_args, stream)
    ms = 1e3 * (time.monotonic() - t0)
    build.check(err, "K9's C call")
    torch.cuda.synchronize()
    return ms


def phase_path_kernel(name, renderer, cam, budget=None, batch=None):
    """K9 at one configuration, on the inputs of one batch-8 call
    (``batch()``; by default the Renderer's sample_batch): against the
    masked loop (trace_paths_plain on K1/K2/K4/K8) with the returned state
    by bits in every lane and the radiance by bits (up to ``budget``
    lanes, GRAZE_SHARE of them by default, each counted), the K9 call made
    with
    torch's sync debug mode on "error" (a host read inside it raises);
    ms of the trace_paths call and of the whole sample_batch call with K9
    and with the masked loop, in turns; a profile of each call with K9's
    stage kernels' ms and launches; K9's own counts (queue lengths by
    bounce, the scatter-free test's share, segments, SIMT efficiency of
    each lane-fetch stage) read after the timed window; K9's bound from
    them, the path state the stages move and the full-march bound beside
    it; the host time to enqueue the call and its C call. Returns the
    configuration's
    record."""
    import torch

    from voxtracer_torch.kernels import integrator

    sun = np.asarray([0.8, 10.2743, 3.7])
    if batch is None:
        def batch():
            renderer.sample_batch(cam, sun, 8)
    args, kw = _capture_call(batch)
    B = args[5].numel() // 3
    before = _launches()['path_trace']
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        st_k, col_k = integrator.trace_paths(*args, **kw)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    work = integrator.last_work.clone()
    queues = integrator.last_queues.clone()
    st_p, col_p = integrator.trace_paths_plain(*args, **kw)
    torch.cuda.synchronize()
    if _launches()['path_trace'] != before + 1:
        raise AssertionError(f"{name}: trace_paths did not launch K9")
    state_diff = int((st_k != st_p).any(-1).sum())
    lanes = (col_k.view(torch.int32) != col_p.view(torch.int32)).any(-1)
    rad_diff = int(lanes.sum())
    err = float((col_k - col_p).abs().max())
    label = "GRAZE_SHARE" if budget is None else "every lane by bits"
    if budget is None:
        budget = int(np.ceil(B * GRAZE_SHARE))
    ok = state_diff == 0 and rad_diff <= budget \
        and bool(torch.isfinite(col_k).all()) and float(col_k.sum()) > 0
    print(f"K9 {name}: {B} paths against the masked loop: state differs in "
          f"{state_diff} lanes (budget 0), radiance in {rad_diff} (budget "
          f"{budget}: {label}), max abs difference {err:.3e}; no host "
          "read (sync debug mode \"error\")")
    if rad_diff:
        idx = torch.nonzero(lanes.reshape(-1)).flatten()[:4].tolist()
        print(f"  differing lanes {idx}: K9 "
              f"{col_k.reshape(-1, 3)[idx].tolist()} masked loop "
              f"{col_p.reshape(-1, 3)[idx].tolist()}")
    if not ok:
        raise AssertionError(f"K9 differs from the masked loop ({name})")
    del st_k, col_k, st_p, col_p

    def k9():
        return integrator.trace_paths(*args, **kw)

    def masked():
        return integrator.trace_paths_plain(*args, **kw)

    ms = {"K9": [], "masked loop": []}
    for who in ("masked loop", "K9", "K9", "masked loop"):
        ms[who].append(_wall_ms_sync(k9 if who == "K9" else masked)[0])
    k9_ms = _ms(k9, 3)
    plain_ms = _ms(masked, 2)
    torch.cuda.synchronize()
    t0 = time.monotonic()
    k9()
    host_ms = 1e3 * (time.monotonic() - t0)  # enqueue only: no sync inside
    torch.cuda.synchronize()
    c_host_ms = _k9_c_host_ms(args, kw)
    call = {"K9": [], "masked loop": []}
    prof = {}
    real = integrator.trace_paths
    for who in ("masked loop", "K9", "K9", "masked loop"):
        if who != "K9":
            integrator.trace_paths = integrator.trace_paths_plain
        try:
            call[who].append(_wall_ms_sync(batch)[0])
            if who not in prof:
                prof[who] = _k9_profile(batch)
        finally:
            integrator.trace_paths = real
    bound_ms, bound_by, full_ms, state, state_ms, counts = _k9_bound(
        args, kw, work, queues)
    work_s, queues_s = _k9_stats_run(args, kw)
    n = len(integrator.K9_COUNTS)
    if not (torch.equal(work_s[:n], work[:n])
            and torch.equal(queues_s[:, :6], queues[:, :6])):
        raise AssertionError(f"{name}: K9 with stats counted other work")
    stats, _, eff = _k9_stats(work_s, queues_s, int(args[10]))
    r = lambda xs: [round(x, 2) for x in xs]  # noqa: E731
    print(f"  trace_paths call ms in turns: K9 {r(ms['K9'])}, masked loop "
          f"{r(ms['masked loop'])} (host clock, synchronized); CUDA events "
          f"K9 {k9_ms:.2f}, masked loop {plain_ms:.2f}; host time to "
          f"enqueue: the trace_paths call {host_ms:.2f} ms, its C call "
          f"{c_host_ms:.2f} ms; K9's bound {bound_ms:.3f} ms ({bound_by}; "
          f"work {counts}) = {100 * bound_ms / k9_ms:.2f}% of its time; "
          f"the full-march bound {full_ms:.3f} ms = "
          f"{100 * full_ms / k9_ms:.2f}% ({CARD})")
    print(f"  path state the stages move between their kernels, not in the "
          f"bound: {state / 1e9:.3f} GB; the bound with it {state_ms:.3f} ms "
          f"= {100 * state_ms / k9_ms:.2f}%")
    for line in stats:
        print(f"  {line}")
    print(f"  batch-8 call ms in turns: with K9 "
          f"{r(call['K9'])}, with the masked loop {r(call['masked loop'])}")
    for who, p in prof.items():
        print(f"  profile, batch-8 call with "
              f"{'K9' if who == 'K9' else 'the masked loop'}: wall "
              f"{p['wall_ms']:.1f} ms, device busy {p['busy_ms']:.1f} ms "
              f"({100 * p['busy_share']:.1f}%), {p['events']} device events, "
              f"K9 {p['k9_ms']:.2f} ms / {p['k9_launches']} launches")
    stages = prof["K9"]["stages"]
    print("  K9's kernels in the profile: " + ", ".join(
        f"{k} {v['ms']:.3f} ms / {v['launches']}" for k, v in stages.items()))
    want = integrator.k9_launches(int(args[9]), edited=integrator.k9_engine(
        kw.get("hf_mips"), kw.get("hf_edit_bounds"),
        kw.get("bitworld")) == "edited")
    if prof["K9"]["k9_launches"] != want or prof["masked loop"]["k9_launches"]:
        raise AssertionError(f"{name}: the profiles saw K9's kernels launch "
                             f"{prof['K9']['k9_launches']} (expected {want}) "
                             f"and {prof['masked loop']['k9_launches']} times")
    return dict(name=name, paths=B, record=dict(
        max_abs_err=err, ms=k9_ms, plain_ms=plain_ms, bound_ms=bound_ms,
        bound_by=bound_by, library_ms=None), full_march_ms=full_ms,
        state_ms=state_ms, stages=stages, simt=eff, counts=counts,
        launches=prof["K9"]["k9_launches"], call_ms=call)


def _path_summary(recs):
    """K9's ptxas registers and spills by stage, and a line per
    configuration."""
    for entry, regs, props in _ptxas_k9():
        print(f"ptxas K9 {entry}: {regs}; {props}")
    for rec in recs:
        x = rec["record"]
        print(f"K9 summary, {rec['name']}: {x['ms']:.2f} ms a batch-8 call "
              f"({rec['paths']} paths), masked loop {x['plain_ms']:.2f} ms, "
              f"bound {x['bound_ms']:.3f} ms ({x['bound_by']}; full-march "
              f"{rec['full_march_ms']:.3f}, with the stages' state "
              f"{rec['state_ms']:.3f}), max abs difference "
              f"{x['max_abs_err']:.3e}; SIMT efficiency "
              + ", ".join(f"{k} {100 * v:.1f}%" for k, v in rec["simt"].items()))


def phase_main(space, dev):
    """The headless day-cycle at 1024^3, 853x480 with the default Renderer
    (rasterized primaries, heightfield bounce and shadow casts); returns
    its launch counts. Then the SVO engine (SVO primaries, bounce and
    shadow casts), driven the same way."""
    from voxtracer_torch.render.driver import Renderer

    cam = _smoke_camera(LOG2_SIZE)
    renderer = Renderer(space.serialize(), WIDTH, HEIGHT, seed=0, device=dev)
    if not renderer.soup_world or renderer._get_hf()[0] is None \
            or renderer._hf_only():
        raise AssertionError("the terrain world did not take the soup and "
                             "heightfield engines")
    counts = _headless(renderer, cam, 2, 16, 8, "1024^3 path")
    _expect_launches("1024^3 path", counts, ("path_trace", "resolve_fold"),
                     ("sky_tmin", "env_build", "fog_march", "svo_cast"))
    path_recs = [phase_path_kernel("1024^3, default Renderer", renderer,
                                   cam)]
    svo = Renderer(space.serialize(), WIDTH, HEIGHT, seed=0, device=dev,
                   use_soup=False, use_hf=False)
    svo_counts = _headless(svo, cam, 1, 8, 8, "SVO-engine path")
    _expect_launches("SVO-engine path", svo_counts, ("path_trace",),
                     ("resolve_fold", "hf_cast", "sky_tmin", "env_build",
                      "fog_march", "svo_cast"))
    path_recs.append(phase_path_kernel("1024^3, SVO engine", svo, cam))
    return counts, svo_counts, renderer, svo, path_recs


def phase_primaries(soup_r, svo_r):
    """ms/sample at batch 1 and 8 of the default Renderer (rasterized
    primaries, heightfield casts) and of the SVO engine, in turns (raster,
    SVO, SVO, raster), and the share of a batch-8 sample that its
    rasterized primaries take (bins, resolve and fallback)."""
    import torch

    from voxtracer_torch.core import rng as vrng
    from voxtracer_torch.kernels import integrator, raster

    cam = _smoke_camera(LOG2_SIZE)
    sun = np.asarray([0.8, 10.2743, 3.7])

    def per_sample(r, k):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        if k == 1:
            r.sample(cam, sun)
        else:
            r.sample_batch(cam, sun, k)
        torch.cuda.synchronize()
        return 1e3 * (time.monotonic() - t0) / k

    out = {}
    for k, reps in ((1, 3), (8, 2)):
        runs = {"raster": [], "svo": []}
        for name, r in (("raster", soup_r), ("svo", svo_r), ("svo", svo_r),
                        ("raster", soup_r)):
            runs[name] += [per_sample(r, k) for _ in range(reps)]
        out[k] = runs
        print(f"batch {k}: ms/sample rasterized primaries and heightfield "
              f"casts {sorted(runs['raster'])}, SVO primaries and casts "
              f"{sorted(runs['svo'])}")

    basis = cam.basis()
    soup = soup_r._get_soup()
    dev = soup[0].device

    def make_bins():
        return raster.raster_bins(*soup, np.asarray(cam.pos, np.float32),
                                  basis, LOG2_SIZE, WIDTH, HEIGHT,
                                  jittered=True)

    bins = make_bins()
    bins_ms = _ms(make_bins, 3)
    seeds = [vrng.host_frame_seed(soup_r.host_rng) for _ in range(8)]
    d = torch.stack([integrator._primary(np.asarray(cam.pos, np.float32),
                                         basis, s, WIDTH, HEIGHT, dev)[1]
                     for s in seeds])
    w = soup_r.world

    def primaries():
        integrator._raster_primary(w.table, w.root, w.height,
                                   np.asarray(cam.pos, np.float32), basis, d,
                                   WIDTH, HEIGHT, soup, bins)

    prim_ms = _ms(primaries, 3)
    batch8 = float(np.median(out[8]["raster"])) * 8
    print(f"rasterized primaries of a batch-8 sample: bins {bins_ms:.3f} ms "
          f"per pose, resolve + fallback {prim_ms:.3f} ms per batch of 8, "
          f"= {100 * prim_ms / batch8:.2f}% of the batch's {batch8:.1f} ms "
          f"(bins once per pose: {100 * bins_ms / batch8:.2f}% if per batch)")


def _profile(name, renderer, cam, expect):
    """One torch.profiler window over a batch-8 sample_batch call: each
    kernel's device ms and launches, and the device busy share of the
    call's wall time. ``expect``: the kernels that must have launched."""
    from voxtracer_torch.tools.kernel_ab import profile_call

    sun = np.asarray([0.8, 10.2743, 3.7])
    prof = profile_call(lambda: renderer.sample_batch(cam, sun, 8))
    per = ", ".join(f"{k} {v['ms']:.3f} ms / {v['launches']} launches"
                    for k, v in prof["kernels"].items())
    print(f"profile, batch-8 sample_batch call, {name}: wall "
          f"{prof['wall_ms']:.1f} ms, device busy {prof['busy_ms']:.1f} ms "
          f"({100 * prof['busy_share']:.1f}%), {prof['device_events']} "
          f"device events; {per}")
    for k in expect:
        if prof["kernels"].get(k, prof["kernels"].get(f"{k}_kernel"))[
                "launches"] <= 0:
            raise AssertionError(f"the profile of the {name} saw no {k} "
                                 "launch")
    return prof


def phase_engines(space, dev):
    """The heightfield engine against the SVO engine at 1024^3, both with
    rasterized primaries, in turns in this process: the radiance of the
    same 8 seeds, ms per batch-8 call, and a profile window of each."""
    import torch

    from voxtracer_torch.render.driver import Renderer

    cam = _smoke_camera(LOG2_SIZE)
    sun = np.asarray([0.8, 10.2743, 3.7])
    dev_svo = space.serialize()
    rs = {name: Renderer(dev_svo, WIDTH, HEIGHT, seed=0, device=dev,
                         use_hf=name == "heightfield")
          for name in ("heightfield", "SVO")}
    for r in rs.values():  # the same 8 seeds; soup, bins, pack, warm-up
        r.sample_batch(cam, sun, 8)
    torch.cuda.synchronize()
    a, b = rs["heightfield"].acc.buffer, rs["SVO"].acc.buffer
    diff = int((a != b).any(-1).sum())
    budget = int(np.ceil(RAYS * 8 * GRAZE_SHARE))
    rel = abs(float(a.mean()) / float(b.mean()) - 1.0)
    print(f"engines at 1024^3, one batch of 8 samples, same seeds: {diff} of "
          f"{RAYS} pixels differ (budget {budget}: {GRAZE_SHARE:.2e} of the "
          f"batch's paths), image means {float(a.mean()) / 8:.6f} vs "
          f"{float(b.mean()) / 8:.6f} (rel {rel:.2e})")
    if diff > budget or rel > GOLDEN_MEAN_REL or not torch.isfinite(a).all():
        raise AssertionError("the two engines' radiance differs")
    ms = {name: [] for name in rs}
    for name in ("heightfield", "SVO", "SVO", "heightfield"):
        for _ in range(2):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            rs[name].sample_batch(cam, sun, 8)
            torch.cuda.synchronize()
            ms[name].append(1e3 * (time.monotonic() - t0))
    print("engines at 1024^3, ms per batch-8 call in turns: heightfield "
          f"{[round(m, 2) for m in ms['heightfield']]}, SVO "
          f"{[round(m, 2) for m in ms['SVO']]}")
    _profile("1024^3, heightfield engine", rs["heightfield"], cam,
             ("path_trace", "resolve_fold"))
    _profile("1024^3, SVO engine", rs["SVO"], cam,
             ("path_trace", "resolve_fold"))


def _sky_bound(d, E, bin_w):
    """K5's bound on the directions ``d`` (B, 3): each ray's direction
    (12 B) read and t_min (4 B) written once, and once each table row
    these rays reach (their azimuth bins), not the whole table; the
    per-ray arithmetic and the row search's compares."""
    from voxtracer_torch.kernels import skyline

    B, (bins, K) = d.shape[0], E.shape
    rows = skyline.azimuth_bin(d, bin_w, bins).unique().numel()
    steps = int(np.ceil(np.log2(K + 1)))
    return _bound(B * 16 + rows * K * 4,
                  B * (K5_RAY_OPS + steps * K5_STEP_OPS))


def _env_selected(pack, plan) -> int:
    """The cells of ``plan``'s levels that the ladder selects (sky_env.cu's
    gate, replayed on the card)."""
    import torch

    f32, dev = torch.float32, pack["flat"].device
    ox, oz = plan["ox"], plan["oz"]

    def d_min(x0, x1, z0, z1):
        return torch.hypot(
            torch.clamp_min(torch.maximum(x0 - ox, ox - x1), 0.0),
            torch.clamp_min(torch.maximum(z0 - oz, oz - z1), 0.0))

    n = 0
    for lvl in plan["levels"]:
        r = torch.arange(lvl.size * lvl.size, device=dev)
        x0 = (lvl.i0 + r // lvl.size).to(f32) * lvl.c
        z0 = (lvl.j0 + r % lvl.size).to(f32) * lvl.c
        sel = d_min(x0, x0 + lvl.c, z0, z0 + lvl.c) >= lvl.a_lo
        if not lvl.is_top:
            pc = 2.0 * lvl.c
            px0, pz0 = torch.floor(x0 / pc) * pc, torch.floor(z0 / pc) * pc
            sel &= d_min(px0, px0 + pc, pz0, pz0 + pc) < lvl.a_hi
        n += int(sel.sum())
    return n


def _env_bound(pack, plan, bins, K, used_rows, n_sel):
    """K10's bound: the workspace's clear, the used class rows read once,
    the dilated rows written and read, E and S written; against every
    cell's gate and the selected cells' fold (K10_CELL_OPS,
    K10_SEL_OPS)."""
    n_cls = len(plan["cls_w"])
    cells = sum(lvl.size * lvl.size for lvl in plan["levels"])
    nbytes = 4 * (K + n_cls * K * (bins + 1) + used_rows * bins
                  + 2 * K * bins + bins * (K + -(-K // 16)))
    return _bound(nbytes, cells * K10_CELL_OPS + n_sel * K10_SEL_OPS)


def _check_env_build(pack, origin, kw, tier):
    """K10 on one envelope tier: E and S equal to the plain build's
    (``skyline._env_device``) by bits, one launch count a build; its host
    ms to enqueue a build, its ms (CUDA events, a pair a build behind a
    spin), the plain build's ms and the bound (the used class rows read
    from its workspace)."""
    import torch

    from voxtracer_torch.kernels import build, skyline

    o = np.asarray(origin, np.float64)
    full = dict(dict(bins=4096, ratio=16, K=64, d0=4.0, cls_step=1.0), **kw)
    bins, K = full["bins"], full["K"]

    def plain():
        return skyline._env_device(
            pack["flat"], pack["coarse"], o, pack["offsets"], bins,
            full["ratio"], K, full["d0"], pack["height"], full["cls_step"])

    def k10():
        return skyline.build_skyline_env_device(pack, o, **kw)

    before = _launches()["env_build"]
    env = k10()
    if _launches()["env_build"] != before + 1:
        raise AssertionError("env_build: one launch count a build")
    E = plain()
    torch.cuda.synchronize()
    if not (torch.equal(env["E"], E)
            and torch.equal(env["S"], skyline.env_summary(E))):
        raise AssertionError(f"env_build tier {tier}: K10's table differs "
                             "from the plain build's")
    plan = skyline._env_plan(pack["offsets"], pack["height"], o, bins,
                             full["ratio"], K, full["d0"], full["cls_step"])
    _, _, _, ws = skyline._env_launch(
        build.library().voxt_sky_env, pack["flat"], pack["coarse"], plan,
        pack["offsets"], pack["height"], bins, K,
        torch.cuda.current_stream().cuda_stream)
    n_cls = len(plan["cls_w"])
    used = int((ws[K:K + n_cls * K] != 0).sum())
    n_sel = _env_selected(pack, plan)
    torch.cuda.synchronize()
    host = []
    for _ in range(5):
        t0 = time.perf_counter()
        k10()
        host.append(1e3 * (time.perf_counter() - t0))
        torch.cuda.synchronize()
    k_ms = _ms_fresh(lambda: None, k10, 10)
    p_ms = _ms_fresh(lambda: None, plain, 3)
    bound_ms, bound_by = _env_bound(pack, plan, bins, K, used, n_sel)
    cells = sum(lvl.size * lvl.size for lvl in plan["levels"])
    print(f"env_build tier {tier} {kw}: K10 equal to the plain build by "
          f"bits; {cells} cells, {n_sel} selected, {used} of "
          f"{n_cls * K} class rows used; K10 {k_ms:.4f} ms (host enqueue "
          f"{min(host):.3f} ms), plain {p_ms:.2f} ms, bound "
          f"{bound_ms:.4f} ms ({bound_by}), {100 * bound_ms / k_ms:.1f}% "
          "of the bound")
    return dict(ms=k_ms, host_ms=min(host), plain_ms=p_ms, bound_ms=bound_ms,
                bound_by=bound_by, cells=cells, selected=n_sel,
                used_rows=used)


def _k5_warps(shape, dev):
    """The warp of each lane of an (S, H, W) image set (lane order s, y,
    x) when K5 walks it in pixel tiles (sky_tmin.cu: a block of 8 columns
    x TY rows x SG samples, a warp one column of it)."""
    import torch

    S, H, W = shape
    sg = 1 << min(int(np.log2(S)), 5)
    ty = 32 // sg
    gx, gy = -(-W // 8), -(-H // ty)
    s = torch.arange(S, device=dev)[:, None, None]
    y = torch.arange(H, device=dev)[None, :, None]
    x = torch.arange(W, device=dev)[None, None, :]
    block = ((s // sg) * gy + y // ty) * gx + x // 8
    return (block * 8 + x % 8).reshape(-1)


def _k5_search_reads(E, S, d, shape, bin_w):
    """What K5's row search reads, replayed in PyTorch from this set's
    own indices, for each lane order (``lanes``: a thread a lane, warps
    of 32 consecutive lanes; ``tiles``: the image's pixel tiles,
    _k5_warps) and each search (``binary``: the first form's,
    ceil(log2(K + 1)) loads over E; ``two-level``: sky_tmin.cu's, a
    binary search over the summary row, then one in a block of 16 rungs
    of E): ``sectors_a_lane``, the distinct 32-B sectors a warp's live
    lanes read at each dependent load, summed over warps and loads, over
    the lanes (the L2 traffic when nothing stays in L1); and
    ``lines_a_warp``, the distinct 128-B lines a warp's search touches in
    all (its L1 footprint). Directions and t_min are not counted."""
    import torch

    from voxtracer_torch.kernels import skyline

    bins, K = E.shape
    nblk = S.shape[1]
    B = d.shape[0]
    cb, _, tan = skyline.lane_slopes(d, bin_w, bins)

    def search(flat, base, lo, hi, w, lines):
        """A lower-bound search of each lane's [lo, hi) at flat[base + .]:
        its result and the sectors summed over its dependent loads; the
        (warp, line) keys it touches go into ``lines``."""
        n = 0
        while True:
            live = lo < hi
            if not live.any():
                return lo, n
            mid = (lo + hi) >> 1
            at = (base + mid)[live]
            n += torch.unique(w[live] * (1 << 40) + (at >> 3)).numel()
            lines.append(torch.unique(w[live] * (1 << 40) + (at >> 5)))
            below = flat[torch.where(live, base + mid, 0)] < tan
            lo = torch.where(live & below, mid + 1, lo)
            hi = torch.where(live & ~below, mid, hi)

    out = {}
    zero = torch.zeros_like(cb)
    s_line0 = -(-int(E.numel()) // 32)  # S's lines numbered after E's
    for order, w in (("lanes", torch.arange(B, device=d.device) // 32),
                     ("tiles", _k5_warps(shape, d.device))):
        warps = torch.unique(w).numel()
        lines = []
        _, n = search(E.reshape(-1), cb * K, zero, zero + K, w, lines)
        out[f"{order}, binary"] = dict(
            sectors_a_lane=n / B,
            lines_a_warp=torch.unique(torch.cat(lines)).numel() / warps)
        lines = []
        c, n1 = search(S.reshape(-1), cb * nblk, zero, zero + nblk, w, lines)
        lines = [k + s_line0 for k in lines]
        lo = torch.clamp(c, max=nblk - 1) * skyline.SUMMARY_BLOCK
        hi = torch.where(c < nblk, torch.clamp(
            lo + skyline.SUMMARY_BLOCK, max=K) - 1, lo)
        _, n2 = search(E.reshape(-1), cb * K, lo, hi, w, lines)
        out[f"{order}, two-level"] = dict(
            sectors_a_lane=(n1 + n2) / B,
            lines_a_warp=torch.unique(torch.cat(lines)).numel() / warps)
    return out


def _batch8_primaries(renderer, cam, dev):
    """The jittered camera rays of a batch-8 call, (8 * RAYS, 3)."""
    import random

    import torch

    from voxtracer_torch.core import rng as vrng
    from voxtracer_torch.kernels import integrator

    host = random.Random(7)
    pos = np.asarray(cam.pos, np.float32)
    return torch.cat([
        integrator._primary(pos, cam.basis(), vrng.host_frame_seed(host),
                            WIDTH, HEIGHT, dev)[1].reshape(-1, 3)
        for _ in range(8)]).contiguous()


def phase_envelope(renderer, cam, dev):
    """K10 and K5 on the 8192^3 world, each of the Renderer's envelope
    tiers: K10 against the plain build (_check_env_build), the tier's
    build ms; K5 against its plain version at 409,440
    pixel-centre camera rays and at batch-8 width (jittered primaries),
    each set in image order (pixel tiles, as the main path calls it) and
    in lane order: rung counts (a t_min off by more than 1e-6 relative)
    up to the graze share of the lanes (their count, budget and max abs
    error go into the record too), max abs error over the rest; the row
    search's reads in each lane order and search (_k5_search_reads)
    beside the bound's bytes in sectors; the walk K5's t_min resumes
    (init_desc 3) against the full walk, hit, t and normal by bits in
    every lane. Returns K5's record of the batch-8 set at tier 1 in image
    order, the tier and order the held pose of the main path runs most,
    and K10's record at tier 1 (the tiers' records under "tiers")."""
    import torch

    from voxtracer_torch.kernels import heightfield, skyline

    tiles, offs, _ = renderer._get_hf()
    pos = np.asarray(cam.pos, np.float32)
    t0 = time.monotonic()
    pack = skyline.sky_levels_from_hf(tiles, offs, FULL_LOG2_SIZE)
    torch.cuda.synchronize()
    print(f"envelope pyramid at {1 << FULL_LOG2_SIZE}^3 (once a world): "
          f"{1e3 * (time.monotonic() - t0):.1f} ms, "
          f"{len(pack['coarse'])} coarse levels")
    _, cd = _camera_rays(cam, dev)
    sets = (("camera rays", cd, (1, HEIGHT, WIDTH)),
            ("batch-8 primaries", _batch8_primaries(renderer, cam, dev),
             (8, HEIGHT, WIDTH)))
    origin = torch.as_tensor(pos, device=dev)
    hmax_w = heightfield.terrain_max(tiles, offs)
    rec, env_recs = None, []
    for tier, (kw, first) in enumerate(renderer.SKY_TIERS):
        env_recs.append(_check_env_build(pack, cam.pos, kw, tier))
        builds = []
        for _ in range(3):
            torch.cuda.synchronize()
            t0 = time.monotonic()
            env = skyline.build_skyline_env_device(
                pack, np.asarray(cam.pos, np.float64), **kw)
            torch.cuda.synchronize()
            builds.append(1e3 * (time.monotonic() - t0))
        E, S = env["E"], env["S"]
        consts = skyline._consts(E.shape[0], env["d0"], env["g"])
        print(f"envelope tier {tier} {kw} (from use {first} of a pose): "
              f"build {sorted(round(b, 2) for b in builds)} ms, table "
              f"{tuple(E.shape)}, summary {tuple(S.shape)}")
        for name, d, shape in sets:
            B = d.shape[0]
            p = skyline.skyline_env_tmin_plain(E, d, *consts)
            plain_ms = _ms(lambda: skyline.skyline_env_tmin_plain(
                E, d, *consts), 2)
            bound_ms, bound_by = _sky_bound(d, E, consts[0])
            rows = skyline.azimuth_bin(d, consts[0], E.shape[0]).unique()
            bound_sectors = (B * 16 + rows.numel() * E.shape[1] * 4) / 32 / B
            reads = _k5_search_reads(E, S, d, shape, consts[0])
            print(f"sky_tmin tier {tier}, {name}: the row search replayed "
                  "from this set's indices (L2 sectors a lane, L1 lines a "
                  "warp): " + ", ".join(
                      f"{k} {v['sectors_a_lane']:.4f}, "
                      f"{v['lines_a_warp']:.2f}" for k, v in reads.items())
                  + f"; the bound's bytes {bound_sectors:.4f} sectors a "
                  "lane (directions, t_min and each reached row once)")
            out = {}
            for order, dd in (("image order", d.reshape(shape + (3,))),
                              ("lane order", d)):

                def kernel(dd=dd):
                    return skyline.skyline_env_tmin(
                        E, dd, env["d0"], env["g"], env["K"], summary=S)

                before = _launches()['sky_tmin']
                k = kernel().reshape(-1)
                torch.cuda.synchronize()
                if _launches()['sky_tmin'] != before + 1:
                    raise AssertionError("sky_tmin: one launch a call")
                off = (k - p).abs() > 1e-6 * p.abs()
                n_off = int(off.sum())
                budget = int(np.ceil(B * GRAZE_SHARE))
                err = float((k - p).abs()[~off].max())
                err_off = float((k - p).abs()[off].max()) if n_off else 0.0
                ms = _ms_fresh(lambda: None, kernel, 10)
                out[order] = dict(k=k, ms=ms, lanes_off=n_off,
                                  lanes_off_budget=budget, max_abs_err=err,
                                  max_abs_err_off_lanes=err_off)
                print(f"sky_tmin tier {tier}, {name} ({B} lanes), {order}: "
                      f"{n_off} lanes off the plain version (budget "
                      f"{budget}; max abs err {err_off:.3e} there), max abs "
                      f"err {err:.3e} elsewhere, "
                      f"{float((k > 0).float().mean()):.4f} certified, "
                      f"{float((k >= 1e37).float().mean()):.4f} all-miss; "
                      f"kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, bound "
                      f"{bound_ms:.4f} ms ({bound_by}), "
                      f"{100 * bound_ms / ms:.1f}% of the bound")
                if n_off > budget or not np.isfinite(err):
                    raise AssertionError(f"sky_tmin tier {tier}, {name}, "
                                         f"{order}: {n_off} lanes off")
            img = out["image order"]
            k = img.pop("k")
            if not torch.equal(k, out["lane order"].pop("k")):
                raise AssertionError(f"sky_tmin tier {tier}, {name}: the "
                                     "two lane orders differ")

            def walk(t_min):
                return heightfield.hf_raycast(
                    tiles, offs, FULL_LOG2_SIZE, origin, d, t_min=t_min,
                    init_desc=0 if t_min is None else 3, hmax_w=hmax_w)

            full, resumed = walk(None), walk(k)
            torch.cuda.synchronize()
            diff = int(((full["hit"] != resumed["hit"])
                        | (_bits(full["t"]) != _bits(resumed["t"]))
                        | (_bits(full["normal"]) != _bits(resumed["normal"]))
                        .any(-1)).sum())
            walk_ms = (_ms_fresh(lambda: None, lambda: walk(None), 3),
                       _ms_fresh(lambda: None, lambda: walk(k), 3))
            print(f"sky_tmin tier {tier}, {name}: resumed walk against the "
                  f"full walk: {diff} lanes differ (budget 0), K4 "
                  f"{walk_ms[1]:.3f} ms resumed against {walk_ms[0]:.3f} ms "
                  "full")
            if diff:
                raise AssertionError(f"sky_tmin tier {tier}, {name}: {diff} "
                                     "resumed lanes differ")
            if tier == 1 and name == "batch-8 primaries":
                rec = dict(img, plain_ms=plain_ms, bound_ms=bound_ms,
                           bound_by=bound_by, library_ms=None,
                           ms_lane_order=out["lane order"]["ms"],
                           search_reads=reads,
                           bound_sectors_a_lane=bound_sectors)
    return rec, dict(env_recs[1], tiers=env_recs)


def phase_envelope_path(renderer, cam):
    """The main path's envelope end to end at 8192^3: one batch-8
    sample_batch call with the envelope and one without (the same seeds),
    the radiance equal by bits; ms per call in turns (with, without,
    without, with); the preview frame (hf_frame_cast) with the envelope at
    init_desc 3 (the default) and 0, and without it."""
    import torch

    from voxtracer_torch.kernels import heightfield

    sun = np.asarray([0.8, 10.2743, 3.7])

    def call(env_on):
        if not env_on:
            renderer._get_sky_env = lambda c: None
        try:
            renderer.host_rng.seed(1234)
            renderer.acc.invalidate()
            torch.cuda.synchronize()
            t0 = time.monotonic()
            renderer.sample_batch(cam, sun, 8)
            torch.cuda.synchronize()
            return 1e3 * (time.monotonic() - t0), renderer.acc.buffer.clone()
        finally:
            renderer.__dict__.pop("_get_sky_env", None)

    a = call(True)[1]
    b = call(False)[1]
    diff = int((a != b).any(-1).sum())
    ms = {True: [], False: []}
    for on in (True, False, False, True):
        ms[on].append(call(on)[0])
    with_ms = [round(m, 2) for m in ms[True]]
    without_ms = [round(m, 2) for m in ms[False]]
    print(f"batch-8 sample_batch at {1 << FULL_LOG2_SIZE}^3, the same seeds "
          f"with and without the envelope: {diff} of {RAYS} pixels differ "
          f"(budget 0); ms per call in turns: with {with_ms}, without "
          f"{without_ms} (tier {renderer._sky_env[2]})")
    if diff or not torch.isfinite(a).all():
        raise AssertionError("the envelope changed the radiance")
    tiles, offs, trgb = renderer._get_hf()
    env = renderer._get_sky_env(cam)
    pos = np.asarray(cam.pos, np.float32)

    def frame(**kw):
        return heightfield.hf_frame_cast(tiles, offs, FULL_LOG2_SIZE, pos,
                                         cam.basis(), WIDTH, HEIGHT, trgb,
                                         **kw)

    ref = frame()
    out = {}
    for name, kw in (("no envelope", {}), ("envelope, init_desc 3",
                                           dict(sky_env=env)),
                     ("envelope, init_desc 0", dict(sky_env=env,
                                                    init_desc=0))):
        r = frame(**kw)
        if not all(torch.equal(_bits(r[k]), _bits(ref[k])) for k in ref):
            raise AssertionError(f"hf_frame_cast {name} differs")
        out[name] = _ms(lambda: frame(**kw), 5)
    print(f"hf_frame_cast {1 << FULL_LOG2_SIZE}^3 {WIDTH}x{HEIGHT}, equal by "
          "bits, ms: " + ", ".join(f"{k} {v:.3f}" for k, v in out.items()))


def _edit_site(space, cam, dx=0):
    """The highest column of a 64 x 64 window ahead of the camera."""
    x0, z0 = int(cam.pos[0]) + 20 + dx, int(cam.pos[2]) + 20
    win = space.heights[x0:x0 + 64, z0:z0 + 64]
    cx, cz = np.unravel_index(np.argmax(win), win.shape)
    return int(cx) + x0, int(cz) + z0


def _unresolved(r, cam):
    """Rays the rasterized preview of ``r`` leaves unresolved (open tiles
    are not re-cast in a preview)."""
    from voxtracer_torch.kernels import raster

    soup = r._get_soup()
    if soup is None:
        return 0
    res = raster.raster_cast(*soup, np.asarray(cam.pos, np.float32),
                             cam.basis(), r.world.height, r.width, r.height,
                             bins=r._get_soup_bins(cam, soup))
    return int(res["fb_need"].sum())


def _against_fresh(name, r, space, cam, sun, budget, dev):
    """The preview and a batch-8 path sample of ``r`` against a Renderer
    built fresh on the edited space: the sample up to ``budget`` pixels,
    the preview up to that plus the rays either rasterized preview leaves
    unresolved."""
    import torch

    from voxtracer_torch.render.driver import Renderer

    t0 = time.monotonic()
    fresh = Renderer(space.serialize(), WIDTH, HEIGHT, seed=0, device=dev)
    img_b = fresh.preview_frame(cam, sun)
    torch.cuda.synchronize()
    fresh_s = time.monotonic() - t0
    img_a = r.preview_frame(cam, sun)
    open_rays = _unresolved(r, cam) + _unresolved(fresh, cam)
    prev = int((img_a != img_b).any(-1).sum())
    for x in (r, fresh):
        x.host_rng.seed(99)
        x.acc.invalidate()
        x.sample_batch(cam, sun, 8)
    torch.cuda.synchronize()
    path = int((r.acc.buffer != fresh.acc.buffer).any(-1).sum())
    engines = lambda x: ("raster" if x._get_soup() is not None else "per-ray",
                         "hf" if x._get_hf()[0] is not None else "svo",
                         "bounds" if x._hf_bounds() is not None else "pure")
    print(f"edits, {name}: against a fresh Renderer ({fresh_s:.1f} s to build "
          f"and preview; engines {engines(r)} against {engines(fresh)}): "
          f"preview {prev} pixels differ (budget {budget} + {open_rays} "
          f"unresolved rays), batch-8 sample {path} pixels differ (budget "
          f"{budget})")
    if path > budget or prev > budget + open_rays \
            or not torch.isfinite(img_a).all() or not img_a.max() > 0:
        raise AssertionError(f"edits, {name}: the edited Renderer differs "
                             "from a fresh one")


def _exact_edits(space, cam):
    """The edit session's heightfield-exact batches, each one edit as a
    user makes them: top voxels deleted and placed back in terrain
    colour, column by column (made as the space changes)."""
    trgb = space.terrain_rgb
    for k in range(6):
        cx, cz = _edit_site(space, cam, dx=8 * k)
        top = int(space.heights[cx, cz])
        yield [((cx, top - 1, cz), None)]
        yield [((cx, top - 1, cz), trgb), ((cx, top, cz), trgb)]


def _bounds_edits(space, cam):
    """Then the batches that need bounds boxes (the hybrid cast): a
    floating white block, a hole under the top, two coloured blocks."""
    cx, cz = _edit_site(space, cam)
    top = int(space.heights[cx, cz])
    yield [((cx, top + 3, cz), (1.0, 1.0, 1.0))]
    yield [((cx + 1, top - 3, cz), None)]
    yield [((cx - 1, top + 1, cz), (0.9, 0.2, 0.1)),
           ((cx - 1, top + 2, cz), (0.9, 0.2, 0.1))]


def phase_edits(space, dev):
    """Edits at 1024^3 through Renderer.apply_edits with the soup on
    (module doc, 7); returns the edit-to-preview latencies."""
    import torch

    from voxtracer_torch.render.driver import Renderer

    cam = _smoke_camera(LOG2_SIZE)
    sun = np.asarray([0.8, 10.2743, 3.7])
    r = Renderer(space.serialize(), WIDTH, HEIGHT, seed=0, device=dev)
    r.preview_frame(cam, sun)  # the soup and pose bins exist: edits patch
    r.sample_batch(cam, sun, 8)
    lat = []
    part = {}

    def timed(name, fn):
        """``fn`` with its seconds (synchronized) kept in ``part``."""
        def run(*a, **k):
            t = time.monotonic()
            out = fn(*a, **k)
            torch.cuda.synchronize()
            part[name] = time.monotonic() - t
            return out
        return run

    r._apply_hf_edits = timed("heightfield", r._apply_hf_edits)
    r._soup.apply = timed("soup", r._soup.apply)

    def edit(batch):
        torch.cuda.synchronize()
        part.clear()
        t0 = time.monotonic()
        for p, val in batch:
            space.set(p, val)
        t1 = time.monotonic()
        r.apply_edits(space, edits=[p for p, _ in batch])
        torch.cuda.synchronize()
        t2 = time.monotonic()
        img = r.preview_frame(cam, sun)
        torch.cuda.synchronize()
        t3 = time.monotonic()
        lat.append((t1 - t0, t2 - t1, t3 - t2, part.get("soup", 0.0),
                    part.get("heightfield", 0.0)))
        return img

    for batch in _exact_edits(space, cam):
        edit(batch)
    if r._hf_bounds() is not None or not space.heights_exact \
            or r._soup is None:
        raise AssertionError("heightfield-exact edits left the pure walk")
    _against_fresh("heightfield-exact", r, space, cam, sun, 0, dev)
    for batch in _bounds_edits(space, cam):
        edit(batch)
    if r._hf_bounds() is None or r._get_hf()[0] is None:
        raise AssertionError("bounds-tracked edits dropped the hybrid")
    _against_fresh("bounds-tracked", r, space, cam, sun,
                   int(np.ceil(RAYS * 8 * GRAZE_SHARE)), dev)
    path_rec = phase_path_kernel("1024^3 edit session (edited heightfield)",
                                 r, cam)
    parts = np.array(lat) * 1e3
    tot = parts[:, :3].sum(axis=1)
    q = lambda a: f"p50 {np.percentile(a, 50):.2f} / p90 " \
        f"{np.percentile(a, 90):.2f} / max {a.max():.2f}"  # noqa: E731
    print(f"edits at 1024^3 {WIDTH}x{HEIGHT}, {len(lat)} batches: "
          f"edit-to-preview ms {q(tot)}; space.set {q(parts[:, 0])}; "
          f"apply_edits {q(parts[:, 1])} (of it the soup patch "
          f"{q(parts[:, 3])}, the heightfield patch {q(parts[:, 4])}); "
          f"preview_frame {q(parts[:, 2])}")
    return lat, path_rec



def _q(a):
    """p50 / max of a list of milliseconds."""
    a = np.asarray(a, np.float64)
    return f"p50 {np.percentile(a, 50):.3f} / max {a.max():.3f}"


def _walk(cam, steps, step=10.0):
    """Poses of an interactive walk: ``steps`` moves of ``step`` voxels
    along the view's horizontal forward axis (the session's ``w``)."""
    from voxtracer_torch.core import camera as vcam

    fwd = vcam.camera_basis(cam.yaw, 0.0).numpy() @ np.array([0., 0., 1.])
    return [vcam.Camera(pos=tuple(np.asarray(cam.pos) + fwd * step * k),
                        yaw=cam.yaw, pitch=cam.pitch) for k in range(steps)]


def _wall_ms(fn, reps):
    """Milliseconds of each of ``reps`` calls on the host clock, the card
    synchronized before and after each (host dispatch included)."""
    import torch

    out = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        fn()
        torch.cuda.synchronize()
        out.append(1e3 * (time.monotonic() - t0))
    return out


def phase_cull(space, soup_t, world, dev):
    """The per-pose culled view at 1024^3, 853x480 (world/active.py): its
    share of the soup; the horizon build, cull and bins against bins on
    the full soup; the exact frame on the view against the full soup's
    (every output, 0 pixels); the batch-8 call's jittered primaries on
    the view against the full soup's and the SVO cast's; and a preview
    after each move of a walk (re-cull, bins, frame) on either soup. The
    Renderer does not rasterize through the view (PERF.md section 6)."""
    import torch

    from voxtracer_torch.kernels import raster
    from voxtracer_torch.world import active, occlusion

    cam = _smoke_camera(LOG2_SIZE)
    op = np.asarray(cam.pos, np.float32)
    basis = cam.basis()
    m = soup_t[0].shape[0]
    act = active.ActiveSoup(soup_t, WIDTH, HEIGHT, heights=space.heights)
    rows = act.active(op, basis)
    share = act.n_active / m
    budget = act._trans_budget()

    def horizon():
        return occlusion.build_horizon(act._hmin2, op, act.occl_slack,
                                       act._nd, act._pool)

    tables = horizon()
    horizon_ms = _wall_ms(horizon, 5)
    cull_ms = _wall_ms(lambda: active._cull(
        *soup_t, op, basis.numpy(), act._fx, act._fy, act.keep_radius,
        budget, occl=tables, nd=act._nd, occl_slack=budget, pool=act._pool),
        5)
    frustum_ms = _wall_ms(lambda: active._cull(
        *soup_t, op, basis.numpy(), act._fx, act._fy, act.keep_radius,
        budget), 5)

    def bins(s, c=cam):
        return raster.raster_bins(*s, np.asarray(c.pos, np.float32),
                                  c.basis(), LOG2_SIZE, WIDTH, HEIGHT,
                                  jittered=True)

    def fresh_view():
        act._pose = None
        return act.active(op, basis)

    view_ms = _wall_ms(fresh_view, 5)
    bins_view = _wall_ms(lambda: bins(rows), 5)
    bins_full = _wall_ms(lambda: bins(soup_t), 5)
    both = _wall_ms(lambda: bins(fresh_view()), 5)
    print(f"cull 1024^3 {WIDTH}x{HEIGHT}: view {act.n_active} of {m} boxes "
          f"({100 * share:.2f}%; pool {act._pool}, slack {act.occl_slack}, "
          f"validity {budget} voxels); ms over 5 calls: horizon build "
          f"{_q(horizon_ms)}, cull with the horizon {_q(cull_ms)}, frustum "
          f"alone {_q(frustum_ms)}, ActiveSoup.active (both) "
          f"{_q(view_ms)}; jittered bins on the view {_q(bins_view)} "
          f"against the full soup {_q(bins_full)}; build + cull + bins "
          f"{_q(both)}")
    if not 0 < act.n_active < m:
        raise AssertionError("the view culled nothing or everything")
    w = dict(table=world.table, root=world.root)
    got = raster.raster_cast_exact(*rows, op, basis, LOG2_SIZE, WIDTH, HEIGHT,
                                   **w)
    want = raster.raster_cast_exact(*soup_t, op, basis, LOG2_SIZE, WIDTH,
                                    HEIGHT, **w)
    diff = {k: int((_bits(got[k]) != _bits(want[k])).reshape(RAYS, -1)
                   .any(-1).sum())
            for k in ("hit", "t", "normal", "rgb", "node", "voxel")}
    print(f"cull: raster_cast_exact on the view against the full soup, "
          f"pixels that differ per output {diff} (budget 0); fallback tiles "
          f"{got['n_fallback']} / {want['n_fallback']}")
    if any(diff.values()):
        raise AssertionError("the culled frame differs from the full soup's")

    # the main path's primaries: where the full soup's rasterized hit is
    # the traversal's first hit, the view must give it by bits; a ray that
    # slips through a box's corner (its float32 slab interval under an
    # ulp) and on through the terrain's interior, which has no boxes, may
    # meet a box the horizon proof rightly culled. Such lanes are the
    # graze class: off the SVO cast on either soup, within GRAZE_SHARE.
    changed, off, off_view = _cull_primaries(rows, soup_t, world, cam, dev)
    lanes = changed.numel()
    graze = int(np.ceil(lanes * GRAZE_SHARE))
    stray = int((changed & ~off).sum())
    print(f"cull: batch-8 jittered primaries on the view against the full "
          f"soup: {int(changed.sum())} of {lanes} lanes differ, of them "
          f"where the full soup's hit is the SVO cast's {stray} (budget 0); "
          f"lanes off the SVO cast: full soup {int(off.sum())}, view "
          f"{int(off_view.sum())} (budget {graze} each)")
    if stray or int(off.sum()) > graze or int(off_view.sum()) > graze:
        raise AssertionError("the view's primaries differ from the full "
                             "soup's where they are exact")

    def preview(c, soup_of):
        s = soup_of(c)
        return raster.raster_cast(
            *s, np.asarray(c.pos, np.float32), c.basis(), LOG2_SIZE, WIDTH,
            HEIGHT, bins=bins(s, c), want_voxel=False)

    soup_of = dict(view=lambda c: act.active(c.pos, c.basis()),
                   full=lambda c: soup_t)
    prev = {name: [] for name in soup_of}
    for name in ("view", "full", "full", "view"):
        for c in _walk(cam, 7)[1:]:
            prev[name] += _wall_ms(lambda: preview(c, soup_of[name]), 1)
    print(f"cull: a rasterized preview after each 10-voxel move of a walk "
          f"(a new pose: bins and, on the view, a re-cull), in turns: view "
          f"{_q(prev['view'])} against full soup {_q(prev['full'])}")
    return dict(n_active=act.n_active, boxes=m)


def _cull_primaries(rows, soup_t, world, cam, dev):
    """The batch-8 call's jittered primaries (the seeds of a Renderer's
    first call, seed 0) rasterized on the view ``rows`` and on the full
    soup, each with its own jittered bins and the exact fallback on K2,
    against K2's cast of the same rays. Returns three masks (8, H, W):
    the lanes where the two soups differ, and the lanes where the full
    soup's and the view's hit are not K2's (hit, normal, or t beyond
    rtol 1e-4 / atol 1e-3)."""
    import random

    import torch

    from voxtracer_torch.core import rng as vrng
    from voxtracer_torch.kernels import integrator, raster, traverse

    op = np.asarray(cam.pos, np.float32)
    basis = cam.basis()
    rng = random.Random(0)
    seeds = [vrng.host_frame_seed(rng) for _ in range(8)]
    d = torch.stack([integrator._primary(op, basis, s, WIDTH, HEIGHT, dev)[1]
                     for s in seeds])
    a, b = (raster.raster_cast_exact(
        *s, op, basis, LOG2_SIZE, WIDTH, HEIGHT, table=world.table,
        root=world.root, ray_dirs=d, want_voxel=False)
        for s in (rows, soup_t))
    k2 = traverse.svo_raycast(world.table, world.root, world.height,
                              torch.as_tensor(op, device=dev), d)
    changed = (a["hit"] != b["hit"]) | (_bits(a["t"]) != _bits(b["t"])) \
        | (a["normal"] != b["normal"]).any(-1) | (a["rgb"] != b["rgb"]).any(-1)

    def off(x):
        both = x["hit"] & k2["hit"]
        return (x["hit"] != k2["hit"]) | (both & (
            (x["normal"] != k2["normal"]).any(-1)
            | ~torch.isclose(x["t"], k2["t"], rtol=1e-4, atol=1e-3)))

    off_full, off_view = off(b), off(a)
    for lane in changed.nonzero()[:8].tolist():
        i = tuple(lane)
        print(f"  lane (sample, y, x) {i}: view hit {bool(a['hit'][i])} t "
              f"{float(a['t'][i])!r}, full soup hit {bool(b['hit'][i])} t "
              f"{float(b['t'][i])!r}, K2 hit {bool(k2['hit'][i])} t "
              f"{float(k2['t'][i])!r} voxel {k2['voxel'][i].tolist()}")
    return changed, off_full, off_view


def phase_primary_engines(space, dev):
    """ROADMAP A10 at 1024^3, 853x480: the default Renderer (rasterized
    primaries below ``HF_FRAME_SIZE``) against one with ``HF_FRAME_SIZE``
    lowered to the world's edge (hf-only: K4 resumed by the pose's
    envelope through K5, previews ``hf_frame_cast``), in turns in one
    process: ``preview_frame`` held at the smoke pose and after each
    10-voxel move of a walk, and ms per batch-8 call. The hf-only
    preview is exact: it may differ from the rasterized one only at the
    rays that one leaves open and up to GRAZE_SHARE."""
    import torch

    from voxtracer_torch.render.driver import Renderer

    cam = _smoke_camera(LOG2_SIZE)
    sun = np.asarray([0.8, 10.2743, 3.7])
    rs = {name: Renderer(space.serialize(), WIDTH, HEIGHT, seed=0,
                         device=dev) for name in ("raster", "hf")}
    rs["hf"].HF_FRAME_SIZE = 1 << LOG2_SIZE
    if rs["raster"]._hf_only() or not rs["hf"]._hf_only():
        raise AssertionError("the Renderers do not run the engines asked "
                             "for")
    imgs = {}
    for name, r in rs.items():
        r.sample_batch(cam, sun, 8)
        imgs[name] = r.preview_frame(cam, sun)
    torch.cuda.synchronize()
    held = {name: [] for name in rs}
    walk = {name: [] for name in rs}
    batch = {name: [] for name in rs}
    for name in ("raster", "hf", "hf", "raster"):
        r = rs[name]
        held[name] += _wall_ms(lambda: r.preview_frame(cam, sun), 3)
        for c in _walk(cam, 7)[1:]:
            walk[name] += _wall_ms(lambda: r.preview_frame(c, sun), 1)
        batch[name] += _wall_ms(lambda: r.sample_batch(cam, sun, 8), 2)
    open_rays = _unresolved(rs["raster"], cam)
    px = int((imgs["raster"] != imgs["hf"]).any(-1).sum())
    budget = int(np.ceil(RAYS * GRAZE_SHARE))
    print(f"primary engines 1024^3 {WIDTH}x{HEIGHT}, in turns raster, hf, "
          f"hf, raster: preview_frame at a held pose raster "
          f"{_q(held['raster'])} against hf-only {_q(held['hf'])}; after "
          f"a 10-voxel move raster {_q(walk['raster'])} against hf-only "
          f"{_q(walk['hf'])}; ms per batch-8 call raster "
          f"{[round(x, 2) for x in batch['raster']]}, hf-only "
          f"{[round(x, 2) for x in batch['hf']]}; previews at the smoke "
          f"pose: {px} pixels differ (budget {budget} + the {open_rays} "
          f"rays the rasterized preview leaves open)")
    if not torch.isfinite(imgs["hf"]).all() or not imgs["hf"].max() > 0 \
            or px > budget + open_rays:
        raise AssertionError("the hf-only preview differs from the "
                             "rasterized one")


def phase_interact(dev):
    """A scripted interactive session (app/interactive.py) at 1024^3,
    853x480, on the card: moves, a look, del, place, r and save; the ms
    of each fast preview after a move and after an
    edit, and of each idle sample; every pick held by bits to the plain
    SVO cast of the same ray on the card."""
    import os

    import torch

    from voxtracer_torch.app import cli, interactive
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import traverse
    from voxtracer_torch.render import driver

    script = ["pose", "w", "w", "look 0.05 0.02", "d", "w", "a",
              None, None, "look 0.0 0.35", "del", "place", "w", "del",
              "place", "a", "r", None, None, "save shot.png", "pose", "q"]
    state = dict(cmd=None, edited=False)
    times = {"move": [], "move after edits": [], "edit": [], "r": [],
             "idle sample": [], "sample": []}
    picks = []
    orig_prev = driver.Renderer.preview_frame
    orig_sample = driver.Renderer.sample
    orig_pick = interactive.center_pick

    def kind():
        cmd = state["cmd"]
        if cmd in ("del", "place"):
            return "edit"
        if cmd == "r":
            return "r"
        return "move after edits" if state["edited"] else "move"

    def preview(self, cam, sun):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        out = orig_prev(self, cam, sun)
        torch.cuda.synchronize()
        times[kind()].append(1e3 * (time.monotonic() - t0))
        return out

    def sample(self, cam, sun):
        torch.cuda.synchronize()
        t0 = time.monotonic()
        orig_sample(self, cam, sun)
        torch.cuda.synchronize()
        times["idle sample" if state["cmd"] is None else "sample"].append(
            1e3 * (time.monotonic() - t0))

    def pick(world, pos, yaw, pitch):
        got = orig_pick(world, pos, yaw, pitch)
        start = torch.as_tensor(np.asarray(pos, np.float32)[None],
                                device=dev)
        d = vcam.camera_basis(yaw, pitch)[:, 2][None].to(dev)
        plain = traverse.svo_raycast_plain(
            world.table, world.root, world.height, start, d,
            torch.full((1,), traverse.FAR, device=dev), skip_t0=False)
        ref = None if not bool(plain["hit"][0]) else (
            plain["voxel"][0].cpu().numpy(), plain["normal"][0].cpu().numpy())
        same = (got is None and ref is None) or (
            got is not None and ref is not None
            and np.array_equal(got[0], ref[0])
            and np.array_equal(got[1], ref[1].astype(np.int64)))
        picks.append((got is not None, same))
        state["edited"] |= got is not None
        return got

    feed = iter(script)

    def next_cmd(_):
        state["cmd"] = next(feed)
        return state["cmd"]

    logs = []
    args = cli.build_parser().parse_args(
        ["interact", "--log2-size", str(LOG2_SIZE), "--width", str(WIDTH),
         "--height", str(HEIGHT)])
    cwd = os.getcwd()
    driver.Renderer.preview_frame = preview
    driver.Renderer.sample = sample
    interactive.center_pick = pick
    t0 = time.monotonic()
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            interactive.run_interactive(args, input_fn=next_cmd,
                                        log=logs.append, device=dev)
            shot = Path(tmp) / "shot.png"
            ok_files = shot.exists() and (Path(tmp) / "preview.png").exists()
    finally:
        os.chdir(cwd)
        driver.Renderer.preview_frame = orig_prev
        driver.Renderer.sample = orig_sample
        interactive.center_pick = orig_pick
    wall = time.monotonic() - t0
    for line in logs:
        if not line.startswith("["):
            print(f"  interact: {line}")
    dirs_ms = _ms(lambda: vcam.generate_rays(_smoke_camera(LOG2_SIZE), WIDTH,
                                             HEIGHT, device=dev), 10)
    edits = sum(line.startswith(("deleted", "placed")) for line in logs)
    print(f"interact 1024^3 {WIDTH}x{HEIGHT}, {len(script)} commands in "
          f"{wall:.1f} s (world build included): fast preview ms after a "
          f"move {_q(times['move'])} (n "
          f"{len(times['move'])}), after an edit {_q(times['edit'])} (n "
          f"{len(times['edit'])}), after a move once edited "
          f"{_q(times['move after edits'])}, after r {_q(times['r'])}; "
          f"ms per idle sample {_q(times['idle sample'])}, per sample after "
          f"a command {_q(times['sample'])}; {edits} edits; picks {picks} "
          f"(hit, equal to the plain cast by bits); camera directions "
          f"{dirs_ms:.3f} ms a frame")
    if not ok_files or edits < 2 or not all(same for _, same in picks) \
            or not any(hit for hit, _ in picks):
        raise AssertionError("the interactive session failed its checks")


def phase_dense(dev):
    """BASELINE config 1 at full size: the 256^3 grid from_heightmap,
    camera rays at 640x360 through dense_raycast against K2 on the grid's
    from_dense octree, lane for lane up to GRAZE_SHARE; the ms of each,
    and the shaded frames of both."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import shade, traverse
    from voxtracer_torch.world import dense, svo, worldgen

    W, H, log2 = DENSE_WIDTH, DENSE_HEIGHT, DENSE_LOG2_SIZE
    n = 1 << log2
    t0 = time.monotonic()
    grid = dense.from_heightmap(worldgen.heightmap(log2, device=dev), n)
    t1 = time.monotonic()
    dev_svo = svo.from_dense(grid.solid, grid.rgb).serialize()
    t2 = time.monotonic()
    dw = grid.to_device(dev)
    world = svo.upload(dev_svo.table, dev_svo.root, dev_svo.height, dev)
    cam = _smoke_camera(log2)
    o, d = vcam.generate_rays(cam, W, H, device=dev)
    traverse.dense_host_reads = 0
    a = traverse.dense_raycast(dw.solid, o, d, n)
    reads = traverse.dense_host_reads
    b = traverse.svo_raycast(world.table, world.root, world.height, o, d)
    # the DDA sums its boundary t step by step, the octree walk takes it
    # from the cell's planes: t agrees to the raster parity tolerance, the
    # rest lane for lane up to the graze share
    fa_, fb_ = ({k: v.reshape(W * H, *v.shape[2:]) for k, v in r.items()}
                for r in (a, b))
    lanes, kinds = _cast_mismatch(fa_, dict(fb_, t=fa_["t"]))
    both = fa_["hit"] & fb_["hit"]
    t_off = int((both & ~torch.isclose(fa_["t"], fb_["t"], rtol=1e-4,
                                       atol=1e-3)).sum())
    t_rel = float(((fa_["t"] - fb_["t"]).abs()
                   / fb_["t"].clamp_min(1.0))[both].max())
    budget = int(np.ceil(W * H * GRAZE_SHARE))
    dense_ms = _ms(lambda: traverse.dense_raycast(dw.solid, o, d, n), 3)
    k2_ms = _ms(lambda: traverse.svo_raycast(world.table, world.root,
                                             world.height, o, d), 10)
    sun = _sun(dev)
    fa = shade.dense_primary_frame(dw.solid, dw.rgb, n, o, d, sun)
    fb = shade.svo_primary_frame(world.table, world.root, world.height, o, d,
                                 sun)
    frame_diff = float((fa - fb).abs().max())
    print(f"dense {n}^3 {W}x{H}: from_heightmap {t1 - t0:.2f} s, from_dense "
          f"{t2 - t1:.2f} s ({dev_svo.table.shape[0]} node rows); "
          f"dense_raycast {dense_ms:.3f} ms ({reads} host reads of "
          f"alive.any(), one a step), K2 on the same rays {k2_ms:.3f} ms; "
          f"{int(a['hit'].sum())} hits; lanes differing in hit, normal or "
          f"voxel {lanes} {kinds} (budget {budget}), t beyond rtol 1e-4 / "
          f"atol 1e-3 {t_off} (largest relative difference {t_rel:.2e}); "
          f"shaded frames max abs difference {frame_diff:.2e}")
    if lanes + t_off > budget or not a["hit"].any() \
            or not torch.isfinite(fa).all():
        raise AssertionError("dense_raycast disagrees with K2")


LAUNCHED = ("fog_march", "svo_cast", "resolve_fold", "hf_cast", "sky_tmin",
            "beam_walk", "beam_resolve", "bit_dda", "path_trace", "env_build")


def _zero_launches():
    from voxtracer_torch.utils import profiling

    profiling.reset()


def _launches():
    """Each kernel's launches since the last ``_zero_launches``, from the
    port's counter registry (``launches.<kernel>``)."""
    from voxtracer_torch.utils import profiling

    counts = profiling.counts()
    return {k: counts.get(f"launches.{k}", 0) for k in LAUNCHED}


def _nbytes(*xs) -> int:
    """Bytes of the tensors in ``xs`` (tuples and dicts searched)."""
    import torch

    n = 0
    for x in xs:
        if isinstance(x, torch.Tensor):
            n += x.numel() * x.element_size()
        elif isinstance(x, (tuple, list)):
            n += _nbytes(*x)
        elif isinstance(x, dict):
            n += _nbytes(*x.values())
    return n


def _wall_ms_sync(fn):
    """Milliseconds of one call on the host clock, the card synchronized
    before and after; returns (ms, fn's result)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.monotonic()
    out = fn()
    torch.cuda.synchronize()
    return 1e3 * (time.monotonic() - t0), out


def _in_turns(name, step, serial, n):
    """The sharded step against its ``n`` serial calls in turns (step,
    serial, serial, step); returns the step's and the serial result."""
    a1, out = _wall_ms_sync(step)
    b1, ref = _wall_ms_sync(serial)
    b2, _ = _wall_ms_sync(serial)
    a2, _ = _wall_ms_sync(step)
    print(f"{name}: ms per step {a1:.1f}, {a2:.1f} against {n} serial calls "
          f"{b1:.1f}, {b2:.1f} (host clock, synchronized; in turns; {CARD})")
    return out, ref


def _sum_ms(frames, dev):
    """ms of the mesh-order sum of the shards' frames onto the first
    device (CUDA events)."""
    def add():
        total = frames[0]
        for f in frames[1:]:
            total = total + f.to(dev)
        return total

    return _ms(add, 20)


def _dist_world(renderer, cam):
    """The default Renderer's world as the sharded steps take it: table,
    LUT and keywords (soup, heightfield pack), and the pose's bins."""
    soup = renderer._get_soup()
    hf_mips, hf_offsets, terrain_rgb = renderer._get_hf()
    w = renderer.world
    kw = dict(max_bounces=renderer.max_bounces, fog_steps=renderer.fog_steps,
              soup=soup, hf_mips=hf_mips, hf_offsets=hf_offsets,
              terrain_rgb=terrain_rgb)
    return w, kw, renderer._get_soup_bins(cam, soup)


def _dist_rank(rank, port, tmp, n_local, seeds_np):
    """One rank of the two-process job (torch.multiprocessing): gloo
    named, both ranks on cuda:0, ``n_local`` shards each; writes its
    sample step's frame to ``tmp/frame.<rank>.npy`` and its tile step's
    (the bands gathered through the host: gloo gathers no CUDA tensors)
    to ``tmp/tile.<rank>.npy``."""
    import torch

    from voxtracer_torch.dist import multihost, shard
    from voxtracer_torch.kernels import raster

    got = torch.load(Path(tmp) / "world.pt", weights_only=False)
    multihost.init(f"127.0.0.1:{port}", world_size=2, rank=rank,
                   local_devices=["cuda:0"] * n_local, backend="gloo")
    import torch.distributed as dist

    try:
        mesh = multihost.global_mesh(["cuda:0"] * n_local)
        table, lut = multihost.replicate_world_global(
            mesh, got["table"].numpy(), got["lut"].numpy())
        dev = mesh.devices[0]
        soup = tuple(a.to(dev) for a in got["soup"])
        kw = dict(got["kw"], soup=soup, hf_mips=got["hf_mips"].to(dev),
                  terrain_rgb=got["terrain_rgb"].to(dev))
        step = shard.sample_sharded_step(mesh, table, got["root"],
                                         got["height"], lut, WIDTH, HEIGHT,
                                         **kw)
        pos, basis, sun = got["pos"], got["basis"], got["sun"].to(dev)
        bins = raster.raster_bins(*soup, pos, basis, got["height"], WIDTH,
                                  HEIGHT, jittered=True)
        seeds = multihost.global_seeds(
            mesh, seeds_np[multihost.local_rows(mesh)])
        frame = step(seeds, pos, basis, sun, soup_bins=bins)
        np.save(Path(tmp) / f"frame.{rank}.npy", multihost.local_frame(frame))
        tstep = shard.tile_sharded_step(mesh, table, got["root"],
                                        got["height"], lut, WIDTH, HEIGHT,
                                        **kw)
        tile = tstep(seeds_np[0], pos, basis, sun, soup_bins=bins)
        np.save(Path(tmp) / f"tile.{rank}.npy", multihost.local_frame(tile))
        print(f"rank {rank} of {mesh.world_size}: backend "
              f"{dist.get_backend()}, devices "
              f"{[str(d) for d in mesh.devices]}, shards "
              f"{multihost.local_rows(mesh)}", flush=True)
        multihost.shutdown()
    finally:
        if dist.is_initialized():  # a failed rank: no barrier to wait at
            dist.destroy_process_group()


def _free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def phase_dist(space, dev):
    """Multi-device rendering at 1024^3, 853x480 on one card, the mesh
    ``[cuda:0] * 4`` (dist/): the sample-sharded step with the default
    Renderer's soup and heightfield pack equal by bits to the mesh-order
    sum of four render_sample calls; the tile-sharded step (K3 on band
    tile lists) equal by bits to the full frame; Renderer(devices=) against
    four single samples; a two-process gloo job on the card; a one-rank
    NCCL group. Returns the launch counts of the sharded steps."""
    import torch
    import torch.distributed as dist

    from voxtracer_torch.dist import shard
    from voxtracer_torch.dist.mesh import make_mesh
    from voxtracer_torch.kernels.integrator import render_sample
    from voxtracer_torch.render.driver import Renderer

    cam = _smoke_camera(LOG2_SIZE)
    pos, basis = np.asarray(cam.pos, np.float32), cam.basis()
    sun = _sun(dev)
    base = Renderer(space.serialize(), WIDTH, HEIGHT, seed=0, device=dev)
    if not base.soup_world or base._get_hf()[0] is None or base._hf_only():
        raise AssertionError("the terrain world did not take the soup and "
                             "heightfield engines")
    w, kw, bins = _dist_world(base, cam)
    mesh = make_mesh(devices=[dev] * 4)
    rep_bytes = _nbytes(w.table, base.lut, kw["soup"], kw["hf_mips"],
                        kw["terrain_rgb"])
    print(f"dist 1024^3: mesh {[str(d) for d in mesh.devices]} "
          f"({len(mesh.distinct)} distinct); a world replica (table, LUT, soup, heightfield pack) "
          f"{rep_bytes / 2**20:.1f} MiB, shared by the repeated device; "
          f"device memory in use {torch.cuda.memory_allocated() / 2**20:.1f} "
          f"MiB ({CARD})")
    rng = np.random.default_rng(20261018)
    seeds = rng.integers(0, 2**32, (4, 3), dtype=np.uint64).astype(np.uint32)

    def single(seed, **band):
        return render_sample(w.table, w.root, w.height, base.lut, pos, basis,
                             sun, seed, WIDTH, HEIGHT, soup_bins=bins,
                             **band, **kw)

    def serial():
        total = single(seeds[0])
        for s in seeds[1:]:
            total = total + single(s)
        return total

    counts = {}
    step = shard.sample_sharded_step(mesh, w.table, w.root, w.height, base.lut,
                                     WIDTH, HEIGHT, **kw)
    torch.cuda.synchronize()
    _zero_launches()
    out = step(seeds, pos, basis, sun, soup_bins=bins)
    torch.cuda.synchronize()
    counts["sample"] = _launches()
    _expect_launches("sample-sharded step", counts["sample"],
                     ("path_trace", "resolve_fold"), ("svo_cast", "fog_march"))
    out, ref = _in_turns("sample-sharded step, 4 shards", lambda: step(
        seeds, pos, basis, sun, soup_bins=bins), serial, 4)
    print(f"  mesh-order sum of 4 frames: "
          f"{_sum_ms([out] * 4, mesh.devices[0]):.4f} ms (CUDA events); "
          f"launches {counts['sample']}; equal by bits to the serial sum: "
          f"{torch.equal(out, ref)}; finite "
          f"{bool(torch.isfinite(out).all())}, "
          f"mean {float(out.mean()) / 4:.6f}")
    if not torch.equal(out, ref) or not torch.isfinite(out).all() \
            or not out.mean() > 0:
        raise AssertionError("the sample-sharded step differs from the "
                             "serial sum")

    tstep = shard.tile_sharded_step(mesh, w.table, w.root, w.height, base.lut,
                                    WIDTH, HEIGHT, **kw)
    seed = seeds[0]
    torch.cuda.synchronize()
    _zero_launches()
    tout = tstep(seed, pos, basis, sun, soup_bins=bins)
    torch.cuda.synchronize()
    counts["tile"] = _launches()
    _expect_launches("tile-sharded step (band tile lists)", counts["tile"],
                     ("path_trace", "resolve_fold"), ("svo_cast", "fog_march"))
    tout, full = _in_turns(
        "tile-sharded step, 4 bands of 120 rows",
        lambda: tstep(seed, pos, basis, sun, soup_bins=bins),
        lambda: single(seed), 1)
    same = tstep.out_rows == HEIGHT and torch.equal(tout[:HEIGHT], full)
    print(f"  launches {counts['tile']} (K3 on the bands' tile runs); "
          f"out_rows {tstep.out_rows}; equal by bits to the full frame: "
          f"{same}")
    if not same:
        raise AssertionError("the tile-sharded step differs from the frame")

    # Renderer(devices=): the step total is the serial sum (the buffer
    # starts at 0); a second step matches 4 more single samples within
    # the JAX package's tolerance (tests/test_dist.py)
    r4 = Renderer(space.serialize(), WIDTH, HEIGHT, seed=5,
                  devices=[dev] * 4)
    r1 = Renderer(space.serialize(), WIDTH, HEIGHT, seed=5, device=dev)
    sun_np = np.asarray([0.8, 10.2743, 3.7])
    ms4, _ = _wall_ms_sync(lambda: r4.sample(cam, sun_np))
    ms1, _ = _wall_ms_sync(lambda: [r1.sample(cam, sun_np) for _ in range(4)])
    first = torch.equal(r4.acc.buffer, r1.acc.buffer)
    r4.sample(cam, sun_np)
    for _ in range(4):
        r1.sample(cam, sun_np)
    close = torch.allclose(r4.acc.buffer, r1.acc.buffer, rtol=1e-5, atol=1e-4)
    print(f"Renderer(devices=[cuda:0] * 4).sample(): {ms4:.1f} ms against 4 "
          f"single sample() {ms1:.1f} ms (first calls, bins built); step "
          f"total equal by bits to the serial sum: {first}; after a second "
          f"step {r4.acc.samples} samples within rtol 1e-5 / atol 1e-4 of "
          f"{r1.acc.samples} single: {close}")
    if not first or not close or r4.acc.samples != 8:
        raise AssertionError("Renderer(devices=) differs from single samples")
    del r4, r1

    # a two-process job: gloo named, both ranks on cuda:0, 2 shards each
    import torch.multiprocessing as mp

    with tempfile.TemporaryDirectory() as tmp:
        torch.save(dict(table=w.table.cpu(), lut=base.lut.cpu(), root=w.root,
                        height=w.height,
                        soup=tuple(a.cpu() for a in kw["soup"]),
                        hf_mips=kw["hf_mips"].cpu(),
                        terrain_rgb=kw["terrain_rgb"].cpu(),
                        kw=dict(max_bounces=kw["max_bounces"],
                                fog_steps=kw["fog_steps"],
                                hf_offsets=kw["hf_offsets"]),
                        pos=pos, basis=basis.cpu(), sun=sun.cpu()),
                   Path(tmp) / "world.pt")
        t0 = time.monotonic()
        mp.spawn(_dist_rank, args=(_free_port(), tmp, 2, seeds), nprocs=2,
                 join=True)
        f0, f1 = (np.load(Path(tmp) / f"frame.{r}.npy") for r in range(2))
        t0_, t1_ = (np.load(Path(tmp) / f"tile.{r}.npy") for r in range(2))
    wall = time.monotonic() - t0
    tiles_equal = np.array_equal(t0_, t1_) \
        and np.array_equal(t0_[:HEIGHT], full.cpu().numpy())
    ranks_equal = np.array_equal(f0, f1)
    close = np.allclose(f0, out.cpu().numpy(), rtol=1e-6, atol=1e-6)
    print(f"two-process job (torch.multiprocessing, backend gloo named, "
          f"both ranks on cuda:0, 2 shards each, all_reduce on CUDA "
          f"tensors): {wall:.1f} s wall with start-up; ranks equal by bits: "
          f"{ranks_equal}; within rtol 1e-6 / atol 1e-6 of the one-process "
          f"4-shard step: {close} (max abs diff "
          f"{float(np.abs(f0 - out.cpu().numpy()).max()):.3e}); the tile "
          f"step's 4 bands gathered through the host equal on both ranks "
          f"and to the full frame by bits: {tiles_equal}")
    if not ranks_equal or not close or not tiles_equal:
        raise AssertionError("the two-process job differs")

    # NCCL with one rank: the step's all_reduce through a real group
    dist.init_process_group("nccl", init_method=f"tcp://127.0.0.1:"
                            f"{_free_port()}", world_size=1, rank=0)
    try:
        nmesh = make_mesh(devices=[dev] * 4, group=dist.group.WORLD)
        nstep = shard.sample_sharded_step(nmesh, w.table, w.root, w.height,
                                          base.lut, WIDTH, HEIGHT, **kw)
        nout = nstep(seeds, pos, basis, sun, soup_bins=bins)
        x = out.clone()
        ar_ms = _ms(lambda: dist.all_reduce(x, group=dist.group.WORLD), 20)
        same = torch.equal(nout, out)
        print(f"one-rank group, backend {dist.get_backend()}: the step's "
              f"all_reduce of a {tuple(out.shape)} frame {ar_ms:.4f} ms "
              f"(CUDA events); equal by bits to the in-process step: {same}")
        if not same:
            raise AssertionError("the NCCL step differs")
    finally:
        dist.destroy_process_group()
    return counts


def phase_dist_full(renderer, cam, dev):
    """The hf-only sharded steps at 8192^3, 853x480 on ``[cuda:0] * 4``,
    one call of each kind: the envelope as call args against none, both
    equal by bits (the JAX dryrun's out5 == out4, out7 == out7p), to the
    serial sum and to the full frame; then a remainder band (7 shards,
    483 rows cropped to 480). Returns the launch counts of the env steps."""
    import torch

    from voxtracer_torch.dist import shard
    from voxtracer_torch.dist.mesh import make_mesh
    from voxtracer_torch.kernels.integrator import render_sample

    pos, basis = np.asarray(cam.pos, np.float32), cam.basis()
    sun = _sun(dev)
    hf_mips, hf_offsets, terrain_rgb = renderer._get_hf()
    env = renderer._get_sky_env(cam)
    w = renderer.world
    kw = dict(max_bounces=renderer.max_bounces, fog_steps=renderer.fog_steps,
              hf_mips=hf_mips, hf_offsets=hf_offsets, terrain_rgb=terrain_rgb)
    mesh = make_mesh(devices=[dev] * 4)
    env_r = tuple(shard.replicate(mesh, a) if torch.is_tensor(a) else a
                  for a in env)
    rep_bytes = _nbytes(w.table, renderer.lut, hf_mips, terrain_rgb)
    print(f"dist 8192^3 (hf-only): a world replica (table, LUT, heightfield "
          f"pack) {rep_bytes / 2**20:.1f} MiB, the envelope "
          f"{_nbytes(env) / 2**20:.2f} MiB a pose; device memory in use "
          f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB ({CARD})")
    rng = np.random.default_rng(20261019)
    seeds = rng.integers(0, 2**32, (4, 3), dtype=np.uint64).astype(np.uint32)
    step = shard.sample_sharded_step(mesh, w.table, w.root, w.height,
                                     renderer.lut, WIDTH, HEIGHT, **kw)
    torch.cuda.synchronize()
    _zero_launches()
    ms_env, out5 = _wall_ms_sync(lambda: step(seeds, pos, basis, sun, *env_r))
    counts = dict(sample=_launches())
    ms_plain, out4 = _wall_ms_sync(lambda: step(seeds, pos, basis, sun))

    def single(seed, **band):
        return render_sample(w.table, w.root, w.height, renderer.lut, pos,
                             basis, sun, seed, WIDTH, HEIGHT, hf_sky_env=env,
                             **band, **kw)

    def serial():
        total = single(seeds[0])
        for s in seeds[1:]:
            total = total + single(s)
        return total

    ms_serial, ref = _wall_ms_sync(serial)
    ok_s = torch.equal(out5, out4) and torch.equal(out5, ref)
    print(f"sample-sharded step 8192^3, 4 shards: {ms_env:.1f} ms with the "
          f"envelope as call args, {ms_plain:.1f} without, 4 serial calls "
          f"{ms_serial:.1f} (host clock, synchronized; {CARD}); launches "
          f"{counts['sample']}; with == without == serial sum by bits: "
          f"{ok_s}")
    tstep = shard.tile_sharded_step(mesh, w.table, w.root, w.height,
                                    renderer.lut, WIDTH, HEIGHT, **kw)
    _zero_launches()
    ms_t, out7 = _wall_ms_sync(lambda: tstep(seeds[0], pos, basis, sun,
                                             *env_r))
    counts["tile"] = _launches()
    _, out7p = _wall_ms_sync(lambda: tstep(seeds[0], pos, basis, sun))
    ms_full, full = _wall_ms_sync(lambda: single(seeds[0]))
    step7 = shard.tile_sharded_step(make_mesh(devices=[dev] * 7), w.table,
                                    w.root, w.height, renderer.lut, WIDTH,
                                    HEIGHT, **kw)
    out_r = step7(seeds[0], pos, basis, sun, *env_r)
    ok_t = torch.equal(out7, out7p) and torch.equal(out7[:HEIGHT], full) \
        and step7.out_rows == 483 and torch.equal(out_r[:HEIGHT], full)
    print(f"tile-sharded step 8192^3, 4 bands: {ms_t:.1f} ms against the "
          f"full frame {ms_full:.1f} ms; launches {counts['tile']}; with == "
          f"without == full frame by bits, and 7 bands of 69 rows "
          f"({step7.out_rows} cropped to {HEIGHT}) == full frame: {ok_t}")
    for name in ("sample", "tile"):
        _expect_launches(f"8192^3 {name}-sharded step", counts[name],
                         ("path_trace", "hf_cast", "sky_tmin"),
                         ("svo_cast", "resolve_fold", "fog_march"))
    if not ok_s or not ok_t or not torch.isfinite(out5).all():
        raise AssertionError("the 8192^3 sharded steps differ")
    return counts


def phase_full(dev):
    """The main path at full width: the reference's 8192^3 world from the
    native builder, a Renderer in hf-only mode, the headless loop with
    EXR writes and checkpoints; returns its launch counts."""
    import torch

    from voxtracer_torch.render.driver import Renderer
    from voxtracer_torch.world import worldgen

    n = 1 << FULL_LOG2_SIZE
    t0 = time.monotonic()
    space = worldgen.generate(log2_size=FULL_LOG2_SIZE, backend="native",
                              device=dev)
    t1 = time.monotonic()
    dev_svo = space.serialize()
    renderer = Renderer(dev_svo, WIDTH, HEIGHT, seed=0, device=dev)
    torch.cuda.synchronize()
    t2 = time.monotonic()
    if not renderer._hf_only() or renderer._get_soup() is not None:
        raise AssertionError(f"the {n}^3 world is not in hf-only mode")
    torch.cuda.synchronize()
    t3 = time.monotonic()
    tiles = renderer._get_hf()[0]
    print(f"worldgen {n}^3 (native): {t1 - t0:.1f} s, "
          f"{dev_svo.table.shape[0]} node rows "
          f"({dev_svo.table.nbytes / 2**20:.1f} MiB); serialize and upload "
          f"{t2 - t1:.2f} s; heightfield pack {tuple(tiles.shape)} "
          f"({tiles.numel() * 4 / 2**20:.1f} MiB) in {t3 - t2:.2f} s; device "
          f"memory in use {torch.cuda.memory_allocated() / 2**20:.1f} MiB")
    cam = _smoke_camera(FULL_LOG2_SIZE)
    # K4 on the full-size pack at the main path's shapes, against its
    # plain version and against K2
    pack = (*renderer._get_hf()[:2], FULL_LOG2_SIZE)
    rng = np.random.default_rng(20261017)
    for name, start, d, distance, active in _svo_sets(
            rng, renderer.world, dev, FULL_LOG2_SIZE):
        if name in FULL_HF_SETS:
            _check_hf(f"{name} at {n}^3", pack, renderer.world, start, d,
                      distance, active, timed=name == "camera")
    sky_rec, env_rec = phase_envelope(renderer, cam, dev)
    counts = _headless(renderer, cam, 2, 16, 8, "main path",
                       log2_size=FULL_LOG2_SIZE, checkpoint_every=16)
    _expect_launches("main path", counts, ("path_trace", "hf_cast",
                                           "sky_tmin", "env_build"),
                     ("svo_cast", "resolve_fold", "fog_march"))
    path_rec = phase_path_kernel(f"{n}^3 main path (hf-only)", renderer, cam)
    phase_envelope_path(renderer, cam)
    phase_dist_full(renderer, cam, dev)
    _profile(f"{n}^3 main path", renderer, cam, ("path_trace", "hf_cast",
                                                 "sky_tmin"))
    sun = np.asarray([0.8, 10.2743, 3.7])
    ms = _ms(lambda: renderer.preview_frame(cam, sun), 5)
    img = renderer.preview_frame(cam, sun)
    if img is None or not torch.isfinite(img).all() or not img.mean() > 0:
        raise AssertionError("the hf-only preview frame is empty")
    print(f"preview frame {n}^3 {WIDTH}x{HEIGHT} (hf_frame_cast, exact, "
          f"resumed by the envelope): {ms:.3f} ms, mean "
          f"{float(img.mean()):.6f}")
    maps_rec = phase_sunmaps(renderer, cam, dev)
    phase_prefix(renderer, cam, dev)
    phase_beam_full(renderer, cam, dev)
    return counts, sky_rec, env_rec, path_rec, maps_rec


# ---- the JAX package's selectable engines: sun maps, the beam engine
# (K6, K7), the bit-grid DDA (K8) and the frame-cast prefixes ----------

# the JAX bench's beam frame (bench.py:471-489): 1920x1080, tile 8, K 64,
# 512 steps, 6 rounds
BEAM_WIDTH, BEAM_HEIGHT = 1920, 1080
BEAM_KW = dict(tile=8, K=64, max_steps=512, rounds=6)
# float operations counted in the .cu sources: K6 per expanded node (8
# cells x 3 axes of slab bounds, the emits), K7 per (ray, candidate) slab
# test, K8 per DDA step of a lane
K6_STEP_OPS, K7_PAIR_OPS, K8_STEP_OPS = 300, 40, 40
# the shadow frame against the per-ray one: share of values beyond
# atol 1e-4 (tests/test_beam.py)
SHADOW_SHARE = 1e-3


def _state_copy(state):
    return {k: v.clone() for k, v in state.items()}


def _beam_bound(K, n_c, steps, before, after, rows):
    """K6's bound for one round: the beams' bounds in (48 B); of the
    resumable state, the scalars (h, words, cap, alive: 21 B a beam) and
    the entries pending at the round's start in (a mask word for each
    level that has one, 8 B an entry: id and entry t), the elements the
    round changed out; the candidates out (lvl in every slot, off and rgb
    in the ``n_c`` used ones, ok and t_safe); each distinct 160 B aug row
    the round expands (``rows``, from the plain walk) once; and the
    expansions' float operations (``steps``, counted by the plain
    walk)."""
    import torch

    Bb = before["h"].shape[0]
    pend = before["mask_stk"]
    n_pend = int(((pend[..., None] >> torch.arange(8, device=pend.device))
                  & 1).sum())
    state_in = Bb * 21 + int((pend != 0).sum()) * 4 + n_pend * 8
    state_out = sum(int((before[k] != after[k]).sum())
                    * before[k].element_size() for k in before)
    n_rows = int(torch.unique(torch.cat(rows)).numel()) if rows else 0
    nbytes = (Bb * 48 + state_in + state_out + Bb * (K * 4 + 5) + n_c * 24
              + n_rows * 160)
    return _bound(nbytes, steps * K6_STEP_OPS)


def _resolve_bound(lvl, P):
    """K7's bound on the work the function needs: 28 B of each used
    candidate slot in (a beam's slots up to its last with lvl >= 0, of the
    beams that have any), 12 B of direction in and 41 B out a ray, and
    K7_PAIR_OPS a (ray, used slot) pair. Also the older count (every
    slot of every beam, in bytes and in pairs), for comparison."""
    import torch

    Bb, K = lvl.shape
    k = torch.arange(1, K + 1, device=lvl.device)
    n_used = int(torch.amax(torch.where(lvl >= 0, k, 0), 1).sum()) \
        if Bb else 0
    return (_bound(n_used * 28 + Bb * P * (12 + 41),
                   n_used * P * K7_PAIR_OPS),
            _bound(Bb * K * 28 + Bb * P * (12 + 41), Bb * P * K * K7_PAIR_OPS),
            n_used)


def _beam_kernels(name, world, aug, cam, dev, rounds, rec=None):
    """K6 and K7 against their plain versions on the ``rounds`` first
    rounds of the beam frame at BEAM_WIDTH x BEAM_HEIGHT: every candidate
    and the resumed state by bits, the five resolve outputs by bits, and
    the resolve into the running best of the rounds before (as the frame
    runs it) by bits against the plain version's merge. Each round's
    line: live beams, used slots, K6's and K7's ms and bounds; ``rec``
    takes the first round's times and bounds."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import beam

    H_ = world.height
    K, steps_max = BEAM_KW["K"], BEAM_KW["max_steps"]
    _, d = vcam.generate_rays(cam, BEAM_WIDTH, BEAM_HEIGHT, device=dev)
    dt = beam._group(d, 8).contiguous()
    o = torch.as_tensor(np.asarray(cam.pos, np.float32), device=dev)
    ob = o.expand(dt.shape[0], 3)
    pre = beam._beam_bounds(H_, ob, ob, torch.amin(dt, 1), torch.amax(dt, 1))
    init = beam._initial_state(world.root, H_, pre["incoherent"])
    st_k, st_p = _state_copy(init), _state_copy(init)
    Bb, P = dt.shape[:2]
    for source in ("beam_walk.cu", "beam_resolve.cu"):
        for entry, regs, props in _ptxas_regs(source):
            print(f"ptxas {source} {entry}: {regs}; {props}")
    best_k = best_p = None
    for r in range(rounds):
        start = _state_copy(st_k)
        alive = int(start["alive"].sum())
        ck = beam._beam_walk_cuda(aug, H_, pre, st_k, K, steps_max, True)
        before = beam.plain_beam_steps
        beam.plain_rows = rows = []
        t0 = time.monotonic()
        cp = beam.beam_walk_plain(aug, H_, pre, st_p, K, steps_max, True)
        torch.cuda.synchronize()
        plain_walk_ms = 1e3 * (time.monotonic() - t0)
        beam.plain_rows = None
        steps = beam.plain_beam_steps - before
        for key in ("lvl", "off", "rgb", "ok", "t_safe"):
            if not torch.equal(_bits(ck[key]), _bits(cp[key])):
                raise AssertionError(f"beam_walk {name} round {r}: {key} "
                                     "differs from the plain walk")
        for key in st_k:
            if not torch.equal(_bits(st_k[key]), _bits(st_p[key])):
                raise AssertionError(f"beam_walk {name} round {r}: state "
                                     f"{key} differs from the plain walk")
        rk = beam._resolve_cuda(ck["lvl"], ck["off"], ck["rgb"], o, dt, H_,
                                True)
        rp = beam.resolve_candidates_plain(cp["lvl"], cp["off"], cp["rgb"], o,
                                           dt, H_, True)
        for key in ("hit", "t", "normal", "rgb", "voxel"):
            if not torch.equal(_bits(rk[key]), _bits(rp[key])):
                bad = (rk[key] != rp[key]).reshape(Bb * P, -1).any(1).sum()
                raise AssertionError(f"resolve_candidates {name} round {r}: "
                                     f"{key} differs in {int(bad)} rays")
        if best_k is None:
            best_k, best_p = _state_copy(rk), _state_copy(rp)
        else:
            beam._resolve_cuda(ck["lvl"], ck["off"], ck["rgb"], o, dt, H_,
                               True, best_k)
            beam.resolve_candidates_plain(cp["lvl"], cp["off"], cp["rgb"], o,
                                          dt, H_, True, best_p)
            for key in best_p:
                if not torch.equal(_bits(best_k[key]), _bits(best_p[key])):
                    raise AssertionError(f"resolve_candidates {name} round "
                                         f"{r}: the running best's {key} "
                                         "differs from the plain merge")
        used = ck["lvl"] >= 0
        n_c = int(used.sum())
        st0 = _state_copy(start)

        def restore():
            for k in st0:
                st0[k].copy_(start[k])

        walk_ms = _ms_fresh(restore, lambda: beam._beam_walk_cuda(
            aug, H_, pre, st0, K, steps_max, True), 5)
        res_ms = _ms(lambda: beam._resolve_cuda(
            ck["lvl"], ck["off"], ck["rgb"], o, dt, H_, True), 5)
        wb, wby = _beam_bound(K, n_c, steps, start, st_p, rows)
        (rb, rby), (rb_all, rby_all), n_used = _resolve_bound(ck["lvl"], P)
        print(f"beam {name} round {r} ({Bb} beams of {P} rays, K {K}): K6 "
              f"and K7 equal to their plain versions (candidates, state, "
              f"all five resolve outputs{', the running best' * (r > 0)}); "
              f"{alive} beams alive at the start, "
              f"{int(used.any(1).sum())} with candidates, {n_c} candidate "
              f"slots used ({n_used} up to each beam's last), "
              f"{int(ck['ok'].sum())} beams done, {steps} beam-steps; K6 "
              f"{walk_ms:.4f} ms, bound {wb:.4f} ms ({wby}); K7 "
              f"{res_ms:.4f} ms, bound {rb:.4f} ms ({rby}"
              + (f"; the older count, every slot of every beam: "
                 f"{rb_all:.4f} ms, {rby_all}" if r == 0 else "")
              + f"); {CARD}")
        if rec is not None and r == 0:
            plain_res_ms = _ms(lambda: beam.resolve_candidates_plain(
                cp["lvl"], cp["off"], cp["rgb"], o, dt, H_, True), 1)
            rec["walk"].update(ms=walk_ms, plain_ms=plain_walk_ms,
                               bound_ms=wb, bound_by=wby, library_ms=None)
            rec["resolve"].update(ms=res_ms, plain_ms=plain_res_ms,
                                  bound_ms=rb, bound_by=rby, library_ms=None)
            for key in ("t", "normal", "rgb"):
                err = float((rk[key] - rp[key]).abs().max())
                rec["resolve"]["max_abs_err"] = max(
                    rec["resolve"]["max_abs_err"], err)
            print(f"beam {name} round 0: plain walk {plain_walk_ms:.1f} ms, "
                  f"plain resolve {plain_res_ms:.1f} ms")


def _beam_frames(name, world, aug, cam, dev):
    """The beam frame at BEAM_WIDTH x BEAM_HEIGHT against K2's per-ray
    cast (GRAZE_SHARE), the shadow frame against the per-ray shadow frame
    (SHADOW_SHARE); ms per frame, rounds and fallback tiles."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import beam, shade, traverse

    o, d = vcam.generate_rays(cam, BEAM_WIDTH, BEAM_HEIGHT, device=dev)
    op = np.asarray(cam.pos, np.float32)
    w = (world.table, world.root, world.height)

    def frame():
        return beam.beam_primary_frame_cast(world.table, aug, world.root,
                                            world.height, op, d, **BEAM_KW)

    r = frame()
    stats = dict(beam.last_frame_stats)
    ref = traverse.svo_raycast(*w, o, d)
    lanes, kinds = _cast_mismatch(r, ref)
    share = lanes / d[..., 0].numel()
    ms = _ms(frame, 3)
    k2_ms = _ms(lambda: traverse.svo_raycast(*w, o, d), 3)
    sun = _sun(dev)
    sb = beam.beam_shadow_frame(world.table, aug, world.root, world.height,
                                op, d, sun, tile=8, K=64, max_steps=512)
    ss = shade.svo_shadow_frame(*w, o, d, sun)
    shadow_off = float(((sb - ss).abs() > 1e-4).float().mean())
    shadow_ms = _ms(lambda: beam.beam_shadow_frame(
        world.table, aug, world.root, world.height, op, d, sun, tile=8, K=64,
        max_steps=512), 2)
    print(f"beam frame {name} {BEAM_WIDTH}x{BEAM_HEIGHT} ({BEAM_KW}): "
          f"{ms:.3f} ms a frame (K2's per-ray cast {k2_ms:.3f} ms), "
          f"{stats['rounds']} rounds, {stats['fallback_tiles']} of "
          f"{stats['tiles']} tiles ({stats['fallback_pixels']} pixels) on "
          f"the per-ray fallback; lanes off K2's cast {lanes} {kinds} "
          f"({share:.2e}, budget {GRAZE_SHARE:.2e}); shadow frame "
          f"{shadow_ms:.3f} ms, values beyond 1e-4 of the per-ray shadow "
          f"frame {shadow_off:.2e} (budget {SHADOW_SHARE:.0e}); {CARD}")
    if share > GRAZE_SHARE or shadow_off > SHADOW_SHARE \
            or not r["hit"].any() or not torch.isfinite(sb).all():
        raise AssertionError(f"the beam frame {name} disagrees with K2")


def phase_beam(space, dev):
    """The beam engine at 1024^3 (the main path's world; 853 is not a
    multiple of 8, so the frames are the JAX bench's 1920x1080): K6 and K7
    against their plain versions, the frames against K2, the CLI's
    ``render --engine beam``, then the beam frame through its entry point
    with K6 and K7's counts read around it. Returns the records and the
    counts."""
    import torch

    from voxtracer_torch.app import cli
    from voxtracer_torch.kernels import beam
    from voxtracer_torch.world import svo

    dev_svo = space.serialize()
    world = svo.upload(dev_svo.table, dev_svo.root, dev_svo.height, dev)
    t0 = time.monotonic()
    aug = torch.from_numpy(beam.build_aug_table(
        dev_svo.table, dev_svo.solid_leaf)).to(dev)
    print(f"beam 1024^3: augmented rows {tuple(aug.shape)} "
          f"({aug.numel() * 4 / 2**20:.1f} MiB) in "
          f"{time.monotonic() - t0:.2f} s")
    cam = _smoke_camera(LOG2_SIZE)
    rec = dict(walk=dict(max_abs_err=0.0), resolve=dict(max_abs_err=0.0))
    _beam_kernels("1024^3", world, aug, cam, dev, BEAM_KW["rounds"], rec)
    _beam_frames("1024^3", world, aug, cam, dev)
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp) / "beam.png"
        t0 = time.monotonic()
        cli.main(["render", "--mode", "shaded", "--engine", "beam",
                  "--log2-size", str(LOG2_SIZE), "--width", str(BEAM_WIDTH),
                  "--height", str(BEAM_HEIGHT), "--out", str(out)])
        if not out.exists():
            raise AssertionError("render --engine beam wrote no frame")
        print(f"CLI render --engine beam at 1024^3: {time.monotonic() - t0:.1f}"
              " s with the world build")
    # the beam frame through its entry point, counts read around it
    from voxtracer_torch.core import camera as vcam

    _, d = vcam.generate_rays(cam, BEAM_WIDTH, BEAM_HEIGHT, device=dev)
    torch.cuda.synchronize()
    _zero_launches()
    img = beam.beam_primary_frame(world.table, aug, world.root, world.height,
                                  np.asarray(cam.pos, np.float32), d,
                                  _sun(dev), **BEAM_KW)
    torch.cuda.synchronize()
    counts = _launches()
    print(f"beam path (beam_primary_frame, 1024^3 {BEAM_WIDTH}x"
          f"{BEAM_HEIGHT}): launches {counts}, mean {float(img.mean()):.6f}")
    _expect_launches("beam path", counts, ("beam_walk", "beam_resolve"))
    if counts["beam_walk"] != BEAM_KW["rounds"] \
            or counts["beam_resolve"] != BEAM_KW["rounds"]:
        raise AssertionError(f"the beam path launched K6 and K7 "
                             f"{counts['beam_walk']} and "
                             f"{counts['beam_resolve']} times, not once a "
                             "round")
    if not torch.isfinite(img).all() or not img.mean() > 0:
        raise AssertionError("the beam frame is empty")
    return rec, counts


def phase_beam_full(renderer, cam, dev):
    """The beam engine on the reference's 8192^3 octree at 1920x1080:
    K6 and K7 against their plain versions on the first round, the frame
    against K2."""
    import torch

    from voxtracer_torch.kernels import beam

    dev_svo = renderer._dev
    t0 = time.monotonic()
    aug = torch.from_numpy(beam.build_aug_table(
        dev_svo.table, dev_svo.solid_leaf)).to(dev)
    print(f"beam {1 << FULL_LOG2_SIZE}^3: augmented rows {tuple(aug.shape)} "
          f"({aug.numel() * 4 / 2**20:.1f} MiB) in "
          f"{time.monotonic() - t0:.2f} s")
    _beam_kernels(f"{1 << FULL_LOG2_SIZE}^3", renderer.world, aug, cam, dev,
                  1)
    _beam_frames(f"{1 << FULL_LOG2_SIZE}^3", renderer.world, aug, cam, dev)
    del aug
    torch.cuda.empty_cache()


def _bit_bound(B, n_act, steps, sectors):
    """K8's bound: rays in (28 B a live lane) and out (29 B a lane), each
    distinct 32 B sector of the pyramid the walk reads once (``sectors``,
    from the plain version), and the steps' float operations."""
    return _bound(B * 29 + n_act * 28 + sectors * 32, steps * K8_STEP_OPS)


def _bit_sets(world, dev):
    """K8's ray sets at 1024^3: camera rays, random rays, the random rays
    with 10% active, and the batch-8 NEE set from the SVO cast's camera
    hits (sun-cone directions, the hit and facing lanes active): (name,
    start, dir, active) each."""
    import torch

    from voxtracer_torch.core import sampling
    from voxtracer_torch.core.vecmath import dot
    from voxtracer_torch.kernels import traverse

    cam = _smoke_camera(LOG2_SIZE)
    o, d = _camera_rays(cam, dev)
    rng = np.random.default_rng(20261018)
    n = float(1 << world.height)
    t = lambda a: torch.as_tensor(a, device=dev).contiguous()  # noqa: E731
    start = t((rng.random((RAYS, 3), np.float32) * np.float32(n)))
    rd = rng.normal(size=(RAYS, 3)).astype(np.float32)
    rd = t(rd / np.linalg.norm(rd, axis=-1, keepdims=True))
    tenth = t(rng.random(RAYS) < 0.1)
    prim = traverse.svo_raycast(world.table, world.root, world.height, o, d)
    hit = prim["hit"]
    pos = torch.where(hit[:, None], o + d * prim["t"][:, None], o)
    state = t(rng.integers(0, 2**32, (WIDE, 3), dtype=np.uint32)
              .astype(np.int64))
    _, sun_dir = sampling.sample_sun(state, _sun(dev))
    nee = hit.repeat(8) & (dot(sun_dir, prim["normal"].repeat(8, 1)) > 0.0)
    return [("camera", o, d, None), ("random", start, rd, None),
            ("random, 10% active", start, rd, tenth),
            ("batch-8 NEE", pos.repeat(8, 1), sun_dir.contiguous(), nee)]


def phase_bitdda(space, dev):
    """The bit-grid engine at 1024^3 from the heightmap: K8 (the walker of
    bit_walk.cuh on the lane fetch) against its plain version by bits and
    against K2 on camera, random, masked (10% active) and batch-8 NEE
    sets, each timed with K2 and with its bound, ptxas's registers; K9 on
    the bit grid against the masked loop (phase_path_kernel, every lane by
    bits) on the inputs of one batch-8 render_samples(bitworld=) call;
    that call's launches (K9, not K1 or K8) and its radiance against the
    SVO engine's under the golden contract. Returns K8's record, the
    call's counts and K9's record."""
    import torch

    from voxtracer_torch.core.spectra import build_wl_to_rgb_lut
    from voxtracer_torch.kernels import bitdda, integrator, traverse
    from voxtracer_torch.world import bitgrid, svo

    dev_svo = space.serialize()
    world = svo.upload(dev_svo.table, dev_svo.root, dev_svo.height, dev)
    t0 = time.monotonic()
    grid = bitgrid.from_heightmap(np.asarray(space.heights))
    bw = grid.to_device(dev)
    gbytes = _nbytes(*bw)
    print(f"bit grid {grid.size}^3 from the heightmap: {time.monotonic() - t0:.1f}"
          f" s; top {grid.top.nbytes} B, regions {grid.regions.nbytes / 2**20:.2f}"
          f" MiB, bricks {grid.bricks.nbytes / 2**20:.1f} MiB")
    regs = _ptxas_regs("bit_dda.cu")
    for entry, n_regs, props in regs:
        print(f"ptxas K8 {entry}: {n_regs}; {props}")
    cam = _smoke_camera(LOG2_SIZE)
    rec = dict(max_abs_err=0.0, registers=regs[0][1] if regs else None)
    for name, s0, dd, act in _bit_sets(world, dev):
        far = torch.full_like(dd[:, 0], traverse.FAR)

        # the sets' flat inputs straight to the launchers: the public
        # wrappers' reshapes and fills are not the kernels' time
        def kernel():
            return bitdda._bitgrid_raycast_cuda(*bw, grid.size, s0, dd, far,
                                                True, act)

        def k2():
            return traverse._svo_raycast_cuda(world.table, world.root,
                                              world.height, s0, dd, far, True,
                                              act)

        k = kernel()
        before = bitdda.plain_lane_steps
        bitdda.plain_sectors = words = []
        p = bitdda.bitgrid_raycast_plain(*bw, grid.size, s0, dd, far, True,
                                         act)
        bitdda.plain_sectors = None
        steps = bitdda.plain_lane_steps - before
        sectors = int(torch.unique(torch.cat(words)).numel()) if words else 0
        del words
        for key in ("hit", "t", "normal", "voxel"):
            if not torch.equal(k[key], p[key]):
                bad = (k[key] != p[key]).reshape(dd.shape[0], -1).any(1).sum()
                raise AssertionError(f"bit_dda {name}: {key} differs in "
                                     f"{int(bad)} lanes")
        ref = k2()
        both = k["hit"] & ref["hit"]
        hit_off = int((k["hit"] != ref["hit"]).sum())
        t_off = int((both & ~torch.isclose(k["t"], ref["t"], rtol=1e-5,
                                           atol=2e-4)).sum())
        nv_off = int((both & ((k["voxel"] != ref["voxel"]).any(1)
                              | (k["normal"] != ref["normal"]).any(1))).sum())
        B = dd.shape[0]
        n_act = B if act is None else int(act.sum())
        off = hit_off + t_off + nv_off
        ms = _ms_fresh(lambda: None, kernel, 10)  # an event pair a call
        k2_ms = _ms_fresh(lambda: None, k2, 10)
        bound_ms, bound_by = _bit_bound(B, n_act, steps, sectors)
        line = (f"bit_dda {name} ({B} lanes, {n_act} active): all four "
                f"outputs equal to the plain version; against K2: hit "
                f"{hit_off}, t beyond rtol 1e-5 / atol 2e-4 {t_off}, voxel "
                f"or normal {nv_off} lanes (budget {GRAZE_SHARE:.2e} of the "
                f"active); K8 {ms:.4f} ms, K2 {k2_ms:.4f} ms, {steps} "
                f"lane-steps, {sectors} distinct 32 B sectors read "
                f"({sectors * 32 / 2**20:.2f} of {gbytes / 2**20:.1f} MiB), "
                f"bound {bound_ms:.4f} ms ({bound_by}) = "
                f"{100 * bound_ms / ms:.1f}% of K8's time")
        if name == "camera":
            plain_ms = _ms(lambda: bitdda.bitgrid_raycast_plain(
                *bw, grid.size, s0, dd, far), 1)
            rec.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms,
                       bound_by=bound_by, library_ms=None)
            line += f", plain {plain_ms:.1f} ms"
        print(line + f" ({CARD})")
        if off > GRAZE_SHARE * max(n_act, 1):
            raise AssertionError(f"bit_dda {name} disagrees with K2")
    # the path tracer on the bit grid: one batch-8 call, its K9 against
    # the masked loop, and its radiance against the SVO engine's
    lut = torch.from_numpy(build_wl_to_rgb_lut()).to(dev)
    seeds = np.arange(24, dtype=np.uint32).reshape(8, 3) + 7
    args = (world.table, world.root, world.height, lut,
            np.asarray(cam.pos, np.float32), cam.basis(), _sun(dev), seeds,
            WIDTH, HEIGHT)
    torch.cuda.synchronize()
    _zero_launches()
    t0 = time.monotonic()
    img = integrator.render_samples(*args, bitworld=bw, bit_size=grid.size)
    torch.cuda.synchronize()
    wall = 1e3 * (time.monotonic() - t0)
    counts = _launches()
    ref = integrator.render_samples(*args)
    a, b = (x.cpu().numpy() / 8 for x in (img, ref))
    frac = float((np.abs(a - b) > 1e-3).mean())
    mrel = float(abs(a.mean() / b.mean() - 1.0))
    print(f"bit-grid path (render_samples(bitworld=), batch 8, 1024^3 "
          f"{WIDTH}x{HEIGHT}): {wall:.1f} ms (host clock, synchronized, "
          f"first call), launches {counts}; against the SVO engine: "
          f"{frac:.2e} of values beyond 1e-3, means {mrel:.2e} apart (budget "
          f"{GOLDEN_FRAC}, {GOLDEN_MEAN_REL}); {CARD}")
    _expect_launches("bit-grid path", counts, ("path_trace",),
                     ("fog_march", "bit_dda", "svo_cast", "hf_cast"))
    if frac > GOLDEN_FRAC or mrel > GOLDEN_MEAN_REL or not np.isfinite(a).all():
        raise AssertionError("the bit-grid path disagrees with the SVO engine")
    path_rec = phase_path_kernel(
        "1024^3 bit grid", None, cam, budget=0,
        batch=lambda: integrator.render_samples(*args, bitworld=bw,
                                                bit_size=grid.size))
    return rec, counts, path_rec


def phase_sunmaps(renderer, cam, dev):
    """Sun maps at 8192^3 (hf-only, the main path's pose and sun), the
    Renderer's ``VOXT_SUNMAPS=1``: K9 with the maps against the masked
    loop with them (phase_path_kernel, every lane by bits; the maps'
    settled share among its counts); batch-8 calls with and without the
    maps equal by bits (radiance, and trace_paths' radiance and RNG
    state); the share of NEE lanes the maps prove lit from the camera
    hits; K4's NEE launch with and without the maps; ms a call. Returns
    K9's record."""
    import torch

    from voxtracer_torch.core import sampling
    from voxtracer_torch.core.spectra import fog_density
    from voxtracer_torch.core.vecmath import dot
    from voxtracer_torch.kernels import (atmosphere, heightfield, integrator,
                                         sunshadow)

    sun = _sun(dev)
    prev = os.environ.get("VOXT_SUNMAPS")
    os.environ["VOXT_SUNMAPS"] = "1"
    try:
        t0 = time.monotonic()
        maps = renderer._get_sun_maps(sun.cpu().numpy())
        build_s = time.monotonic() - t0
        if maps is None:
            raise AssertionError("the main path's sun is gated")
        path_rec = phase_path_kernel(
            f"{1 << FULL_LOG2_SIZE}^3 main path with sun maps "
            "(VOXT_SUNMAPS=1)", renderer, cam, budget=0)
    finally:
        if prev is None:
            del os.environ["VOXT_SUNMAPS"]
        else:
            os.environ["VOXT_SUNMAPS"] = prev
    if path_rec["counts"]["sun_lit"] <= 0:
        raise AssertionError("K9 settled no NEE lane by the sun maps")
    seeds = np.arange(24, dtype=np.uint32).reshape(8, 3) + 101
    kw = renderer._engine_kw(cam)
    kw.pop("sun_maps", None)
    args = (*renderer._args(cam, kw["soup"]), sun, seeds, WIDTH, HEIGHT)
    ms = {}
    for turn, m in enumerate((None, maps, maps, None)):
        w, img = _wall_ms_sync(lambda: integrator.render_samples(
            *args, **kw, sun_maps=m))
        ms.setdefault(m is None, []).append(w)
        if turn == 0:
            ref = img
        elif not torch.equal(img, ref):
            raise AssertionError("batch-8 radiance differs with the maps")
    # trace_paths' radiance and state from the camera hits
    tiles, offsets, trgb = renderer._get_hf()
    o, d = _camera_rays(cam, dev)
    rng = np.random.default_rng(20261019)
    state = torch.as_tensor(rng.integers(0, 2**32, (WIDE, 3), dtype=np.uint32)
                            .astype(np.int64), device=dev)
    wl = torch.as_tensor(rng.random(WIDE, np.float32), device=dev)
    tp = (renderer.world.table, renderer.world.root, renderer.world.height,
          renderer.lut, o.repeat(8, 1), d.repeat(8, 1), wl, sun, state)
    hkw = dict(hf_mips=tiles, hf_offsets=offsets, terrain_rgb=trgb)
    s1, c1 = integrator.trace_paths(*tp, 4, 64, **hkw)
    s2, c2 = integrator.trace_paths(*tp, 4, 64, **hkw, sun_maps=maps)
    if not torch.equal(s1, s2) or not torch.equal(c1, c2):
        raise AssertionError("trace_paths' state or radiance differs with "
                             "the maps")
    # K4's NEE launch from the camera hits, at batch-8 width
    prim = heightfield.hf_raycast(tiles, offsets, renderer.world.height,
                                  o, d)
    hit = prim["hit"].repeat(8)
    pos = torch.where(prim["hit"][:, None], o + d * prim["t"][:, None],
                      o).repeat(8, 1).contiguous()
    density = fog_density(wl)
    st, sun_dir = sampling.sample_sun(state, sun)
    facing = hit & (dot(sun_dir, prim["normal"].repeat(8, 1)) > 0.0)
    st, sp = atmosphere.raycast_planet(st, pos, sun_dir, density,
                                       active=facing)
    act = facing & ~sp["hit"]
    lit = sunshadow.sun_clear(maps, pos)
    share = float((act & lit).sum()) / max(int(act.sum()), 1)
    sun_dir = sun_dir.contiguous()
    cast = lambda a: heightfield.hf_raycast(  # noqa: E731
        tiles, offsets, renderer.world.height, pos, sun_dir, active=a)
    full = cast(act)
    part = cast(act & ~lit)
    if not torch.equal(full["hit"] & ~lit, part["hit"] & ~lit) \
            or bool((full["hit"] & lit).any()):
        raise AssertionError("a lane the maps prove lit is occluded")
    nee_ms = [_ms(lambda: cast(act), 5), _ms(lambda: cast(act & ~lit), 5),
              _ms(lambda: cast(act & ~lit), 5), _ms(lambda: cast(act), 5)]
    print(f"sun maps {1 << FULL_LOG2_SIZE}^3 (build {build_s:.1f} s host, "
          f"t_near {tuple(maps['t_near'].shape)}): batch-8 radiance and "
          f"trace_paths' radiance and state equal with and without; "
          f"{share:.4f} of {int(act.sum())} NEE lanes proved lit; K4's NEE "
          f"launch without/with/with/without {[round(x, 4) for x in nee_ms]}"
          f" ms (CUDA events); ms a batch-8 call without {ms[True]}, with "
          f"{ms[False]} (host clock, in turns; K9 both); {CARD}")
    return path_rec


def phase_prefix(renderer, cam, dev):
    """hf_frame_cast at 8192^3 with cone=, sky=, sky_env= and their
    compositions: every frame equal by bits to the unprefixed cast; ms
    per frame and per prefix."""
    import torch

    from voxtracer_torch.kernels import conemarch, heightfield, skyline

    from voxtracer_torch.render.driver import _heights

    heights = _heights(renderer._dev)
    tiles, offsets, trgb = renderer._get_hf()
    H_ = renderer.world.height
    op = np.asarray(cam.pos, np.float32)
    basis = cam.basis()
    t0 = time.monotonic()
    cone = conemarch.build_cone_mips(heights, device=dev)
    t1 = time.monotonic()
    sky_mips = skyline.build_sky_mips(heights)
    t2 = time.monotonic()
    sky = skyline.build_skyline(sky_mips, op)
    t3 = time.monotonic()
    env = renderer._get_sky_env(cam)
    print(f"prefixes {1 << H_}^3: cone pyramid {t1 - t0:.2f} s, sky pyramid "
          f"{t2 - t1:.2f} s, the pose's skyline {1e3 * (t3 - t2):.1f} ms "
          f"(host)")

    def frame(**kw):
        return heightfield.hf_frame_cast(tiles, offsets, H_, op, basis, WIDTH,
                                         HEIGHT, trgb, terrain_node=0, **kw)

    base = frame()
    lines = []
    for name, kw in (("none", {}), ("cone", dict(cone=cone)),
                     ("sky", dict(sky=sky)),
                     ("cone+sky", dict(cone=cone, sky=sky)),
                     ("sky_env", dict(sky_env=env)),
                     ("cone+sky+sky_env", dict(cone=cone, sky=sky,
                                               sky_env=env))):
        f = frame(**kw)
        for k in base:
            if not torch.equal(f[k], base[k]):
                raise AssertionError(f"hf_frame_cast({name}): {k} differs "
                                     "from the unprefixed frame")
        lines.append(f"{name} {_ms(lambda: frame(**kw), 3):.3f}")
    dc, sig, _ = conemarch.frame_tile_bundles(basis, WIDTH, HEIGHT,
                                              device=dev)
    cone_ms = _ms(lambda: conemarch.cone_prefix(cone[0], cone[1], cone[2],
                                                H_, op, dc, sig), 3)
    walk = {}
    conemarch.cone_prefix(cone[0], cone[1], cone[2], H_, op, dc, sig,
                          walk=walk)
    # the bundles in and S out once, 4 B of the pyramid a bundle-step but
    # at most the whole pyramid
    nb = dc.shape[0]
    cone_bound = _bound(nb * (12 + 12 + 4) + min(
        4 * walk["bundle_steps"], cone[0].numel() * 4),
        walk["bundle_steps"] * CONE_STEP_OPS)
    sky_ms, _ = _wall_ms_sync(lambda: skyline.tile_sky(
        sky, np.asarray(basis, np.float32), WIDTH, HEIGHT))
    mask = skyline.tile_sky(sky, np.asarray(basis, np.float32), WIDTH, HEIGHT)
    print(f"prefixes {1 << H_}^3 {WIDTH}x{HEIGHT}: every frame equal by bits "
          f"to the unprefixed cast; ms a frame {', '.join(lines)} (CUDA "
          f"events); cone_prefix alone {cone_ms:.3f} ms ({nb} bundles, "
          f"{walk['bundle_steps']} bundle-steps; bound {cone_bound[0]:.4f} ms, "
          f"{cone_bound[1]}); tile_sky {sky_ms:.2f} ms host, "
          f"{int(mask.sum())} of {mask.size} tiles certified; {CARD}")


def phase_terrain_card(dev):
    """The terrain on the card against the CPU's: worldgen.heightmap at
    2^10 and 2^13, equal by bits."""
    from voxtracer_torch.world import worldgen

    for log2 in (LOG2_SIZE, FULL_LOG2_SIZE):
        t0 = time.monotonic()
        a = worldgen.heightmap(log2, device=dev)
        t1 = time.monotonic()
        b = worldgen.heightmap(log2, device="cpu")
        t2 = time.monotonic()
        same = np.array_equal(a, b)
        print(f"terrain {1 << log2}^2: the card's heightmap against the "
              f"CPU's: equal by bits {same} (card {t1 - t0:.2f} s, CPU "
              f"{t2 - t1:.2f} s)")
        if not same:
            raise AssertionError(f"the {1 << log2}^2 heightmap differs "
                                 "between the card and the CPU")


def main() -> int:
    global CARD
    import torch

    CARD = phase_card()
    phase_build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)

    from voxtracer_torch.kernels import raster
    from voxtracer_torch.world import boxes, svo, worldgen

    t0 = time.monotonic()
    space = worldgen.generate(log2_size=LOG2_SIZE, verbose=False,
                              backend="native", device=dev)
    dev_svo = space.serialize()
    world = svo.upload(dev_svo.table, dev_svo.root, dev_svo.height, dev)
    t1 = time.monotonic()
    soup = boxes.extract_boxes(dev_svo)
    soup_t = raster.soup_to_device(soup.lo, soup.size, soup.leaf, soup.rgb,
                                   dev)
    print(f"worldgen 1024^3 (native): {t1 - t0:.1f} s, "
          f"{dev_svo.table.shape[0]} nodes; box soup {len(soup)} boxes in "
          f"{time.monotonic() - t1:.1f} s")

    fog_rec = phase_fog(rng, dev)
    sets = _svo_sets(rng, world, dev)
    svo_rec = phase_svo(sets, world)
    hf_rec, pack = phase_hf(rng, sets, world, space, dev)
    del sets
    res_rec = phase_resolve(rng, soup_t, dev)
    phase_golden(dev)
    phase_api(dev)
    phase_shaded(soup_t, world, pack, dev)
    counts, svo_counts, soup_r, svo_r, path_recs = phase_main(space, dev)
    phase_primaries(soup_r, svo_r)
    del soup_r, svo_r
    phase_engines(space, dev)
    phase_cull(space, soup_t, world, dev)
    phase_primary_engines(space, dev)
    phase_dist(space, dev)
    beam_rec, beam_counts = phase_beam(space, dev)
    bit_rec, bit_counts, bit_path = phase_bitdda(space, dev)
    path_recs.append(bit_path)
    path_recs.append(phase_edits(space, dev)[1])
    del space, dev_svo, world, soup, soup_t, pack
    torch.cuda.empty_cache()
    phase_interact(dev)
    phase_dense(dev)
    phase_terrain_card(dev)
    torch.cuda.empty_cache()
    full, sky_rec, env_rec, main_path, maps_path = phase_full(dev)
    path_recs[:0] = [main_path, maps_path]
    _path_summary(path_recs)

    kernels = [
        dict(name="fog_march", route="cuda",
             source="voxtracer_torch/kernels/csrc/fog_march.cu",
             replaces="voxtracer/kernels/pallas/fog.py:40",
             launches=full["fog_march"], **fog_rec),
        dict(name="svo_cast", route="cuda",
             source="voxtracer_torch/kernels/csrc/svo_cast.cu",
             replaces="voxtracer/kernels/traverse.py:117",
             launches=svo_counts["svo_cast"], **svo_rec),
        dict(name="resolve_fold", route="cuda",
             source="voxtracer_torch/kernels/csrc/resolve_fold.cu",
             replaces="voxtracer/kernels/pallas/resolve.py:44",
             launches=counts["resolve_fold"], **res_rec),
        dict(name="hf_cast", route="cuda",
             source="voxtracer_torch/kernels/csrc/hf_cast.cu",
             replaces="voxtracer/kernels/heightfield.py:206",
             launches=full["hf_cast"], **hf_rec),
        dict(name="sky_tmin", route="cuda",
             source="voxtracer_torch/kernels/csrc/sky_tmin.cu",
             replaces="voxtracer/kernels/skyline.py:441",
             launches=full["sky_tmin"], **sky_rec),
        dict(name="sky_env", route="cuda",
             source="voxtracer_torch/kernels/csrc/sky_env.cu",
             replaces="voxtracer/kernels/skyline.py:648",
             launches=full["env_build"], **env_rec),
        dict(name="beam_walk", route="cuda",
             source="voxtracer_torch/kernels/csrc/beam_walk.cu",
             replaces="voxtracer/kernels/beam.py:94",
             launches=beam_counts["beam_walk"], **beam_rec["walk"]),
        dict(name="beam_resolve", route="cuda",
             source="voxtracer_torch/kernels/csrc/beam_resolve.cu",
             replaces="voxtracer/kernels/beam.py:369",
             launches=beam_counts["beam_resolve"], **beam_rec["resolve"]),
        dict(name="bit_dda", route="cuda",
             source="voxtracer_torch/kernels/csrc/bit_dda.cu",
             replaces="voxtracer/kernels/bitdda.py:44",
             launches=bit_counts["bit_dda"], **bit_rec),
        dict(name="path_trace", route="cuda",
             source="voxtracer_torch/kernels/csrc/path_trace.cu",
             replaces="voxtracer/kernels/integrator.py:212",
             launches=full["path_trace"], **main_path["record"],
             stages=[dict(name=k, ms=v["ms"], launches=v["launches"])
                     for k, v in main_path["stages"].items()],
             engines=[dict(name=rec["name"], launches=rec["launches"],
                           **rec["record"]) for rec in path_recs[1:]]),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:
        traceback.print_exc()
        sys.exit(1)
