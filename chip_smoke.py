#!/usr/bin/env python3
"""Smoke run of the PyTorch port (voxtracer_torch) on one NVIDIA card.

    python3 chip_smoke.py        # from the repository root; needs nvcc

Phases, each printing its lines; any failure exits non-zero:

1. card: fails unless torch sees a CUDA device; prints nvidia-smi's name
   and power limit.
2. build: compiles kernels K1 (fog march) and K2 (SVO cast) from
   voxtracer_torch/kernels/csrc with nvcc and loads them.
3. kernels against their plain PyTorch versions, on the card, at the main
   path's shapes, every output bit for bit: K1 at 409,440 rays (one
   853x480 sample) and at ragged sizes, K2 on a 1024^3 world with camera
   rays, random rays with random caps, and a random active mask. Times
   both with CUDA events.
4. golden: the 64^3 fixed-seed path sample of tests/test_golden.py,
   rendered on the card, against tests/golden/path_sample_64w.npy.
5. main path: worldgen at 1024^3, Renderer at 853x480 and headless_run
   for 2 frames x 16 samples in batches of 8. Both kernels' launch counts
   in that run must be > 0, and no sample may be retried.

The line before the last is the per-kernel JSON record; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
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
RAYS = WIDTH * HEIGHT  # 409,440 paths per sample
# golden contract (tests/test_torch_integrator.py): fraction of values
# beyond 1e-3, and the relative difference of the image means
GOLDEN_FRAC, GOLDEN_MEAN_REL = 5e-3, 1e-3


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


def phase_fog(rng, dev):
    """K1 against fog_march_plain; returns the JSON record fields."""
    import torch

    from voxtracer_torch.kernels import fog

    rec = dict(max_abs_err=0.0)
    for B, steps in [(b, s) for b in (RAYS, 1, 100, 1000) for s in (64, 16)]:
        args = _fog_inputs(rng, B, dev)
        code_k, t_k = fog.fog_march(*args, n_steps=steps)
        code_p, t_p = fog.fog_march_plain(*args, n_steps=steps)
        torch.cuda.synchronize()
        if not torch.equal(code_k, code_p):
            n = int((code_k != code_p).sum())
            raise AssertionError(f"fog_march B={B} n={steps}: {n} codes differ")
        # both sides build without FMA contraction and in one expression
        # order, so t is held bit for bit, as K2's outputs are
        err = float((t_k - t_p).abs().max())
        if not torch.equal(t_k, t_p):
            raise AssertionError(f"fog_march B={B} n={steps}: t differs, "
                                 f"max diff {err}")
        rec["max_abs_err"] = max(rec["max_abs_err"], err)
        line = f"fog_march B={B} n_steps={steps}: codes and t equal"
        if B == RAYS:
            ms = _ms(lambda: fog.fog_march(*args, n_steps=steps), 20)
            plain_ms = _ms(lambda: fog.fog_march_plain(*args, n_steps=steps), 3)
            line += f", kernel {ms:.4f} ms, plain {plain_ms:.4f} ms"
            if steps == 64:  # the production march
                rec.update(ms=ms, plain_ms=plain_ms)
        print(line)
    return rec


def _svo_sets(rng, dev):
    """The three K2 ray sets as (name, start, d, distance, active), each
    flat over 409,440 lanes."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels.traverse import FAR

    n = float(1 << LOG2_SIZE)
    s = n / 8192.0
    cam = vcam.Camera(pos=tuple(np.asarray(vcam.DEFAULT_POSE.pos) * s),
                      yaw=vcam.DEFAULT_POSE.yaw, pitch=vcam.DEFAULT_POSE.pitch)
    o, d = vcam.generate_rays(cam, WIDTH, HEIGHT, device=dev)
    t = lambda a: torch.as_tensor(a, device=dev).contiguous()  # noqa: E731
    far = torch.full((RAYS,), FAR, dtype=torch.float32, device=dev)
    start = rng.random((RAYS, 3), np.float32) * np.float32(n)
    rd = rng.normal(size=(RAYS, 3)).astype(np.float32)
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    cap = np.where(rng.random(RAYS) < 0.25, np.float32(FAR),
                   rng.random(RAYS, np.float32) * np.float32(2 * n))
    active = rng.random(RAYS) < 0.5
    rand = (t(start), t(rd), t(cap.astype(np.float32)))
    return [
        ("camera", t(o.reshape(-1, 3)), t(d.reshape(-1, 3)), far, None),
        ("random", *rand, None),
        ("active", *rand, t(active)),
    ]


def phase_svo(rng, world, dev):
    """K2 against svo_raycast_plain, all five outputs bit for bit."""
    import torch

    from voxtracer_torch.kernels import traverse

    rec = dict(max_abs_err=0.0)
    w = (world.table, world.root, world.height)
    for name, start, d, distance, active in _svo_sets(rng, dev):
        def kernel():
            return traverse.svo_raycast(*w, start, d, distance, active=active)

        def plain():
            return traverse.svo_raycast_plain(*w, start, d, distance,
                                              active=active)

        k, p = kernel(), plain()
        torch.cuda.synchronize()
        for key in ("hit", "t", "node", "normal", "voxel"):
            if not torch.equal(k[key], p[key]):
                bad = (k[key] != p[key]).reshape(RAYS, -1).any(1).sum()
                raise AssertionError(f"svo_cast {name}: {key} differs in "
                                     f"{int(bad)} lanes")
        for key in ("t", "normal"):
            err = float((k[key] - p[key]).abs().max())
            rec["max_abs_err"] = max(rec["max_abs_err"], err)
        ms = _ms(kernel, 10)
        plain_ms = _ms(plain, 1)
        hits = float(p["hit"].float().mean())
        print(f"svo_cast {name} ({RAYS} rays, {hits:.3f} hit): all five "
              f"outputs equal, kernel {ms:.4f} ms, plain {plain_ms:.4f} ms")
        if name == "random":  # incoherent capped rays, like bounce casts
            rec.update(ms=ms, plain_ms=plain_ms)
    return rec


def phase_golden(dev):
    """tests/test_golden.py's path sample, rendered on the card."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.core.spectra import build_wl_to_rgb_lut
    from voxtracer_torch.kernels.integrator import render_sample
    from voxtracer_torch.world import svo, worldgen

    dev_svo = worldgen.generate(log2_size=6, verbose=False,
                                device=dev).serialize()
    w = svo.upload(dev_svo.table, dev_svo.root, dev_svo.height, dev)
    s = 64 / 8192
    cam = vcam.Camera(pos=tuple(np.asarray(vcam.DEFAULT_POSE.pos) * s),
                      yaw=vcam.DEFAULT_POSE.yaw, pitch=vcam.DEFAULT_POSE.pitch)
    sun = np.asarray([0.8, 10.2743, 3.7])
    sun = torch.as_tensor((sun / np.linalg.norm(sun)).astype(np.float32))
    lut = torch.as_tensor(build_wl_to_rgb_lut(256), device=dev)
    img = render_sample(w.table, w.root, w.height, lut,
                        np.asarray(cam.pos, np.float32), cam.basis(), sun,
                        np.array([101, 202, 303], np.uint32), 96, 56,
                        max_bounces=4, fog_steps=16).cpu().numpy()
    want = np.load(REPO / "tests" / "golden" / "path_sample_64w.npy")
    frac = float((np.abs(img - want) > 1e-3).mean())
    mean_rel = abs(float(img.mean()) / float(want.mean()) - 1.0)
    print(f"golden path_sample_64w on the card: {frac:.6f} of values beyond "
          f"1e-3 (limit {GOLDEN_FRAC}), means {img.mean():.6f} vs "
          f"{want.mean():.6f} (rel {mean_rel:.2e}, limit {GOLDEN_MEAN_REL})")
    if not np.isfinite(img).all() or frac > GOLDEN_FRAC \
            or mean_rel > GOLDEN_MEAN_REL:
        raise AssertionError("golden path sample not reproduced on the card")


def phase_main(space, dev):
    """The headless day-cycle at 1024^3, 853x480; returns launch counts."""
    import torch

    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import fog, traverse
    from voxtracer_torch.render import film
    from voxtracer_torch.render.driver import Renderer, headless_run

    s = (1 << LOG2_SIZE) / 8192.0
    cam = vcam.Camera(pos=tuple(np.asarray(vcam.DEFAULT_POSE.pos) * s),
                      yaw=vcam.DEFAULT_POSE.yaw, pitch=vcam.DEFAULT_POSE.pitch)
    renderer = Renderer(space.serialize(), WIDTH, HEIGHT, seed=0, device=dev)
    lines = []
    frames, frame_samples, batch = 2, 16, 8
    with tempfile.TemporaryDirectory() as tmp:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        fog.launches = 0
        traverse.launches = 0
        t0 = time.monotonic()
        headless_run(renderer, cam, out_dir=tmp, frame_samples=frame_samples,
                     max_frames=frames, batch=batch, log=lines.append)
        torch.cuda.synchronize()
        wall = time.monotonic() - t0
        counts = dict(fog_march=fog.launches, svo_cast=traverse.launches)
        peak = torch.cuda.max_memory_allocated()
        exrs = sorted(Path(tmp).glob("*.exr"))
        imgs = [film.load_exr(p)[..., :3] for p in exrs]
    for line in lines:
        print(f"  headless: {line.strip()}")
    retries = sum("sample failed" in line for line in lines)
    samples = frames * frame_samples
    print(f"main path: {frames} frames x {frame_samples} samples at "
          f"{WIDTH}x{HEIGHT}, 1024^3: {samples / wall:.3f} paths/px/s, "
          f"{1e3 * wall / samples:.2f} ms/sample (wall, EXR writes "
          f"included), peak {peak / 2**20:.1f} MiB, launches {counts}")
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
    for name, n in counts.items():
        if n <= 0:
            raise AssertionError(f"{name} was not launched on the main path")
    return counts


def main() -> int:
    import torch

    phase_card()
    phase_build()
    dev = torch.device("cuda")
    rng = np.random.default_rng(20261016)

    from voxtracer_torch.world import svo, worldgen

    t0 = time.monotonic()
    space = worldgen.generate(log2_size=LOG2_SIZE, verbose=False, device=dev)
    dev_svo = space.serialize()
    world = svo.upload(dev_svo.table, dev_svo.root, dev_svo.height, dev)
    print(f"worldgen 1024^3: {time.monotonic() - t0:.1f} s, "
          f"{dev_svo.table.shape[0]} nodes")

    fog_rec = phase_fog(rng, dev)
    svo_rec = phase_svo(rng, world, dev)
    phase_golden(dev)
    counts = phase_main(space, dev)

    kernels = [
        dict(name="fog_march", route="cuda",
             source="voxtracer_torch/kernels/csrc/fog_march.cu",
             replaces="voxtracer/kernels/pallas/fog.py:40",
             launches=counts["fog_march"], **fog_rec),
        dict(name="svo_cast", route="cuda",
             source="voxtracer_torch/kernels/csrc/svo_cast.cu",
             replaces="voxtracer/kernels/traverse.py:117",
             launches=counts["svo_cast"], **svo_rec),
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
