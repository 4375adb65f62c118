"""Terminal interactive session: the fly-camera and editor counterpart of
the reference's winit app (main.rs:149-309), the port of
``voxtracer/app/interactive.py``. A live progressive loop renders one
sample a tick into a preview PNG (the reference renders one sample a
frame, main.rs:164-208), shows FPS from the same 250-frame ring buffer
(main.rs:179-189), and polls stdin without blocking, so edits take
effect within one sample interval.

Commands (reference keys in parens):
  w/a/s/d N   move forward/left/back/right N voxels (WASD fly movement)
  up/down N   vertical movement (Space/Shift)
  look DY DP  adjust yaw/pitch in radians (mouse look, main.rs:295-308)
  fast        toggle 100x speed (Ctrl, main.rs:94-97)
  g           teleport up by world_size/8 (G key's +100000, main.rs:251-253)
  r           step the sun along the day arc by 0.05 (R key, main.rs:254-263)
  del         delete the block under the crosshair (left click)
  place       place an emissive white block on the face under the
              crosshair (right click -> [1.0; 3], main.rs:281-284)
  pose        print the camera pose (Esc print, main.rs:241)
  spp N       set the preview refresh cadence (samples between writes)
  save PATH   save the current accumulation as PNG
  q           quit

Picking casts the view-centre ray with ``svo_raycast(..., skip_t0=False)``
(K2 on the card) against the Renderer's node table, which
``apply_edits`` keeps current; the reference casts the same ray on the
CPU (software::raycast, main.rs:273), and the JAX package re-serializes
the whole space for every pick.

With ``input_fn`` given (tests), the session is scripted instead of live:
commands are consumed back to back with one progressive sample after
each; an ``input_fn`` returning None is an idle tick (no input pending),
the live loop's continuous accumulation.

Idle cadence (main.rs:164-208 presents a sample every frame): while no
input is pending the loop keeps accumulating path-traced samples, and the
preview PNG refreshes on a time cadence (``preview_interval``, 100 ms) as
well as the sample-count one, so the session always shows the freshest
accumulation the sample rate allows.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.kernels.traverse import svo_raycast
from voxtracer_torch.utils.profiling import spanned


def _stdin_poller():
    """Non-blocking stdin line poller (None = no input yet)."""
    import select
    import sys

    def poll():
        ready, _, _ = select.select([sys.stdin], [], [], 0.0)
        if not ready:
            return None
        line = sys.stdin.readline()
        if line == "":
            raise EOFError
        return line

    return poll


@spanned("vt:pick")
def center_pick(world, pos, yaw: float, pitch: float):
    """The block under the crosshair: ``(voxel, normal)`` int64 arrays of
    the view-centre ray's first hit in ``world`` (a ``DeviceWorld``), or
    None for a miss. The ray starts at ``pos`` and hits at t == 0 count."""
    basis = vcam.camera_basis(yaw, pitch)
    dev = world.table.device
    start = torch.as_tensor(np.asarray(pos, np.float32)[None], device=dev)
    d = basis[:, 2][None].to(dev)
    r = svo_raycast(world.table, world.root, world.height, start, d,
                    skip_t0=False)
    if not bool(r["hit"][0]):
        return None
    return (r["voxel"][0].cpu().numpy().astype(np.int64),
            r["normal"][0].cpu().numpy().astype(np.int64))


def run_interactive(args, input_fn=None, log=print,
                    preview_interval: float = 0.1, device="cuda"):
    """The session for the CLI's ``interact`` arguments on ``device`` (the
    card by default; without one this raises; tests pass "cpu")."""
    from voxtracer_torch.app import cli
    from voxtracer_torch.render import film
    from voxtracer_torch.render.driver import Renderer, rotate_sun
    from voxtracer_torch.utils.profiling import FrameTimer

    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the session "
                           "renders on a CUDA card unless device='cpu'")
    space = cli._build_world(args, log=log, device=device)
    cam = cli._camera(args)
    pos = np.asarray(cam.pos, np.float64)
    yaw, pitch = cam.yaw, cam.pitch
    sun = np.asarray(args.sun, np.float64)
    sun /= np.linalg.norm(sun)
    renderer = Renderer(space.serialize(), args.width, args.height,
                        max_bounces=args.max_bounces,
                        fog_steps=args.fog_steps, seed=args.seed,
                        device=device, devices=cli._devices(args, device))
    refresh_every = max(args.spp, 1)
    fast = False
    preview = "preview.png"
    scripted = input_fn is not None
    poll = None if scripted else _stdin_poller()
    timer = FrameTimer()
    last_write = [0.0]  # monotonic time of the last preview write

    def sample_once():
        renderer.sample(vcam.Camera(pos=tuple(pos), yaw=yaw, pitch=pitch),
                        sun)
        timer.tick()

    def write_preview():
        renderer.save_png(preview)
        last_write[0] = time.monotonic()
        log(f"[{renderer.acc.samples} samples | {timer.fps:.1f} fps] "
            f"-> {preview}")

    def idle_tick():
        """One live-loop tick with no input pending: a path-traced sample,
        and the preview on the time cadence (module doc)."""
        sample_once()
        if (renderer.acc.samples % refresh_every == 0
                or time.monotonic() - last_write[0] >= preview_interval):
            write_preview()

    def fast_preview():
        """The shaded rasterized (or heightfield) frame right after a
        camera or world change; idle ticks then refine the path-traced
        accumulation."""
        c = vcam.Camera(pos=tuple(pos), yaw=yaw, pitch=pitch)
        img = renderer.preview_frame(c, sun)
        if img is None:
            return False
        film.save_png(preview, img.cpu().numpy())
        timer.tick()
        log(f"[raster preview | {timer.fps:.1f} fps] -> {preview}")
        return True

    sample_once()
    write_preview()
    while True:
        if scripted:
            try:
                line = input_fn("> ")
            except (EOFError, StopIteration):
                return
        else:
            try:
                line = poll()
            except EOFError:
                return
        if line is None:  # no input pending (module doc)
            idle_tick()
            continue

        line = line.strip()
        if not line:
            write_preview()
            continue
        parts = line.split()
        cmd, rest = parts[0].lower(), parts[1:]
        speed = 1000.0 if fast else 10.0
        basis = vcam.camera_basis(yaw, 0.0).numpy()
        fwd = basis @ np.array([0.0, 0.0, 1.0])
        right = basis @ np.array([1.0, 0.0, 0.0])

        def amt():
            return float(rest[0]) if rest else speed

        if cmd == "q":
            return
        elif cmd == "w":
            pos += fwd * amt()
        elif cmd == "s":
            pos -= fwd * amt()
        elif cmd == "a":
            pos -= right * amt()
        elif cmd == "d":
            pos += right * amt()
        elif cmd == "up":
            pos[1] += amt()
        elif cmd == "down":
            pos[1] -= amt()
        elif cmd == "look" and len(rest) >= 2:
            yaw += float(rest[0])
            pitch = float(np.clip(pitch + float(rest[1]), -np.pi / 2,
                                  np.pi / 2))
        elif cmd == "fast":
            fast = not fast
            log(f"fast={'on' if fast else 'off'}")
        elif cmd == "g":
            pos[1] += (1 << args.log2_size) / 8.0
        elif cmd == "r":
            sun = rotate_sun(sun, 0.05)
            log(f"sun={sun}")
        elif cmd in ("del", "place"):
            picked = center_pick(renderer.world, pos, yaw, pitch)
            if picked is None:
                log("no block under crosshair")
            else:
                voxel, normal = picked
                if cmd == "del":
                    edited = tuple(int(c) for c in voxel)
                    space.set(edited, None)
                    log(f"deleted {edited}")
                elif not all(0 <= int(c) < (1 << space.height())
                             for c in voxel + normal):
                    # a block on a world-boundary face would land outside
                    # [0, 2^height)
                    log("placement outside world bounds")
                    continue
                else:
                    edited = tuple(int(c) for c in voxel + normal)
                    space.set(edited, (1.0, 1.0, 1.0))
                    log(f"placed emissive block at {edited}")
                # the changed table rows and an in-place soup patch
                renderer.apply_edits(space, edits=[edited])
        elif cmd == "pose":
            log(f"pos={tuple(pos)} yaw={yaw} pitch={pitch}")
            continue
        elif cmd == "spp":
            refresh_every = max(int(rest[0]), 1)
            continue
        elif cmd == "save" and rest:
            renderer.save_png(rest[0])
            log(f"wrote {rest[0]}")
            continue
        else:
            log("commands: w/a/s/d/up/down [N], look DY DP, fast, g, r, "
                "del, place, pose, spp N, save PATH, q")
            continue
        # the state changed: an immediate preview, then one path-traced
        # sample at the new state (the accumulator restarts itself on a
        # pose, sun or world change; idle ticks keep refining)
        fast_preview()
        sample_once()
        write_preview()
