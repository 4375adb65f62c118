"""voxtracer_torch command-line interface.

Subcommands, with the flags and defaults of ``voxtracer/app/cli.py``:

* ``render --mode path`` — render one path-traced frame to PNG and/or EXR.
* ``render --mode shaded|shadow --engine raster|beam|ray`` — one
  deterministic shaded frame (kernels/shade.py): ``shaded`` on the box
  rasterizer (default), the beam engine (kernels/beam.py, K6 and K7) or
  the per-ray SVO cast; ``shadow`` on the beam engine or the SVO cast. The
  beam engine takes frames whose width and height are multiples of 8, as
  in the JAX package; other sizes render per ray. Prints which engine
  rendered the frame and its milliseconds on the card.
* ``headless`` — the day-cycle batch job: N samples per frame, EXR dump,
  sun schedule, throughput prints (main.rs:112-145); ``--checkpoint-every
  N`` snapshots the render state. ``--log2-size 13`` is the reference's
  8192^3 world: built by the native builder (needs ``g++``), rendered on
  the heightfield engine with no box soup.
* ``combine`` — average frames/*.exr across iters into movie/*.png
  (main.rs:312-370).
* ``interact`` — the terminal fly camera and block editor
  (app/interactive.py), commands on stdin.

``render --mode shaded --engine raster`` rasterizes the pose's
frustum-culled view of the soup (world/active.py) above
``ACTIVE_SOUP_THRESHOLD`` boxes.
``render``, ``headless`` and ``interact`` run on the CUDA card and refuse
to start without one; the library's ``Renderer(..., device="cpu")`` and
``run_interactive(..., device="cpu")`` are the CPU path. ``--devices N``
(``render --mode path``, ``headless``, ``interact``) shards each sample
step over the first N cards (dist/shard.py); more than the machine has is
an error.

Run: ``python -m voxtracer_torch.app.cli headless --max-frames 1``.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

# above this box count, shaded raster frames take the frustum-culled view
# (world/active.py) instead of the whole soup
ACTIVE_SOUP_THRESHOLD = 4_000_000


def _add_common(p):
    p.add_argument("--log2-size", type=int, default=10,
                   help="world edge = 2^log2_size voxels (reference: 13)")
    p.add_argument("--seed-scale", type=lambda s: int(s, 0),
                   default=0xAFE29979, help="scale-noise seed")
    p.add_argument("--seed-noise", type=lambda s: int(s, 0),
                   default=0x1C766E2E, help="fBm noise seed")
    p.add_argument("--width", type=int, default=853)
    p.add_argument("--height", type=int, default=480)
    p.add_argument("--pos", type=float, nargs=3, default=None,
                   help="camera position (default: reference pose scaled "
                        "to world size)")
    p.add_argument("--yaw", type=float, default=-5.3800497)
    p.add_argument("--pitch", type=float, default=0.21999985)
    p.add_argument("--sun", type=float, nargs=3, default=(0.8, 10.2743, 3.7))
    p.add_argument("--max-bounces", type=int, default=24)
    p.add_argument("--fog-steps", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--devices", type=int, default=None,
                   help="shard path-traced sampling over the first N CUDA "
                        "cards (sample sharding, one sum per step); more "
                        "than the machine has is an error")
    p.add_argument("--noise-device", choices=("cpu", "default"),
                   default="default",
                   help="where worldgen evaluates the heightmap's noise: "
                        "'cpu', or 'default' for the card the session "
                        "renders on (the default here: the noise is plain "
                        "PyTorch with no compile step, so the card is "
                        "fastest; the JAX package defaults to 'cpu' because "
                        "its one-shot compiles cost more than a host eval)")


def _device():
    if not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false: the CLI "
                           "renders on a CUDA card")
    return "cuda"


def _devices(args, device):
    """The Renderer's ``devices`` for ``--devices N``: N cards (the mesh
    raises when fewer exist), or N shards of a CPU session."""
    n = args.devices
    if n is None or n <= 1:
        return None
    return ["cpu"] * n if torch.device(device).type == "cpu" else n


def _build_world(args, log=print, device=None):
    """The terrain world, its noise on the CPU or on ``device`` (the
    card when None) as ``--noise-device`` says."""
    from voxtracer_torch.world import worldgen

    if args.noise_device == "cpu":
        device = "cpu"
    elif device is None:
        device = _device()
    t0 = time.monotonic()
    space = worldgen.generate(log2_size=args.log2_size,
                              seed_scale=args.seed_scale,
                              seed_noise=args.seed_noise,
                              device=device)
    log(f"worldgen total {time.monotonic() - t0:.2f}s")
    return space


def _camera(args):
    from voxtracer_torch.core import camera as vcam

    if args.pos is None:
        s = (1 << args.log2_size) / 8192.0
        pos = tuple(np.asarray(vcam.DEFAULT_POSE.pos) * s)
    else:
        pos = tuple(args.pos)
    return vcam.Camera(pos=pos, yaw=args.yaw, pitch=args.pitch)


def _renderer(args, space):
    from voxtracer_torch.render.driver import Renderer

    dev = _device()
    return Renderer(space.serialize(), args.width, args.height,
                    max_bounces=args.max_bounces, fog_steps=args.fog_steps,
                    seed=args.seed, device=dev, devices=_devices(args, dev))


def cmd_render(args):
    if args.mode != "path":
        return _render_shaded(args)
    space = _build_world(args)
    cam = _camera(args)
    r = _renderer(args, space)
    t0 = time.monotonic()
    r.render(cam, np.asarray(args.sun, np.float64), args.spp)
    dt = time.monotonic() - t0
    spp = r.acc.samples  # with --devices, whole steps of N samples
    print(f"{spp} spp in {dt:.2f}s = "
          f"{spp * args.width * args.height / dt / 1e6:.2f} Mpaths/s")
    if args.out:
        r.save_png(args.out)
        print("wrote", args.out)
    if args.exr:
        r.save_exr(args.exr)
        print("wrote", args.exr)


def _render_shaded(args):
    """One deterministic frame; the time is that of a second call, after
    a first one that builds the kernels and warms the allocator."""
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import raster, shade
    from voxtracer_torch.render import film
    from voxtracer_torch.world import boxes
    from voxtracer_torch.world.svo import upload

    dev = _device()
    space = _build_world(args)
    cam = _camera(args)
    sdev = space.serialize()
    w = upload(sdev.table, sdev.root, sdev.height, dev)
    o, d = vcam.generate_rays(cam, args.width, args.height, device=dev)
    sun = np.asarray(args.sun, np.float64)
    sun_t = torch.as_tensor((sun / np.linalg.norm(sun)).astype(np.float32),
                            device=dev)
    engine = "ray"
    if args.engine == "raster" and args.mode == "shaded":
        engine = "raster"
        soup = boxes.extract_boxes(sdev)
        print(f"box soup: {len(soup)} boxes")
        soup_t = raster.soup_to_device(soup.lo, soup.size, soup.leaf, soup.rgb,
                                       dev)
        if len(soup) > ACTIVE_SOUP_THRESHOLD:
            from voxtracer_torch.world.active import ActiveSoup

            act = ActiveSoup(soup_t, args.width, args.height)
            soup_t = act.active(cam.pos, cam.basis())
            print(f"active set: {act.n_active} boxes")

        def frame():
            return raster.raster_primary_frame(
                *soup_t, w.height, np.asarray(cam.pos, np.float32),
                cam.basis(), sun_t, args.width, args.height, table=w.table,
                root=w.root)
    elif args.engine == "beam" and args.height % 8 == 0 \
            and args.width % 8 == 0:
        from voxtracer_torch.kernels import beam

        engine = "beam"
        aug = torch.from_numpy(beam.build_aug_table(
            sdev.table, sdev.solid_leaf)).to(dev)
        frame_fn = (beam.beam_primary_frame if args.mode == "shaded"
                    else beam.beam_shadow_frame)

        def frame():
            return frame_fn(w.table, aug, w.root, w.height,
                            np.asarray(cam.pos, np.float32), d, sun_t)
    elif args.mode == "shaded":
        def frame():
            return shade.svo_primary_frame(w.table, w.root, w.height, o, d,
                                           sun_t)
    else:  # shadow
        def frame():
            return shade.svo_shadow_frame(w.table, w.root, w.height, o, d,
                                          sun_t)
    frame()
    torch.cuda.synchronize()
    t0 = time.monotonic()
    img = frame()
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    rays = args.width * args.height * (1 if args.mode == "shaded" else 2)
    print(f"{engine} engine: frame in {dt * 1e3:.1f} ms = "
          f"{rays / dt / 1e6:.2f} Mrays/s")
    if args.out:
        film.save_png(args.out, img.cpu().numpy())
        print("wrote", args.out)


def cmd_headless(args):
    from voxtracer_torch.render.driver import headless_run

    space = _build_world(args)
    cam = _camera(args)
    r = _renderer(args, space)
    headless_run(r, cam, out_dir=args.frames_dir,
                 frame_samples=args.frame_samples,
                 sun_start=np.asarray(args.sun, np.float64),
                 max_iters=args.iters, max_frames=args.max_frames,
                 checkpoint_every=args.checkpoint_every,
                 checkpoint_path=args.checkpoint_path)


def cmd_combine(args):
    from voxtracer_torch.render.driver import combine

    combine(args.frames_dir, args.movie_dir)


def cmd_interact(args):
    from voxtracer_torch.app.interactive import run_interactive

    run_interactive(args, device=_device())


def build_parser():
    ap = argparse.ArgumentParser(prog="voxtracer_torch")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("render", help="render one frame")
    _add_common(p)
    p.add_argument("--mode", choices=("path", "shaded", "shadow"),
                   default="path")
    p.add_argument("--engine", choices=("raster", "beam", "ray"),
                   default="raster",
                   help="primary-visibility engine for --mode shaded")
    p.add_argument("--spp", type=int, default=16)
    p.add_argument("--out", default="frame.png")
    p.add_argument("--exr", default=None)
    p.set_defaults(fn=cmd_render)

    p = sub.add_parser("headless", help="day-cycle batch render")
    _add_common(p)
    p.add_argument("--frames-dir", default="frames")
    p.add_argument("--frame-samples", type=int, default=1000)
    p.add_argument("--iters", type=int, default=1)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--checkpoint-every", type=int, default=None,
                   help="snapshot the render state every N samples")
    p.add_argument("--checkpoint-path", default="render_state.npz")
    p.set_defaults(fn=cmd_headless)

    p = sub.add_parser("combine", help="frames/*.exr -> movie/*.png")
    p.add_argument("--frames-dir", default="frames")
    p.add_argument("--movie-dir", default="movie")
    p.set_defaults(fn=cmd_combine)

    p = sub.add_parser("interact", help="terminal fly camera + editing")
    _add_common(p)
    p.add_argument("--spp", type=int, default=4)
    p.set_defaults(fn=cmd_interact)
    return ap


def main(argv=None):
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
