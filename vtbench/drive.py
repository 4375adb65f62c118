"""The system under test, driven as its users drive it: the port's set-up
(import, kernel library, world, Renderer, warm-up) and the measured
window of one cell's traffic.

This is the only module of the benchmark that imports the port
(``voxtracer_torch``). It returns what the window produced, on the host,
for the check: the frames, previews and accumulations at the check's
pixels, the picks and edits, and the host-clock times of every request.
"""

from __future__ import annotations

import contextlib
import io
import os
import random
import shutil
import tempfile
import time
from pathlib import Path

import numpy as np

from vtbench import trace, traffic

MAX_ACTIONS = 20000  # a session's generated actions: more than a window takes


def _sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize()


class Program:
    """The port, set up for one cell. ``parts`` holds the seconds of each
    part of the set-up, in order."""

    def __init__(self, cfg: dict, mix: dict, seed: int, device: str,
                 t0: float, log, space=None):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.log = log
        self.parts = {}
        t = time.monotonic()
        self.parts["start_s"] = t - t0  # interpreter and the harness itself
        import torch

        from voxtracer_torch.app import interactive
        from voxtracer_torch.kernels import build
        from voxtracer_torch.render import driver
        from voxtracer_torch.world import worldgen

        self.torch, self.driver = torch, driver
        self.interactive = interactive
        self.dev = torch.device(device)
        t = self._part("import_s", t)
        if self.dev.type == "cuda":
            build.library()  # the kernel library, built once a checkout
        t = self._part("library_s", t)
        w = cfg["world"]
        if space is None:
            # worldgen's own timings (heightmap, octree) go to the log
            said = io.StringIO()
            with contextlib.redirect_stdout(said):
                space = worldgen.generate(
                    log2_size=w["log2_size"],
                    seed_scale=int(w["seed_scale"], 0),
                    seed_noise=int(w["seed_noise"], 0), verbose=True,
                    device=self.dev)
            log("worldgen: " + "; ".join(said.getvalue().splitlines()))
        self.space = space
        t = self._part("world_s", t)
        f = cfg["film"]
        devices = cfg.get("devices")
        if devices and self.dev.type == "cpu":
            devices = ["cpu"] * devices
        self.renderer = driver.Renderer(
            self.space.serialize(), f["width"], f["height"],
            max_bounces=f["max_bounces"], fog_steps=f["fog_steps"],
            seed=seed, device=self.dev, devices=devices,
            **cfg.get("renderer", {}))
        self.width, self.height = f["width"], f["height"]
        t = self._part("renderer_s", t)
        self.sun0 = np.asarray(cfg["sun"], np.float64)
        self.sun0 = self.sun0 / np.linalg.norm(self.sun0)
        self.frame_dir = Path(tempfile.mkdtemp(prefix="vtbench-frames-"))
        self.draws = 0  # frame seeds drawn from the Renderer's host rng
        if mix["kind"] == "session":
            c = mix["check"]
            self.check_px = dict(
                preview=traffic.check_pixels(seed, c["preview_pixels"],
                                             self.width, self.height, 4,
                                             c.get("center", 0)),
                sample=traffic.check_pixels(seed, c["sample_pixels"],
                                            self.width, self.height, 5))
        self.warm()
        _sync(torch, self.dev)
        t = self._part("warm_s", t)
        self.setup_s = t - t0

    def _part(self, name, t):
        self._sync()
        now = time.monotonic()
        self.parts[name] = now - t
        return now

    def _sync(self):
        if getattr(self, "dev", None) is not None:
            _sync(self.torch, self.dev)

    def close(self):
        """Free the program's state on the device (its frames stay on disk
        for the check until ``remove_frames``)."""
        self.renderer = self.space = None
        import gc

        gc.collect()
        if self.dev.type == "cuda":
            self.torch.cuda.empty_cache()

    def remove_frames(self):
        shutil.rmtree(self.frame_dir, ignore_errors=True)

    @property
    def headless_kw(self) -> dict:
        """``headless_run``'s options from the traffic mix's ``headless``
        (its defaults where the mix names none, as the CLI passes them);
        a checkpoint goes beside the run's frames."""
        kw = dict(self.mix.get("headless", {}))
        if kw.get("checkpoint_every"):
            kw["checkpoint_path"] = self.frame_dir / "render_state.npz"
        return kw

    @property
    def group(self) -> int:
        """Samples the accumulator takes in one add: a sharded step's,
        or a headless batch's."""
        if self.shard > 1 or self.mix["kind"] != "headless":
            return self.shard
        return int(self.headless_kw.get("batch", 1))

    @property
    def shard(self) -> int:
        m = self.renderer.mesh
        return 1 if m is None else m.size

    # -- warm-up: every shape the cell's traffic uses, and no other --

    def warm(self):
        if self.mix["kind"] == "headless":
            cam = self.camera(self.cfg["pose"])
            # the pose's envelope tiers (SKY_TIERS: first uses 0, 1, 4),
            # under the sun one step before the window's first, so that
            # the window's first frame starts its accumulation afresh
            sun = self.driver.rotate_sun(self.sun0, -self.driver.DAY_STEP)
            for _ in range(5):
                self.renderer.sample(cam, sun)
                self.draws += self.shard
            # the batch sizes headless_run traces a frame in
            batch = int(self.headless_kw.get("batch", 1))
            fs = int(self.cfg["frame_samples"])
            if self.shard == 1:
                for k in sorted({min(batch, fs), fs % batch} - {0, 1}):
                    self.renderer.sample_batch(cam, sun, k)
                    self.draws += k
            self.renderer.save_exr(self.frame_dir / "warm.exr")
        else:
            self.actions = traffic.session_actions(
                self.mix, self.cfg["pose"], self.seed,
                MAX_ACTIONS)
            self.next_action = 0
            self.records = []
            for _ in range(int(self.mix.get("warm_actions", 2))):
                self.action(self.actions[self.next_action], None, False)
                self.next_action += 1

    def camera(self, pose):
        from voxtracer_torch.core import camera as vcam

        return vcam.Camera(pos=tuple(pose["pos"]), yaw=float(pose["yaw"]),
                           pitch=float(pose["pitch"]))

    # -- the measured window --

    def run_window(self, seconds: float, tracer=None):
        """Drive the traffic for ``seconds``; returns the window's record
        (its own seconds and the requests)."""
        if self.mix["kind"] == "headless":
            return self._headless_window(seconds, tracer)
        return self._session_window(seconds, tracer)

    def _headless_window(self, seconds, tracer):
        """One ``headless_run`` call a frame, as the CLI's ``headless``
        runs it (its defaults: batch 1, checkpoints off; the mix's
        ``headless`` options over them), with the sun stepped a day-cycle
        step a frame. The window's time covers every frame begun before
        its end."""
        driver = self.driver
        kw = self.headless_kw
        cam = self.camera(self.cfg["pose"])
        fs = int(self.cfg["frame_samples"])
        sun = self.sun0.copy()
        frames, failed, prints = [], 0, []
        if tracer is not None:
            tracer.wrap_samples(self.renderer)
        self._sync()
        t0 = time.monotonic()
        deadline = t0 + seconds
        while time.monotonic() < deadline:
            out = self.frame_dir / f"f{len(frames):03d}"
            first_draw = self.draws
            t_f = time.monotonic()
            try:
                driver.headless_run(self.renderer, cam, out_dir=out,
                                    frame_samples=fs, sun_start=sun,
                                    max_frames=1, log=prints.append, **kw)
            except Exception as e:  # noqa: BLE001 - a failed request
                failed += 1
                self.log(f"frame {len(frames)} failed: {type(e).__name__}: {e}")
                break
            steps = -(-fs // self.shard)
            self.draws += steps * self.shard
            frames.append(dict(sun=sun.copy(), exr=out / "0000-000.exr",
                               first_draw=first_draw,
                               samples=steps * self.shard))
            sun = driver.rotate_sun(sun, driver.DAY_STEP)
            frames[-1]["call_s"] = time.monotonic() - t_f
        t1 = time.monotonic()
        if tracer is not None:
            tracer.unwrap(self.renderer)
        for p, f in zip(prints, frames):
            self.log(f"headless_run: {p.strip()}; the call {f['call_s']:.4f} s")
        return dict(kind="headless", seconds=t1 - t0, frames=frames,
                    failed=failed, attempted=len(frames) + failed,
                    samples=sum(f["samples"] for f in frames),
                    pixels=(self.width, self.height))

    def _session_window(self, seconds, tracer):
        self._sync()
        t0 = time.monotonic()
        deadline = t0 + seconds
        first = len(self.records)
        failed = 0
        while time.monotonic() < deadline:
            if self.next_action >= len(self.actions):
                raise RuntimeError("the session ran out of generated actions")
            a = self.actions[self.next_action]
            self.next_action += 1
            if tracer is not None:
                tracer.before_action(len(self.records) - first)
            try:
                self.action(a, tracer, True)
            except Exception as e:  # noqa: BLE001 - a failed request
                failed += 1
                self.log(f"action failed: {type(e).__name__}: {e}")
                break
        t1 = time.monotonic()
        if tracer is not None:
            tracer.before_action(None)
        recs = self.records[first:]
        return dict(kind="session", seconds=t1 - t0, records=recs,
                    all_records=self.records, failed=failed,
                    attempted=len(recs) + failed)

    def action(self, a, tracer, timed):
        """One action of the app: new pose, the edit at the crosshair (a
        pick, ``space.set``, ``apply_edits``), the preview on the host,
        then the samples (main.rs:164-208, 267-290)."""
        torch = self.torch
        r = self.renderer
        cam = self.camera(a)
        sun = self.sun0
        rec = dict(pos=a["pos"], yaw=a["yaw"], pitch=a["pitch"], kind=a["edit"],
                   pick=None, edited=None)
        span = (lambda name: tracer.span(name)) if tracer is not None \
            else (lambda name: trace.nullspan())
        self._sync()
        t_a = time.monotonic()
        if a["edit"]:
            picked = self.interactive.center_pick(r.world, cam.pos, cam.yaw,
                                                  cam.pitch)
            edited = None
            if picked is not None:
                voxel, normal = picked
                rec["pick"] = (tuple(int(c) for c in voxel),
                               tuple(int(c) for c in normal))
                n = 1 << self.space.height()
                if a["edit"] == "del":
                    edited = tuple(int(c) for c in voxel)
                    self.space.set(edited, None)
                elif all(0 <= int(c) < n for c in voxel + normal):
                    edited = tuple(int(c) for c in voxel + normal)
                    self.space.set(edited, (1.0, 1.0, 1.0))
            if edited is not None:
                rec["edited"] = (edited, None if a["edit"] == "del"
                                 else (1.0, 1.0, 1.0))
                with span("vtb:apply_edits"):
                    r.apply_edits(self.space, edits=[edited])
        with span("vtb:preview"):
            img = r.preview_frame(cam, sun)
            frame = img.cpu().numpy()
        t_p = time.monotonic()
        rec["preview_s"] = t_p - t_a
        rec["sample_s"] = []
        rec["first_draw"] = self.draws
        for _ in range(int(self.mix.get("samples_per_action", 1))):
            t_s = time.monotonic()
            with span("vtb:sample"):
                r.sample(cam, sun)
                self._sync()
            rec["sample_s"].append(time.monotonic() - t_s)
            self.draws += self.shard
        rec["samples"] = r.acc.samples
        if self.check_px is not None:
            px, py = self.check_px["preview"]
            rec["preview"] = frame[py, px]
            spx, spy = self.check_px["sample"]
            idx = torch.from_numpy((spy.astype(np.int64) * self.width + spx))
            buf = r.acc.buffer.reshape(-1, 3)[idx.to(r.acc.buffer.device)]
            rec["acc"] = buf.cpu().numpy()
        rec["timed"] = timed
        self.records.append(rec)

    check_px = None


def set_caches(root: Path):
    """Every build and kernel cache at a fixed path inside the checkout,
    so that only the first run there builds and compiles (the port's own
    library and world builder build into ``voxtracer_torch/_build/``)."""
    cache = root / ".vtbench_cache"
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(cache / sub)


def frame_seeds(seed: int, first: int, count: int):
    """The frame seeds a Renderer built with ``seed`` draws as its draws
    ``first`` .. ``first + count - 1``: three 32-bit words each from
    ``random.Random(seed)`` (the port's ``rng.host_frame_seed``, frozen
    in ``reference/rng.py``)."""
    from vtbench.reference import rng as vrng

    g = random.Random(seed)
    for _ in range(first):
        vrng.host_frame_seed(g)
    return [vrng.host_frame_seed(g) for _ in range(count)]
