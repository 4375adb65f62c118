"""Frame drivers: progressive rendering, the headless day-cycle batch job
and the movie combine job (behavioural reference main.rs:112-145,
312-370; the JAX package's ``voxtracer/render/driver.py``).

* headless cadence: every ``frame_samples`` samples, write
  ``frames/{iter:04}-{seq:03}.exr``, rotate the sun one day-cycle step,
  print paths/px/sec, start a new iter when the sun sets (sun.y < -0.3),
  stop after ``max_iters`` cycles.
* sun schedule: rotation about the arc from (0.8, 1.0, 3.7) to
  (0.8, 0.0, 3.7), stepped by 0.0025 rad per frame (main.rs:115-122).
* combine: group ``frames/*.exr`` by seq, average in linear space,
  sRGB-encode, write ``movie/{seq}.png``.
"""

from __future__ import annotations

import random
import time
from pathlib import Path

import numpy as np
import torch

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.core import rng as vrng
from voxtracer_torch.core.color import srgb_encode
from voxtracer_torch.core.spectra import build_wl_to_rgb_lut
from voxtracer_torch.core.vecmath import dot
from voxtracer_torch.kernels import heightfield, raster
from voxtracer_torch.kernels.integrator import render_sample, render_samples
from voxtracer_torch.render import checkpoint, film
from voxtracer_torch.render.accumulator import Accumulator
from voxtracer_torch.world import boxes
from voxtracer_torch.world.svo import upload

SUN_ARC_FROM = np.array([0.8, 1.0, 3.7])
SUN_ARC_TO = np.array([0.8, 0.0, 3.7])
SUN_START = np.array([0.8, 10.2743, 3.7])  # main.rs:381
DAY_STEP = 0.0025  # main.rs:120


def _rotation_arc_axis_angle(a, b):
    a = a / np.linalg.norm(a)
    b = b / np.linalg.norm(b)
    axis = np.cross(a, b)
    s = np.linalg.norm(axis)
    angle = float(np.arctan2(s, np.dot(a, b)))
    return axis / max(s, 1e-12), angle


def rotate_sun(sun: np.ndarray, step: float = DAY_STEP) -> np.ndarray:
    """One sun step: rotate by ``step * sign(arc angle)`` about the day
    axis (Rodrigues rotation; the reference uses a quaternion)."""
    axis, angle = _rotation_arc_axis_angle(SUN_ARC_FROM, SUN_ARC_TO)
    th = step * np.sign(angle)
    k = axis
    v = np.asarray(sun, np.float64)
    return (v * np.cos(th) + np.cross(k, v) * np.sin(th)
            + k * np.dot(k, v) * (1 - np.cos(th)))


class Renderer:
    """Progressive spectral path tracer over an SVO world on ``device``.

    A world that is unedited terrain (its ``space`` carries an exact
    heightmap) is a heightfield, and two engines use that. With ``use_hf``
    (the default, as in the JAX ``Renderer``) bounce and shadow casts walk
    the heightfield (K4) instead of the octree (K2); the pack is built
    on first use. With ``use_soup`` (the default) every sample's
    primaries come from the box rasterizer: the terrain soup is extracted
    and uploaded once per world and the pose-only bins are cached per
    pose. From ``HF_FRAME_SIZE`` up a world with the heightfield engine
    builds no soup at all (hf-only mode): primaries are the first
    bounce's heightfield cast, previews ``hf_frame_cast``. Any other
    world, or both switches off, casts everything on the SVO. All engines
    give the traversal's first hit, so the radiance is the same. The
    world table and LUT are uploaded once; per sample only the frame seed
    crosses from the host.
    """

    HF_FRAME_SIZE = 4096  # world edge from which terrain worlds skip the soup

    def __init__(self, device_svo, width: int, height: int,
                 max_bounces: int = 24, fog_steps: int = 64,
                 seed: int | None = None, device="cuda",
                 use_soup: bool = True, use_hf: bool = True):
        """``device_svo``: any object with numpy ``.table/.root/.height``
        (this package's ``DeviceSvo`` or the JAX package's)."""
        self.device = torch.device(device)
        self.width = width
        self.height = height
        self.max_bounces = max_bounces
        self.fog_steps = fog_steps
        self.use_soup = use_soup
        self.use_hf = use_hf
        self.lut = torch.from_numpy(build_wl_to_rgb_lut()).to(self.device)
        self.acc = Accumulator(width, height, self.device)
        self.host_rng = random.Random(seed)
        self.update_space(device_svo)

    def update_space(self, device_svo):
        """Upload a (re)serialized world; the accumulation restarts and
        the soup, bins and heightfield pack of the old world are dropped."""
        self.world = upload(device_svo.table, device_svo.root,
                            device_svo.height, self.device)
        self._dev = device_svo
        self._soup = None
        self._hf = None  # lazy: (tiles, offsets, terrain rgb), or False
        self._bins = self._bins_key = None
        self.soup_world = (self.use_soup
                           and boxes.terrain_heights(device_svo) is not None)
        self.acc.invalidate()

    def _get_hf(self):
        """The heightfield engine's arguments ``(hf_mips, hf_offsets,
        terrain_rgb)`` for an unedited terrain world (the pack is built
        on first use), or three Nones: no exact heightmap, ``use_hf``
        off, or a heightmap that is not the tree's size."""
        if self._hf is None:
            heights = boxes.terrain_heights(self._dev) if self.use_hf \
                else None
            self._hf = False
            if heights is not None \
                    and heights.shape[0] == 1 << self.world.height:
                tiles, offsets, _ = heightfield.build_height_mips(
                    heights, device=self.device)
                rgb = getattr(self._dev.space, "terrain_rgb", (0.5, 0.5, 0.5))
                self._hf = (tiles, offsets, torch.tensor(
                    rgb, dtype=torch.float32, device=self.device))
        return self._hf or (None, None, None)

    def _hf_only(self) -> bool:
        """Whether the world is terrain of at least ``HF_FRAME_SIZE`` with
        the heightfield engine: then no soup is built and the heightfield
        serves primaries too."""
        heights = boxes.terrain_heights(self._dev)
        if heights is None or max(heights.shape) < self.HF_FRAME_SIZE:
            return False
        return self._get_hf()[0] is not None

    def _get_soup(self):
        """The world's box soup on the device (extracted on first use),
        or None when primaries stay on the per-ray cast."""
        if not self.soup_world or self._hf_only():
            return None
        if self._soup is None:
            soup = boxes.extract_boxes(self._dev)
            if len(soup) == 0:  # a world without solid voxels
                self.soup_world = False
                return None
            self._soup = raster.soup_to_device(soup.lo, soup.size, soup.leaf,
                                               soup.rgb, self.device)
        return self._soup

    def _get_soup_bins(self, cam: vcam.Camera, soup):
        """The pose's jittered raster bins, cached per (pos, yaw, pitch)."""
        if soup is None:
            return None
        key = (tuple(np.asarray(cam.pos, np.float64).tolist()),
               float(cam.yaw), float(cam.pitch))
        if self._bins_key != key:
            self._bins = raster.raster_bins(
                *soup, np.asarray(cam.pos, np.float32), cam.basis(),
                self.world.height, self.width, self.height, jittered=True)
            self._bins_key = key
        return self._bins

    def _begin(self, cam: vcam.Camera, sun):
        sun = np.asarray(sun, np.float64)
        sun_unit = (sun / np.linalg.norm(sun)).astype(np.float32)
        self.acc.begin_sample(cam.pos, cam.yaw, cam.pitch, sun_unit)
        return torch.from_numpy(sun_unit).to(self.device)

    def _args(self, cam: vcam.Camera):
        w = self.world
        return (w.table, w.root, w.height, self.lut,
                np.asarray(cam.pos, np.float32), cam.basis())

    def _engine_kw(self, cam: vcam.Camera):
        soup = self._get_soup()
        hf_mips, hf_offsets, terrain_rgb = self._get_hf()
        return dict(soup=soup, soup_bins=self._get_soup_bins(cam, soup),
                    hf_mips=hf_mips, hf_offsets=hf_offsets,
                    terrain_rgb=terrain_rgb)

    def sample(self, cam: vcam.Camera, sun: np.ndarray):
        """One progressive step: 1 spectral path per pixel."""
        sun_t = self._begin(cam, sun)
        seed = vrng.host_frame_seed(self.host_rng)
        radiance = render_sample(
            *self._args(cam), sun_t, seed, self.width, self.height,
            max_bounces=self.max_bounces, fog_steps=self.fog_steps,
            **self._engine_kw(cam))
        self.acc.add(radiance)

    def sample_batch(self, cam: vcam.Camera, sun: np.ndarray, k: int):
        """Accumulate k samples traced as one batch."""
        sun_t = self._begin(cam, sun)
        seeds = np.stack([vrng.host_frame_seed(self.host_rng)
                          for _ in range(k)])
        total = render_samples(
            *self._args(cam), sun_t, seeds, self.width, self.height,
            max_bounces=self.max_bounces, fog_steps=self.fog_steps,
            **self._engine_kw(cam))
        self.acc.add(total, k)

    def preview_frame(self, cam: vcam.Camera, sun: np.ndarray):
        """Shaded primary-visibility frame for interactive preview
        (software.rs:260-276 shading on the rasterized first hit), on the
        pose's cached bins. Tiles the rasterizer cannot prove complete
        are not re-cast (preview only; the path-traced accumulation stays
        exact). Without a soup (hf-only mode) the frame is the exact
        ``hf_frame_cast``. Returns (H, W, 3) linear radiance, or None when
        the world has neither."""
        sun = np.asarray(sun, np.float64)
        sun_t = torch.from_numpy(
            (sun / np.linalg.norm(sun)).astype(np.float32)).to(self.device)
        soup = self._get_soup()
        if soup is None:
            return self._hf_preview(cam, sun_t)
        r = raster.raster_cast(
            *soup, np.asarray(cam.pos, np.float32), cam.basis(),
            self.world.height, self.width, self.height,
            bins=self._get_soup_bins(cam, soup))
        lighting = dot(sun_t, r["normal"]) / 2.0 + 1.0
        return r["rgb"] * lighting[..., None] * r["hit"][..., None]

    def _hf_preview(self, cam: vcam.Camera, sun_t):
        """``preview_frame`` on the heightfield engine: exact primaries,
        the same shading."""
        hf_mips, hf_offsets, terrain_rgb = self._get_hf()
        if hf_mips is None:
            return None
        r = heightfield.hf_frame_cast(
            hf_mips, hf_offsets, self.world.height,
            np.asarray(cam.pos, np.float32), cam.basis(), self.width,
            self.height, terrain_rgb)
        lighting = dot(sun_t, r["normal"]) / 2.0 + 1.0
        return r["rgb"] * lighting[..., None] * r["hit"][..., None]

    def render(self, cam, sun, spp: int, batch: int = 8):
        done = 0
        while done < spp:
            k = min(batch, spp - done)
            if k == 1:
                self.sample(cam, sun)
            else:
                self.sample_batch(cam, sun, k)
            done += k
        return self.acc.mean()

    def save_exr(self, path):
        film.save_exr(path, self.acc.mean())

    def save_png(self, path):
        film.save_png(path, self.acc.mean())


def headless_run(renderer: Renderer, cam: vcam.Camera, out_dir="frames",
                 frame_samples: int = 1000, sun_start=SUN_START,
                 max_iters: int = 1, max_frames: int | None = None,
                 checkpoint_every: int | None = None,
                 checkpoint_path="render_state.npz", batch: int = 1,
                 log=print):
    """Day-cycle batch render (main.rs:112-145, 402-408).

    A sample that raises is retried (the in-flight frame restarts) up to
    three times, then the error propagates. ``checkpoint_every`` writes
    the whole render state to ``checkpoint_path`` whenever the frame's
    sample count is a multiple of it (render/checkpoint.py). ``batch`` > 1
    traces that many samples per call (Renderer.sample_batch); each
    sample's radiance is the same either way."""
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    sun = np.asarray(sun_start, np.float64)
    sun = sun / np.linalg.norm(sun)
    seq, it = 0, 0
    frames_done = 0
    frame_start = time.monotonic()
    while True:
        done_samples = 0
        retries = 0
        while done_samples < frame_samples:
            try:
                # sized from this frame's count: the accumulator still
                # holds the last frame's samples until the sun step
                # restarts it
                k = min(batch, frame_samples - done_samples)
                if k > 1:
                    renderer.sample_batch(cam, sun, k)
                else:
                    renderer.sample(cam, sun)
            except Exception as e:  # device failure: restart the frame
                retries += 1
                log(f"sample failed ({type(e).__name__}: {e}); retry {retries}")
                if retries > 3:
                    raise
                renderer.acc.invalidate()
                continue
            done_samples = renderer.acc.samples
            if checkpoint_every and done_samples % checkpoint_every == 0:
                checkpoint.save_render_state(checkpoint_path, renderer, cam,
                                             sun)
        renderer.save_exr(out / f"{it:04d}-{seq:03d}.exr")
        seq += 1
        sun = rotate_sun(sun, DAY_STEP)
        now = time.monotonic()
        log(f"{frame_samples / (now - frame_start):>7.1f} paths/px/sec"
            f"    iter {it:>2} frame {seq:>3}")
        frame_start = now
        frames_done += 1
        if max_frames is not None and frames_done >= max_frames:
            return
        if sun[1] < -0.3:
            it += 1
            sun = SUN_START / np.linalg.norm(SUN_START)
            seq = 0
            log(f"Finished iter {it - 1}")
            if it >= max_iters:
                return


def combine(frames_dir="frames", movie_dir="movie", log=print):
    """Average frames across iters per seq, tonemap, write movie PNGs
    (main.rs:312-370)."""
    from PIL import Image

    frames = Path(frames_dir)
    movie = Path(movie_dir)
    movie.mkdir(parents=True, exist_ok=True)
    groups: dict[int, list[Path]] = {}
    for p in sorted(frames.glob("*.exr")):
        seq = int(p.stem.split("-")[1])
        groups.setdefault(seq, []).append(p)
    for seq, paths in sorted(groups.items()):
        acc = None
        for p in paths:
            img = film.load_exr(p)[..., :3].astype(np.float64)
            acc = img if acc is None else acc + img
        mean = acc / len(paths)
        lin = np.clip(mean, 0.0, 1.0).astype(np.float32)
        enc = srgb_encode(torch.from_numpy(lin)).numpy()
        u8 = np.clip(enc * 255.0 + 0.5, 0, 255).astype(np.uint8)
        Image.fromarray(u8).save(movie / f"{seq}.png")
        log(f"movie/{seq}.png <- {len(paths)} frames")
