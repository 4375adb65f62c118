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

import os
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
from voxtracer_torch.kernels import heightfield, raster, skyline, sunshadow
from voxtracer_torch.kernels.integrator import render_sample, render_samples
from voxtracer_torch.kernels.traverse import leaf_rgb
from voxtracer_torch.render import checkpoint, film
from voxtracer_torch.render.accumulator import Accumulator
from voxtracer_torch.utils import profiling
from voxtracer_torch.utils.profiling import span, spanned
from voxtracer_torch.world import boxes
from voxtracer_torch.world.svo import EMPTY, DeviceSvo, DeviceWorld, upload

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


def _staged(x, device: torch.device) -> torch.Tensor:
    """A new tensor on ``device`` holding the host array or CPU tensor
    ``x``. On a card it is copied from pinned memory by a copy that does
    not wait for the stream (PyTorch's caching host allocator keeps the
    pinned block until the copy has run); on the CPU it is a copy."""
    t = torch.as_tensor(x)
    if device.type != "cuda":
        return t.clone()
    return t.pin_memory().to(device, non_blocking=True)


def _note(name: str, staged: bool):
    """While the profiler records: count a sample input ``name`` copied
    from the host (``inputs.staged.<name>``) or its device copy reused
    (``inputs.reused.<name>``)."""
    if torch.autograd._profiler_enabled():
        profiling.count(f"inputs.{'staged' if staged else 'reused'}.{name}")


def _heights(dev):
    """The heightmap worldgen left on ``dev.space`` (exact, or stale after
    edits), or None."""
    return getattr(getattr(dev, "space", None), "heights", None)


class Renderer:
    """Progressive spectral path tracer over an SVO world on ``device``.

    A world built by worldgen carries its heightmap, and two engines use
    that. With ``use_hf`` (the default, as in the JAX ``Renderer``) bounce
    and shadow casts walk the heightfield (K4) instead of the octree (K2);
    the pack is built on first use. With ``use_soup`` (the default) every
    sample's primaries come from the box rasterizer: the soup is extracted
    and uploaded once per world (the terrain path while the heightmap is
    exact, else the octree's instances) and the pose-only bins are cached
    per pose. From ``HF_FRAME_SIZE`` up a world with the heightfield engine
    builds no soup at all (hf-only mode): primaries are the heightfield
    walk resumed in certified air by the pose's horizon envelope
    (``_get_sky_env``; K5), previews ``hf_frame_cast``. Worlds without a
    heightmap (``from_dense``, resumed from a checkpoint), or both
    switches off, cast everything on the SVO. All engines give the
    traversal's first hit, so the radiance is the same. The world table
    and LUT are uploaded once. A sample's small inputs reach the device
    without blocking the host (``_staged``): the sun once a sun value,
    the pose once a pose (a soup's rasterizer reads it on the host
    instead), the frame seed every sample; so on a card the host enqueues
    the next sample while the last one runs.

    Point edits go through ``apply_edits``: the changed table rows are
    written in place, the soup is patched, and the heightfield engine
    stays on: edits that keep the world a heightfield patch the pack (and
    the envelope's pyramid); any other edit adds a box to a list of edit
    bounds, and the casts re-cast on the SVO the lanes that can see one.

    With ``devices`` every ``sample()`` is one sample-sharded step over a
    mesh (``dist/shard.py``): one sample on each mesh entry, summed in
    mesh order, N samples a call (``_dist``).
    """

    HF_FRAME_SIZE = 4096  # world edge from which terrain worlds skip the soup
    EDIT_BOXES = 24  # edit-bounds boxes kept before the nearest pair merges
    # envelope tiers by the uses of one pose: (build arguments, first use)
    SKY_TIERS = ((dict(bins=8192, K=256, ratio=32), 0),
                 (dict(bins=8192, K=512, ratio=128), 1),
                 (dict(bins=8192, K=512, ratio=256), 4))

    def __init__(self, device_svo, width: int, height: int,
                 max_bounces: int = 24, fog_steps: int = 64,
                 seed: int | None = None, device="cuda",
                 use_soup: bool = True, use_hf: bool = True, devices=None):
        """``device_svo``: any object with numpy ``.table/.root/.height``
        (this package's ``DeviceSvo`` or the JAX package's). ``devices``:
        shard ``sample()`` over the first N CUDA cards (an int; fewer
        cards raise) or over a list of devices (repeats allowed; ``["cpu"]
        * 8`` on the CPU); the Renderer's device is then the mesh's
        first. None, 1 or a list of one device: single-device (on that
        device)."""
        self.mesh = None
        if devices is not None and not isinstance(devices, int):
            devices = list(devices)
            if len(devices) == 1:
                device, devices = devices[0], None
        if isinstance(devices, int) and devices <= 1:
            devices = None
        if devices is not None:
            from voxtracer_torch.dist.mesh import make_mesh

            self.mesh = make_mesh(devices) if isinstance(devices, int) \
                else make_mesh(devices=devices)
            device = self.mesh.devices[0]
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
        self._sun_unit = None  # the sun of the current sample (_begin)
        self._sun_t = None  # (sun key, the unit sun on the device)
        self._pose_t = None  # (pose key, cam_pos, cam_basis on the device)
        self.update_space(device_svo)

    def update_space(self, device_svo):
        """Upload a (re)serialized world; the accumulation restarts and
        the soup, bins, heightfield pack, envelope and edit bounds of the
        old world are dropped."""
        self.world = upload(device_svo.table, device_svo.root,
                            device_svo.height, self.device)
        self._dev = device_svo
        solid = getattr(device_svo, "solid_leaf", None)
        self._solid_leaf = None if solid is None else np.array(solid, np.int32)
        self._table_edited = False  # the device table is ahead of _dev's
        self._soup = None  # lazy SoupPatcher
        self._hf = None  # lazy: (tiles, offsets, terrain rgb), or False
        self._bins = self._bins_key = None
        self._sky_mips = None  # the envelope's pyramid pack (per world)
        self._sky_env = None  # (pose key, (E, d0, g, K, S), tier, uses)
        self._edit_bounds = None  # list of (2, 3) boxes covering edits
        self._bounds_t = None  # the list as a tensor on the device
        self._dist_step = None  # the sharded step, built on first use
        self._sun_maps_key = self._sun_maps = None  # per (world, sun)
        sp = getattr(device_svo, "space", None)
        self._seen_edit_count = getattr(sp, "edit_count", 0)
        self._seen_set_calls = getattr(sp, "set_calls", 0)
        self.soup_world = self.use_soup and _heights(device_svo) is not None
        self.acc.invalidate()

    @spanned("vt:apply_edits")
    def apply_edits(self, space, edits=None):
        """Bring the device up to date after point edits already made in
        ``space``: only the rows its ``serialize_delta`` reports are
        written (the table grows to the space's capacity with EMPTY rows);
        without a delta, or when the tree's height changed, a full
        ``update_space``. ``edits``: the (x, y, z) voxels edited. With
        them the soup is patched in place and the heightfield engine
        stays: edits that keep the world a heightfield re-derive the
        heightmap and patch the pack (``_apply_hf_edits``); others add a
        bounds box (a list of at most ``EDIT_BOXES``, the pair whose union
        grows least merged first; past a quarter of the world edge the
        engine turns off). Without ``edits`` the soup and the engine are
        dropped until the next ``update_space``."""
        with span("vt:edits.delta"):
            delta = (space.serialize_delta()
                     if hasattr(space, "serialize_delta") else None)
        if delta is None:
            self.update_space(space.serialize())
            return
        rows, vals, solid, root, height, cap = delta
        if height != self.world.height or self._solid_leaf is None:
            self.update_space(space.serialize())
            return
        with span("vt:edits.table"):
            table = self.world.table
            if cap > table.shape[0]:
                grow = cap - table.shape[0]
                table = torch.cat([table, torch.full(
                    (grow, 8), -1, dtype=torch.int32, device=self.device)])
                self._solid_leaf = np.concatenate(
                    [self._solid_leaf, np.full(grow, -1, np.int32)])
            if len(rows):
                idx = torch.from_numpy(np.asarray(rows, np.int64)).to(
                    self.device)
                table[idx] = torch.from_numpy(
                    np.ascontiguousarray(vals, np.uint32).view(np.int32)).to(
                    self.device)
                self._solid_leaf[np.asarray(rows, np.int64)] = solid
        self.world = DeviceWorld(table=table,
                                 root=-1 if root == EMPTY else int(root),
                                 height=self.world.height)
        self._table_edited = True

        if self._soup is None:
            patched = True  # the lazy extraction reads the edited world
        elif edits is not None:
            with span("vt:edits.soup"):
                patched = self._soup.apply(edits, space)
        else:
            patched = False
        if edits is not None and len(edits) \
                and self._apply_hf_edits(space, edits):
            pass  # still an exact heightfield: the pure walk stays valid
        elif edits is not None and len(edits):
            # the walk on the pre-edit pack stays exact outside the boxes
            sp0 = getattr(self._dev, "space", None)
            if sp0 is not None:
                sp0.heights_exact = False
            self._add_edit_bounds(edits)
        else:
            # edits at unknown places: no pre-edit walk can be trusted
            sp0 = getattr(self._dev, "space", None)
            if sp0 is not None:
                sp0.heights_exact = False
            self._edit_bounds = None
            self._hf = False
        self._bounds_t = None
        if not patched:
            self._soup = None
            self.soup_world = False
        self._bins = self._bins_key = None
        self._dist_step = None  # its replicas hold the old world
        self._seen_edit_count = getattr(space, "edit_count",
                                        self._seen_edit_count)
        self._seen_set_calls = getattr(space, "set_calls",
                                       self._seen_set_calls)
        self.acc.invalidate()

    @spanned("vt:edits.bounds")
    def _add_edit_bounds(self, edits):
        """Add the box around ``edits``, grown by a voxel to bury float32
        slab wobble, to the edit bounds, merging the pair whose union
        grows least while there are more than ``EDIT_BOXES``; past a
        quarter of the world edge the engine turns off."""
        e = np.asarray(edits, np.float32).reshape(-1, 3)
        bl = list(self._edit_bounds or [])
        bl.append(np.stack([e.min(axis=0) - 1.0, e.max(axis=0) + 2.0]))
        while len(bl) > self.EDIT_BOXES:
            best, bi, bj = None, 0, 1
            for i in range(len(bl)):
                for j in range(i + 1, len(bl)):
                    u = (np.maximum(bl[i][1], bl[j][1])
                         - np.minimum(bl[i][0], bl[j][0])).prod()
                    grow = u - (bl[i][1] - bl[i][0]).prod() \
                        - (bl[j][1] - bl[j][0]).prod()
                    if best is None or grow < best:
                        best, bi, bj = grow, i, j
            m = np.stack([np.minimum(bl[bi][0], bl[bj][0]),
                          np.maximum(bl[bi][1], bl[bj][1])])
            bl = [b for k, b in enumerate(bl) if k not in (bi, bj)]
            bl.append(m)
        self._edit_bounds = bl
        if max((b[1] - b[0]).max() for b in bl) \
                > (1 << self.world.height) / 4.0:
            self._edit_bounds = None
            self._hf = False

    @spanned("vt:edits.hf")
    def _apply_hf_edits(self, space, edits) -> bool:
        """If after this batch every touched column is a contiguous
        terrain-coloured stack [0, h'), write the new heights into
        ``space.heights``, patch the heightfield pack and the envelope's
        pyramid in place, set ``space.heights_exact`` and return True.
        Any other shape (holes, overhangs, other colours) returns False
        untouched. Refused while bounds are tracked or the engine is off,
        and when the space counts more ``set`` calls since the last batch
        than this batch holds (edits the renderer was never shown)."""
        heights = getattr(space, "heights", None)
        if (heights is None or self._hf is False
                or self._edit_bounds is not None):
            return False
        scnt = getattr(space, "set_calls", None)
        cnt = getattr(space, "edit_count", None)
        if scnt is not None:
            if scnt - self._seen_set_calls > len(edits):
                return False
        elif cnt is not None:
            if cnt - self._seen_edit_count > len(edits):
                return False
        elif getattr(space, "edited", False) \
                and not getattr(space, "heights_exact", False):
            return False
        n = 1 << self.world.height
        trgb = getattr(space, "terrain_rgb", None)
        if trgb is None:
            return False
        trgb32 = tuple(np.float32(c) for c in trgb)
        cols: dict[tuple, list] = {}
        for p in edits:
            x, y, z = int(p[0]), int(p[1]), int(p[2])
            if not (0 <= x < n and 0 <= y < n and 0 <= z < n):
                return False
            cols.setdefault((x, z), []).append(y)
        new_h: dict[tuple, int] = {}
        for (x, z), ys in cols.items():
            h = int(heights[x, z])
            solid = {}
            for y in sorted(set(ys)):
                got = space.get((x, y, z))
                if got is not None and tuple(
                        np.float32(c) for c in got) != trgb32:
                    return False  # a block of another colour
                solid[y] = got is not None
            placed = sorted(y for y, sv in solid.items() if sv and y >= h)
            deleted = sorted(y for y, sv in solid.items() if not sv and y < h)
            if placed and deleted:
                return False
            if placed:
                if placed != list(range(h, h + len(placed))):
                    return False  # floating above the top
                new_h[(x, z)] = h + len(placed)
            elif deleted:
                if deleted != list(range(h - len(deleted), h)):
                    return False  # a hole below the new top
                new_h[(x, z)] = h - len(deleted)
        if new_h and not (isinstance(heights, np.ndarray)
                          and heights.flags.writeable):
            heights = np.array(heights)
            space.heights = heights
        for (x, z), hh in new_h.items():
            heights[x, z] = hh
        if new_h and isinstance(self._hf, tuple):
            heightfield.patch_height_mips(self._hf[0], self._hf[1],
                                          self.world.height, heights,
                                          list(new_h))
        space.heights_exact = True
        if new_h:
            if self._sky_mips is not None and isinstance(self._hf, tuple):
                self._sky_mips = skyline.patch_sky_levels(
                    self._sky_mips, self._hf[0], list(new_h))
            else:
                self._sky_mips = None
            self._sky_env = None  # the pose's table read the old heights
            self._sun_maps_key = self._sun_maps = None
        return True

    def _get_hf(self):
        """The heightfield engine's arguments ``(hf_mips, hf_offsets,
        terrain_rgb)`` for a terrain world (the pack is built on first
        use), or three Nones: no heightmap, ``use_hf`` off, a heightmap
        that is not the tree's size, or edits that left the heightmap
        stale with no bounds tracked."""
        sp = getattr(self._dev, "space", None)
        heights = _heights(self._dev) if self.use_hf else None
        stale = (getattr(sp, "edited", False)
                 and not getattr(sp, "heights_exact", False)
                 and self._edit_bounds is None)
        if heights is None or self._hf is False or stale:
            self._hf = False
            return None, None, None
        if self._hf is None:
            self._hf = False
            if heights.shape[0] == 1 << self.world.height:
                tiles, offsets, _ = heightfield.build_height_mips(
                    heights, device=self.device)
                rgb = getattr(sp, "terrain_rgb", (0.5, 0.5, 0.5))
                self._hf = (tiles, offsets, torch.tensor(
                    rgb, dtype=torch.float32, device=self.device))
        return self._hf or (None, None, None)

    def _hf_only(self) -> bool:
        """Whether the world is terrain of at least ``HF_FRAME_SIZE`` with
        the heightfield engine: then no soup is built and the heightfield
        serves primaries too (edited worlds while their bounds are
        tracked: the hybrid cast stays exact)."""
        heights = _heights(self._dev)
        if heights is None or max(heights.shape) < self.HF_FRAME_SIZE:
            return False
        return self._get_hf()[0] is not None

    def _hf_bounds(self):
        """The tracked edit boxes as a (k, 2, 3) float32 tensor for the
        hybrid cast, or None (no bounds-tracked edits: the pure walk)."""
        sp = getattr(self._dev, "space", None)
        if not getattr(sp, "edited", False) or self._edit_bounds is None:
            return None
        if self._bounds_t is None:
            self._bounds_t = torch.from_numpy(
                np.stack(self._edit_bounds).astype(np.float32)).to(self.device)
        return self._bounds_t

    @spanned("vt:sky_env")
    def _get_sky_env(self, cam: vcam.Camera):
        """The pose's horizon envelope ``(E, d0, g, K, S)`` (S: K5's
        summary, ``skyline.env_summary``) for an hf-only world, or None.
        Built on the device from the world's pyramid
        (derived once from the heightfield pack); richer tables as a pose
        is held: ``SKY_TIERS`` by the uses of one ``cam.pos``, a new pose
        back at tier 0. Not for edits that left the heightmap stale with
        no bounds tracked; bounds-tracked edits keep it, since the hybrid
        cast's walk runs on the pre-edit pack the envelope certifies."""
        if not self._hf_only():
            return None
        sp = getattr(self._dev, "space", None)
        if getattr(sp, "edited", False) \
                and not getattr(sp, "heights_exact", False) \
                and self._hf_bounds() is None:
            return None
        key = tuple(np.asarray(cam.pos, np.float64).tolist())
        uses = 0
        if self._sky_env is not None and self._sky_env[0] == key:
            _, args, tier, uses = self._sky_env
            uses += 1
            if self._tier(uses) == tier:
                self._sky_env = (key, args, tier, uses)
                return args
        tier = self._tier(uses)
        with span(f"vt:sky_env.build.t{tier}"):
            if self._sky_mips is None:
                tiles, offsets, _ = self._get_hf()
                self._sky_mips = skyline.sky_levels_from_hf(
                    tiles, offsets, self.world.height)
            env = skyline.build_skyline_env_device(
                self._sky_mips, np.asarray(cam.pos, np.float64),
                **self.SKY_TIERS[tier][0])
        args = (env["E"], env["d0"], env["g"], env["K"], env["S"])
        self._sky_env = (key, args, tier, uses)
        return args

    def _get_sun_maps(self, sun_unit):
        """The sun-visibility thresholds of this (world, sun)
        (``kernels/sunshadow.py``) on the device, or None: NEE lanes the
        maps prove lit skip the shadow walk, radiance equal by bits. As in
        the JAX package (``voxtracer/render/driver.py:953``): opt-in by
        ``VOXT_SUNMAPS=1``, the heightfield engine only, an unedited or
        heightfield-exact world, cached per sun (the headless day cycle
        steps the sun once a frame); a gated sun (low or near vertical)
        gives None."""
        if os.environ.get("VOXT_SUNMAPS") != "1" or sun_unit is None:
            return None
        sp = getattr(self._dev, "space", None)
        if getattr(sp, "edited", False) \
                and not getattr(sp, "heights_exact", False):
            return None  # the maps prove pre-edit visibility only
        if self._get_hf()[0] is None:
            return None
        key = np.asarray(sun_unit, np.float32).tobytes()
        if self._sun_maps_key != key:
            self._sun_maps = sunshadow.upload(
                sunshadow.build(_heights(self._dev), sun_unit), self.device)
            self._sun_maps_key = key
        return self._sun_maps

    def _tier(self, uses: int) -> int:
        return max(t for t, (_, first) in enumerate(self.SKY_TIERS)
                   if uses >= first)

    def _current_dev(self):
        """The world as extraction must read it: ``_dev``, or after
        ``apply_edits`` the device's table and solid leaves."""
        if not self._table_edited:
            return self._dev
        return DeviceSvo(
            table=self.world.table.cpu().numpy().view(np.uint32),
            root=EMPTY if self.world.root < 0 else self.world.root,
            height=self.world.height, solid_leaf=self._solid_leaf,
            space=getattr(self._dev, "space", None))

    def _get_soup(self):
        """The world's box soup on the device (extracted on first use, then
        patched by ``apply_edits``), or None when primaries stay on the
        per-ray cast."""
        if not self.soup_world or self._hf_only():
            return None
        if self._soup is None:
            soup = boxes.extract_boxes(self._current_dev())
            if len(soup) == 0:
                self.soup_world = False
                return None
            self._soup = boxes.SoupPatcher(soup, self.device)
        return self._soup.device_soup

    @staticmethod
    def _pose_key(cam: vcam.Camera):
        return (tuple(np.asarray(cam.pos, np.float64).tolist()),
                float(cam.yaw), float(cam.pitch))

    def _get_soup_bins(self, cam: vcam.Camera, soup):
        """The pose's jittered raster bins, cached per (pos, yaw, pitch)."""
        if soup is None:
            return None
        key = self._pose_key(cam)
        if self._bins_key != key:
            self._bins = raster.raster_bins(
                *soup, np.asarray(cam.pos, np.float32), cam.basis(),
                self.world.height, self.width, self.height, jittered=True)
            self._bins_key = key
        return self._bins

    def _sun(self, sun):
        """The unit sun (normalised in float64, then float32) and its
        (3,) tensor on the device, made once a sun value: a new tensor
        when the sun changes, never one written in place, since a sample
        still queued on the card may read the last."""
        sun = np.asarray(sun, np.float64)
        sun_unit = (sun / np.linalg.norm(sun)).astype(np.float32)
        key = sun_unit.tobytes()
        staged = self._sun_t is None or self._sun_t[0] != key
        if staged:
            self._sun_t = (key, _staged(sun_unit, self.device))
        _note("sun", staged)
        return sun_unit, self._sun_t[1]

    @spanned("vt:begin")
    def _begin(self, cam: vcam.Camera, sun):
        sun_unit, sun_t = self._sun(sun)
        self.acc.begin_sample(cam.pos, cam.yaw, cam.pitch, sun_unit)
        self._sun_unit = sun_unit
        return sun_t

    def _seeds(self, k: int | None = None):
        """The next frame seed drawn from ``host_rng`` (``k`` of them,
        stacked, when ``k`` is given) as int64 on the device."""
        if k is None:
            seeds = vrng.host_frame_seed(self.host_rng)
        else:
            seeds = np.stack([vrng.host_frame_seed(self.host_rng)
                              for _ in range(k)])
        _note("seed", True)
        return _staged(seeds.astype(np.int64), self.device)

    def _args(self, cam: vcam.Camera, soup):
        """``render_sample``'s leading arguments. The pose: with a soup,
        the host's (the rasterizer reads it there); else ``cam_pos`` and
        the basis ``camera_basis`` computes on the CPU, on the device,
        made once a pose (``_pose_key``)."""
        w = self.world
        if soup is not None:
            pose = (np.asarray(cam.pos, np.float32), cam.basis())
        else:
            key = self._pose_key(cam)
            staged = self._pose_t is None or self._pose_t[0] != key
            if staged:
                self._pose_t = (
                    key, _staged(np.asarray(cam.pos, np.float32), self.device),
                    _staged(cam.basis(), self.device))
            _note("pose", staged)
            pose = self._pose_t[1:]
        return (w.table, w.root, w.height, self.lut, *pose)

    @spanned("vt:engine_kw")
    def _engine_kw(self, cam: vcam.Camera):
        with span("vt:soup"):
            soup = self._get_soup()
        hf_mips, hf_offsets, terrain_rgb = self._get_hf()
        env = self._get_sky_env(cam)
        with span("vt:bins"):
            bins = self._get_soup_bins(cam, soup)
        with span("vt:sun_maps"):
            sun_maps = self._get_sun_maps(self._sun_unit)
        return dict(soup=soup, soup_bins=bins, hf_mips=hf_mips,
                    hf_offsets=hf_offsets, terrain_rgb=terrain_rgb,
                    hf_edit_bounds=self._hf_bounds(), hf_sky_env=env,
                    sun_maps=sun_maps)

    def _dist(self):
        """The sample-sharded step over the mesh, built on first use after
        each world change (``update_space`` and ``apply_edits`` drop it):
        the table, LUT, soup and heightfield pack close over it, one copy
        on each distinct device. A world with edit bounds shards without
        the heightfield pack (the SVO cast), as the JAX package's does."""
        if self._dist_step is None:
            from voxtracer_torch.dist import shard

            hf_mips, hf_offsets, terrain_rgb = self._get_hf()
            if self._hf_bounds() is not None:
                hf_mips = hf_offsets = terrain_rgb = None
            soup = self._get_soup()
            self._dist_soup = None if soup is None \
                else shard.replicate(self.mesh, soup)
            w = self.world
            self._dist_step = shard.sample_sharded_step(
                self.mesh, w.table, w.root, w.height, self.lut, self.width,
                self.height, max_bounces=self.max_bounces,
                fog_steps=self.fog_steps, soup=self._dist_soup,
                hf_mips=hf_mips, hf_offsets=hf_offsets,
                terrain_rgb=terrain_rgb)
            self._dist_hf = hf_mips is not None
            self._dist_bins_key = self._dist_env = None
        return self._dist_step

    def _dist_call_args(self, cam: vcam.Camera):
        """The sharded step's per-pose call args, copied to each distinct
        device once per pose: the hf-only envelope, and the soup's
        jittered bins (cached per pose and per device; the Renderer's own
        device shares the single-device cache)."""
        from voxtracer_torch.dist.shard import Replicated, replicate

        extra = ()
        env = self._get_sky_env(cam) if self._dist_hf else None
        if env is not None:
            if self._dist_env is None or self._dist_env[0] is not env:
                self._dist_env = (env, tuple(
                    replicate(self.mesh, a) if torch.is_tensor(a) else a
                    for a in env))
            extra = self._dist_env[1]
        if self._dist_soup is None:
            return extra, None
        key = self._pose_key(cam)
        if self._dist_bins_key != key:
            pos, basis = np.asarray(cam.pos, np.float32), cam.basis()
            self._dist_bins = Replicated({
                d: self._get_soup_bins(cam, self._dist_soup.on(d))
                if d == self.device else raster.raster_bins(
                    *self._dist_soup.on(d), pos, basis, self.world.height,
                    self.width, self.height, jittered=True)
                for d in self.mesh.distinct})
            self._dist_bins_key = key
        return extra, self._dist_bins

    @spanned("vt:sample")
    def sample(self, cam: vcam.Camera, sun: np.ndarray):
        """One progressive step: 1 spectral path per pixel; with
        ``devices`` one on each mesh entry, N samples a call, their frame
        seeds drawn in turn from ``host_rng`` as N single calls draw them."""
        sun_t = self._begin(cam, sun)
        if self.mesh is not None:
            step = self._dist()
            seeds = np.stack([vrng.host_frame_seed(self.host_rng)
                              for _ in range(self.mesh.size)])
            extra, bins = self._dist_call_args(cam)
            total = step(seeds, np.asarray(cam.pos, np.float32), cam.basis(),
                         sun_t, *extra, soup_bins=bins)
            self.acc.add(total, self.mesh.global_size)
            return
        seed = self._seeds()
        kw = self._engine_kw(cam)
        radiance = render_sample(
            *self._args(cam, kw["soup"]), sun_t, seed, self.width,
            self.height, max_bounces=self.max_bounces,
            fog_steps=self.fog_steps, **kw)
        with span("vt:acc_add"):
            self.acc.add(radiance)

    @spanned("vt:sample")
    def sample_batch(self, cam: vcam.Camera, sun: np.ndarray, k: int):
        """Accumulate k samples traced as one batch (on the Renderer's
        device, with or without ``devices``)."""
        sun_t = self._begin(cam, sun)
        seeds = self._seeds(k)
        kw = self._engine_kw(cam)
        total = render_samples(
            *self._args(cam, kw["soup"]), sun_t, seeds, self.width,
            self.height, max_bounces=self.max_bounces,
            fog_steps=self.fog_steps, **kw)
        with span("vt:acc_add"):
            self.acc.add(total, k)

    @spanned("vt:preview")
    def preview_frame(self, cam: vcam.Camera, sun: np.ndarray):
        """Shaded primary-visibility frame for interactive preview
        (software.rs:260-276 shading on the rasterized first hit), on the
        pose's cached bins. Tiles the rasterizer cannot prove complete
        are not re-cast (preview only; the path-traced accumulation stays
        exact). Without a soup (hf-only mode) the frame is the exact
        ``hf_frame_cast``. Returns (H, W, 3) linear radiance, or None when
        the world has neither."""
        _, sun_t = self._sun(sun)
        soup = self._get_soup()
        if soup is None:
            return self._hf_preview(cam, sun_t)
        with span("vt:frame_cast"):
            r = raster.raster_cast(
                *soup, np.asarray(cam.pos, np.float32), cam.basis(),
                self.world.height, self.width, self.height,
                bins=self._get_soup_bins(cam, soup), want_voxel=False)
        lighting = dot(sun_t, r["normal"]) / 2.0 + 1.0
        return r["rgb"] * lighting[..., None] * r["hit"][..., None]

    def _hf_preview(self, cam: vcam.Camera, sun_t):
        """``preview_frame`` on the heightfield engine: exact primaries,
        the same shading. On unedited (or heightfield-exact) terrain the
        frame cast resumed by the pose's envelope; with tracked edit
        bounds the hybrid cast, its pre-edit walk resumed by the envelope
        and placed blocks shaded by their own leaf."""
        hf_mips, hf_offsets, terrain_rgb = self._get_hf()
        if hf_mips is None:
            return None
        pos = np.asarray(cam.pos, np.float32)
        bounds = self._hf_bounds()
        env = self._get_sky_env(cam)
        if bounds is None:
            with span("vt:frame_cast"):
                r = heightfield.hf_frame_cast(
                    hf_mips, hf_offsets, self.world.height, pos,
                    cam.basis(), self.width, self.height, terrain_rgb,
                    sky_env=env)
            rgb = r["rgb"]
        else:
            _, d = vcam.generate_rays(cam, self.width, self.height,
                                      device=self.device)
            w = self.world
            with span("vt:frame_cast"):
                r = heightfield.hf_raycast_edited(
                    hf_mips, hf_offsets, w.height, w.table, w.root, bounds,
                    torch.from_numpy(pos).to(self.device), d, sky_env=env)
            rgb = torch.where((r["node"] >= 0)[..., None],
                              leaf_rgb(w.table, r["node"]),
                              terrain_rgb.expand(r["normal"].shape)) \
                * r["hit"][..., None]
        lighting = dot(sun_t, r["normal"]) / 2.0 + 1.0
        return rgb * lighting[..., None] * r["hit"][..., None]

    def render(self, cam, sun, spp: int, batch: int = 8):
        done = 0
        while done < spp:
            if self.mesh is not None:
                self.sample(cam, sun)  # one step: a sample on each shard
                done += self.mesh.global_size
                continue
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
    sample's radiance is the same either way. A Renderer with ``devices``
    takes one sharded step a call (N samples; a frame whose count is no
    multiple of N ends with the first count past it)."""
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
                if k > 1 and renderer.mesh is None:
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
