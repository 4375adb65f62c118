"""The reference's world: the terrain heightfield plus point edits, and
the first-hit cast over it.

The geometry is worked out again from the heightmap and the edit list
alone. Without edits a cast is the heightfield walk (``terrain.py``).
With edits the world is the union of two solids that together make it
exactly:

* the terrain lowered under every edited column to the lowest edited
  voxel of that column (``h_low``), walked as a heightfield, and
* a dense box over the edited columns, from the lowest ``h_low`` of the
  box up past the highest solid voxel, holding every voxel of the edited
  world there: the terrain below ``h``, then each edit in order.

The first hit of a union is the nearer of the two first hits, so a cast
is the walk on ``h_low`` and a DDA through the box, the nearer taken.
Several edit states (the world after k edits, for several k) share one
walk and one box: the box holds one layer a state, and each lane names
its state.

Voxel codes in the box: 0 air, 1 terrain (``TERRAIN_RGB``), 2 a placed
block, white and emissive (rgb (1, 1, 1)).
"""

from __future__ import annotations

import numpy as np
import torch

from vtbench.reference import terrain
from vtbench.reference.terrain import EPS, FAR, TERRAIN_RGB
from vtbench.reference.vecmath import hmax, hmin

AIR, SOIL, WHITE = 0, 1, 2
MAX_BOX_VOXELS = 1 << 28  # states x box voxels the reference holds


class World:
    """``heights``: uint32 [x, z] numpy heightmap of a 2^height world.
    ``states``: None (the terrain alone) or a list of edit lists, each a
    list of ((x, y, z), rgb or None) applied in order (None deletes)."""

    def __init__(self, heights, device, states=None):
        self.heights = np.asarray(heights)
        n = self.heights.shape[0]
        self.height = int(np.log2(n))
        self.n = n
        self.device = torch.device(device)
        self.box = None
        low = self.heights
        if states and any(len(s) for s in states):
            low = self._edit_box(states)
        tiles, offsets, _ = terrain.build_height_mips(low, device=device)
        self.tiles, self.offsets = tiles, offsets
        self.hmax_w = terrain.terrain_max(tiles, offsets)
        self.terrain_rgb = torch.tensor(TERRAIN_RGB, dtype=torch.float32,
                                        device=device)

    def _edit_box(self, states):
        h = self.heights.astype(np.int64)
        vox = np.array([v for s in states for v, _ in s], np.int64)
        low = h.copy()
        for x, y, z in vox:
            low[x, z] = min(low[x, z], y)
        x0, z0 = vox[:, 0].min(), vox[:, 2].min()
        x1, z1 = vox[:, 0].max() + 1, vox[:, 2].max() + 1
        y0 = int(low[x0:x1, z0:z1].min())
        y1 = int(max(h[x0:x1, z0:z1].max(), vox[:, 1].max() + 1))
        shape = (x1 - x0, y1 - y0, z1 - z0)
        if len(states) * int(np.prod(shape)) > MAX_BOX_VOXELS:
            raise ValueError(f"reference: an edit box of {shape} voxels in "
                             f"{len(states)} states is more than it holds")
        ys = np.arange(y0, y1)[None, :, None]
        base = np.where(ys < h[x0:x1, None, z0:z1], SOIL, AIR).astype(np.int8)
        grid = np.repeat(base[None], len(states), axis=0)
        for k, s in enumerate(states):
            for (x, y, z), rgb in s:
                code = AIR if rgb is None else WHITE
                if rgb is not None and tuple(rgb) != (1.0, 1.0, 1.0):
                    raise ValueError("reference: only white blocks are placed")
                grid[k, x - x0, y - y0, z - z0] = code
        self.box = (np.array([x0, y0, z0], np.float32),
                    np.array([x1, y1, z1], np.float32),
                    torch.from_numpy(grid).to(self.device))
        return low.astype(np.uint32)

    def cast(self, start, d, distance=FAR, active=None, state=None,
             skip_t0=True, touched=None):
        """First hits of rays (B, 3) from ``start`` (B, 3) along unit
        ``d``: dict hit, t, normal (B, 3), voxel (B, 3) int32, rgb (B, 3).
        ``distance``: scalar or (B,) strict cap; ``active``: (B,) bool;
        ``state``: (B,) int64 edit state of each lane (0 without);
        ``touched``: the pack's sectors the heightfield walk reads are
        marked in it (``terrain.pack_sectors(self.tiles)``)."""
        B = d.shape[0]
        dev = d.device
        start = start.expand(B, 3).contiguous()
        dist = torch.as_tensor(distance, dtype=torch.float32,
                               device=dev).expand(B).contiguous()
        r = terrain.hf_raycast_plain(
            self.tiles, self.offsets, self.height, start, d, dist,
            skip_t0=skip_t0, active=active, hmax_w=self.hmax_w,
            touched=touched)
        rgb = self.terrain_rgb.expand(B, 3)
        if self.box is None:
            return dict(r, rgb=rgb * r["hit"][:, None])
        b = self._box_cast(start, d, dist, active, state, skip_t0)
        near = b["hit"] & (~r["hit"] | (b["t"] < r["t"]))
        out = {k: torch.where(near[:, None] if r[k].dim() == 2 else near,
                              b[k], r[k]) for k in ("hit", "t", "normal",
                                                    "voxel")}
        out["rgb"] = torch.where(near[:, None], b["rgb"], rgb) \
            * out["hit"][:, None]
        return out

    def _box_cast(self, start, d, dist, active, state, skip_t0):
        """DDA through the edit box in the walk's mirrored coordinates:
        ``s0 = flip ? n - start : start``, planes at integers, a lane in
        the cell ahead of it (the mirrored floor)."""
        lo, hi, grid = self.box
        B = d.shape[0]
        dev = d.device
        f32, i64 = torch.float32, torch.int64
        bound = float(self.n)
        lo_t = torch.from_numpy(lo).to(dev)
        hi_t = torch.from_numpy(hi).to(dev)
        flip = d < 0.0
        dd = torch.clamp_min(torch.abs(d), EPS)
        inv_d = torch.div(torch.ones_like(dd), dd)
        s0 = torch.where(flip, bound - start, start)
        lo_m = torch.where(flip, bound - hi_t, lo_t)
        hi_m = torch.where(flip, bound - lo_t, hi_t)
        t_lo = (lo_m - s0) * inv_d
        t_hi = (hi_m - s0) * inv_d
        t_in = torch.clamp_min(hmax(t_lo), 0.0)
        t_out = hmin(t_hi)
        ax_in = torch.where(t_lo[:, 0] == t_in, 0, torch.where(
            t_lo[:, 1] == t_in, 1, 2))
        inside = (s0 >= lo_m).all(dim=1) & (s0 < hi_m).all(dim=1)
        live = (t_in < t_out) & (t_in <= dist)
        if active is not None:
            live = live & active
        pm = s0 + dd * t_in[:, None]
        cell = torch.floor(pm)
        axes = torch.arange(3, device=dev)
        entered = ~inside
        cell = torch.where((axes == ax_in[:, None]) & entered[:, None],
                           lo_m.expand(B, 3), cell)
        cell = torch.minimum(torch.maximum(cell, lo_m), hi_m - 1.0)
        t = torch.where(inside, 0.0, t_in)
        axis = torch.where(inside, 3, ax_in)
        st = torch.zeros(B, dtype=i64, device=dev) if state is None \
            else state.to(i64)
        S, X, Y, Z = grid.shape
        hit = torch.zeros(B, dtype=torch.bool, device=dev)
        hit_t = torch.zeros(B, dtype=f32, device=dev)
        hit_axis = torch.full((B,), 3, dtype=i64, device=dev)
        hit_vox = torch.zeros((B, 3), dtype=i64, device=dev)
        hit_code = torch.zeros(B, dtype=torch.int8, device=dev)
        flat = grid.reshape(-1)
        lo_i = torch.from_numpy(lo.astype(np.int64)).to(dev)
        first = torch.ones(B, dtype=torch.bool, device=dev)
        while bool(live.any()):
            vox = torch.where(flip, (bound - 1.0) - cell, cell).to(i64)
            loc = vox - lo_i
            idx = ((st * X + loc[:, 0]) * Y + loc[:, 1]) * Z + loc[:, 2]
            code = flat[torch.where(live, idx, 0)]
            solid = live & (code != AIR)
            skip = skip_t0 & first & (t == 0.0)
            rec = solid & ~skip & (t <= dist)
            hit = hit | rec
            hit_t = torch.where(rec, t, hit_t)
            hit_axis = torch.where(rec, axis, hit_axis)
            hit_vox = torch.where(rec[:, None], vox, hit_vox)
            hit_code = torch.where(rec, code, hit_code)
            live = live & ~rec
            t_next = (cell + 1.0 - s0) * inv_d
            tn = hmin(t_next)
            a = torch.where(t_next[:, 0] == tn, 0, torch.where(
                t_next[:, 1] == tn, 1, 2))
            step = axes == a[:, None]
            cell = torch.where(step, cell + 1.0, cell)
            t = torch.where(live, tn, t)
            axis = torch.where(live, a, axis)
            first = torch.zeros_like(first)
            live = live & (cell < hi_m).all(dim=1) & (tn <= dist) \
                & (tn < t_out + 1.0)
        normal = torch.where(hit_axis[:, None] == axes, -torch.sign(d), 0.0) \
            * hit[:, None].to(f32)
        white = (hit_code == WHITE)[:, None]
        rgb = torch.where(white, 1.0, self.terrain_rgb.expand(B, 3))
        return dict(hit=hit, t=hit_t, normal=normal,
                    voxel=hit_vox.to(torch.int32), rgb=rgb)
