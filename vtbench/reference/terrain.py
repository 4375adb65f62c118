"""The reference's terrain: the heightmap from the reference's noise, its
max-mip pack, and the plain heightfield walk.

Frozen copies of the port's plain arithmetic (``voxtracer_torch/world/
worldgen.py:heightmap`` and ``voxtracer_torch/kernels/heightfield.py``:
``build_height_mips``, ``hf_raycast_plain``), kept beside the reference
so that it imports nothing of the program; the walk's step counters and
statistics are left out. The reference derives its heightmap from the
configuration's noise seeds and builds its own pack from it: it reads no
geometry the program made.

A terrain world is exactly a heightfield: voxel (x, y, z) is solid iff
``y < h[x, z]``. The walk follows the SVO traversal's semantics (hits at
t == 0 skipped, a start inside solid hits at its next unit-plane crossing
if that voxel is solid too, entry-axis priority x > y > z, a STRICT
``distance``).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vtbench.reference.noise import fbm2, simplex2
from vtbench.reference.vecmath import div, hmax, hmin

EPS = 1.0e-6  # raytrace.wgsl:53
FAR = 1.0e12  # "no cap" distance (raytrace.wgsl:343)
MAX_LEVELS = 16
SEED_SCALE = 0xAFE29979  # worldgen.rs:14
SEED_NOISE = 0x1C766E2E  # worldgen.rs:15
REFERENCE_LOG2_SIZE = 13  # worldgen.rs:17
TERRAIN_RGB = (0.5, 0.5, 0.5)  # every terrain voxel


def heightmap(log2_size: int, seed_scale: int = SEED_SCALE,
              seed_noise: int = SEED_NOISE, device="cpu") -> np.ndarray:
    """Terrain height per column, uint32[n, n] indexed [x, z], in [0, n].

    ``base = simplex(x/2048, z/2048) + 1``; ``height = floor((fbm(x/512,
    z/512) + 1 + base) * 256 * base^3 + 64)`` (worldgen.rs:18-24), with
    coordinates and height rescaled by size/8192 below the flagship size.
    """
    n = 1 << log2_size
    world_scale = (1 << REFERENCE_LOG2_SIZE) / n  # 1.0 at the flagship size
    ar = torch.arange(n, dtype=torch.float32, device=device) * world_scale
    x = ar[:, None]
    z = ar[None, :]
    base = simplex2(x / 2048.0, z / 2048.0, seed=seed_scale & 0x7FFFFFFF) + 1.0
    scale = base * base * base
    fn = fbm2((x / 512.0).expand(n, n), (z / 512.0).expand(n, n),
              seed=seed_noise & 0x7FFFFFFF, octaves=7)
    nval = fn + 1.0 + base
    h = torch.floor(div(nval * 256.0 * scale + 64.0, world_scale))
    return torch.clamp(h, 0, n).to(torch.int64).cpu().numpy().astype(np.uint32)


def _top_child_level(height: int, tl: int) -> int:
    """Coarsest walk level that is a multiple of the tile log: the
    largest multiple of ``tl`` <= height - 1, so the top tile's parent
    row covers the whole (possibly partial, zero-padded) grid."""
    if height <= 1:
        return 0
    return tl * ((height - 1) // tl)


def _partial_row(m: np.ndarray, TS: int) -> np.ndarray:
    """A grid smaller than one tile as its single zero-padded row."""
    r = np.zeros((TS, TS), np.float32)
    r[:m.shape[0], :m.shape[1]] = m
    return r.reshape(1, TS * TS)


def build_height_mips(heights, tile_log: int = 3, device="cpu"):
    """Tiled max-mip pyramid of the column heightmap (module doc).

    heights: (n, n) integer array indexed [x, z], values in [0, n] (numpy:
    this package's ``worldgen.heightmap`` or the JAX package's). Returns
    ``(tiles, offsets, height)``: ``tiles`` a contiguous float32 (R,
    TS*TS) tensor on ``device``, level-0 rows holding the exact column
    heights, slot (x & TS-1) * TS + (z & TS-1); ``offsets`` the tuple
    (tile_log, row starts...); ``height`` log2 n. A grid that does not
    fill a tile (the top level of a tree whose height - 1 is no multiple
    of tile_log) is one zero-padded row."""
    tl = tile_log
    TS = 1 << tl
    h = np.asarray(heights)
    n = h.shape[0]
    if h.shape != (n, n) or n & (n - 1):
        raise ValueError(f"build_height_mips: heights {h.shape} is not a "
                         "square power of two")
    height = int(math.log2(n))
    ltop = _top_child_level(height, tl)

    cur = h.astype(np.float32)
    rows, offsets, off = [], [tl], 0
    for lvl in range(ltop + 1):
        if lvl:
            cur = np.maximum.reduce([cur[0::2, 0::2], cur[0::2, 1::2],
                                     cur[1::2, 0::2], cur[1::2, 1::2]])
        if lvl % tl:
            continue
        dc = cur.shape[0]
        if dc >= TS:
            dp = dc // TS
            r = np.ascontiguousarray(
                cur.reshape(dp, TS, dp, TS).transpose(0, 2, 1, 3)
            ).reshape(dp * dp, TS * TS)
        else:
            r = _partial_row(cur, TS)
        rows.append(r)
        offsets.append(off)
        off += r.shape[0]
    if len(offsets) - 1 > MAX_LEVELS:
        raise ValueError("build_height_mips: too many levels for the kernel")
    tiles = torch.from_numpy(np.concatenate(rows, axis=0)).to(device)
    return tiles, tuple(offsets), height


SECTOR_FLOATS = 8  # float32 heights in a 32-byte sector of the pack


def pack_sectors(tiles):
    """A bool tensor of the pack's 32-byte sectors, none marked: what
    ``hf_raycast_plain`` marks the sectors its walk reads in."""
    return torch.zeros(-(-tiles.numel() // SECTOR_FLOATS), dtype=torch.bool,
                       device=tiles.device)


def terrain_max(tiles, offsets: tuple):
    """The global terrain maximum as a (1,) tensor on the pack's device:
    the top row is the coarsest block, so its max is the world's. A cast
    reads it on the device; nothing crosses to the host."""
    return tiles[offsets[-1]].max().reshape(1)


def hf_raycast_plain(tiles, offsets: tuple, height: int, start, d, distance,
                     skip_t0: bool = True, active=None, t_min=None,
                     init_desc: int = 0, hmax_w=None, touched=None):
    """Plain PyTorch version of K4 on flattened lanes: start/d (B, 3),
    distance (B,), active (B,) bool or None, t_min (B,) or None. The same
    arithmetic as the kernel and as ``voxtracer/kernels/heightfield.py``
    (``_hf_init``, ``_hf_body`` one cell a step, ``_hf_finalize``).
    ``touched``: None, or a bool tensor of one entry a 32-byte sector of
    ``tiles`` (``pack_sectors``) in which the walk marks each sector it
    reads."""
    B = d.shape[0]
    dev = d.device
    H = height
    i32, i64, f32 = torch.int32, torch.int64, torch.float32
    bound = float(1 << H)
    n = 1 << H
    tl = offsets[0]
    TS = 1 << tl
    W = TS * TS
    flat = tiles.reshape(-1)
    base = torch.tensor(offsets[1:], dtype=i64, device=dev)
    if hmax_w is None:
        hmax_w = terrain_max(tiles, offsets)

    flip = d < 0.0
    d_sign = torch.sign(d)
    dd = torch.clamp_min(torch.abs(d), EPS)
    inv_d = torch.div(torch.ones_like(dd), dd)
    s0 = torch.where(flip, bound - start, start)

    # an ascending lane cannot hit above the terrain's maximum: its
    # strict cap shrinks to where y crosses it (2 voxels of slack)
    t_clear = (hmax_w + 2.0 - s0[:, 1]) * inv_d[:, 1]
    distance = torch.where(
        ~flip[:, 1], torch.minimum(distance, torch.clamp_min(t_clear, 0.0)),
        distance)

    enter = -s0 * inv_d
    # +0.0 where the latest entry is -0.0 (a start on the mirrored low
    # face), as XLA's max gives it
    t0 = hmax(enter)
    t0 = torch.where(t0 > 0.0, t0, 0.0)
    ex = enter[:, 0] == t0
    ey = ~ex & (enter[:, 1] == t0)
    ez = ~ex & ~ey & (enter[:, 2] == t0)
    axis0 = torch.where(ex, 0, torch.where(ey, 1, torch.where(ez, 2, 3)))
    if t_min is not None:
        t0 = torch.maximum(t0, t_min)
    tend = hmin((bound - s0) * inv_d)
    alive = torch.minimum(tend, distance) >= t0
    if active is not None:
        alive = alive & active

    dp0 = max(n >> tl, 1)

    def col_h(vx, vz, inb, need):
        """Exact column height at un-mirrored (vx, vz); 0 where ~inb.
        ``need``: the lanes whose walk uses the height (marked)."""
        vx = torch.where(inb, vx, 0).to(i64)
        vz = torch.where(inb, vz, 0).to(i64)
        idx = (base[0] + (vx >> tl) * dp0 + (vz >> tl)) * W \
            + (vx & (TS - 1)) * TS + (vz & (TS - 1))
        if touched is not None:
            touched[idx[inb & need] // SECTOR_FLOATS] = True
        return torch.where(inb, flat[idx], 0.0)

    def unmirror(vm):
        return torch.where(flip, (bound - 1.0) - vm, vm).to(i32)

    def inside(v):
        return ((v >= 0) & (v < n)).all(dim=1)

    # occupancy at t = 0+: the mirrored floor of the start
    v0 = unmirror(torch.floor(s0))
    inb0 = inside(v0) & (t0 == 0.0)
    inside0 = inb0 & (v0[:, 1].to(f32)
                      < col_h(v0[:, 0], v0[:, 2], inb0, alive))

    # the next unit-plane crossing after 0
    npl = torch.floor(s0) + 1.0
    t_ax = (npl - s0) * inv_d
    t_n = hmin(t_ax)
    nx = t_ax[:, 0] == t_n
    ny = ~nx & (t_ax[:, 1] == t_n)
    n_axis = torch.where(nx, 0, torch.where(ny, 1, 2))
    axes = torch.arange(3, device=dev)
    pm = s0 + dd * t_n[:, None]
    vox_m = torch.where(n_axis[:, None] == axes, npl, torch.floor(pm))
    vox_n = unmirror(vox_m)
    inb_n = inside(vox_n)
    n_solid = inb_n & (vox_n[:, 1].to(f32)
                       < col_h(vox_n[:, 0], vox_n[:, 2], inb_n,
                               alive & inside0))

    # root descent by strict midplane picks to the start level
    ltop = _top_child_level(H, tl)
    lstart = max(ltop - tl * init_desc, 0)
    cx = torch.zeros((B,), dtype=i64, device=dev)
    cz = torch.zeros((B,), dtype=i64, device=dev)
    for lvl in range(H, lstart, -1):
        half = float(1 << (lvl - 1))
        tbx = ((2 * cx + 1).to(f32) * half - s0[:, 0]) * inv_d[:, 0]
        tbz = ((2 * cz + 1).to(f32) * half - s0[:, 2]) * inv_d[:, 2]
        cx = 2 * cx + (tbx < t0).to(i64)
        cz = 2 * cz + (tbz < t0).to(i64)

    t = t0
    axis = axis0
    L = torch.full((B,), lstart, dtype=i64, device=dev)
    if skip_t0:
        # a start inside solid: the hit at t == 0 is skipped; the next
        # crossing is the hit if that voxel is solid too, else the walk
        # resumes there, in the entered voxel's column
        rec0 = alive & inside0 & n_solid & (t_n <= distance)
        hit = rec0.clone()
        hit_t = torch.where(rec0, t_n, 0.0)
        hit_axis = torch.where(rec0, n_axis, 3)
        hit_voxel = torch.where(rec0[:, None], vox_n, 0)
        resume = inside0 & ~n_solid
        t = torch.where(resume, t_n, t)
        axis = torch.where(resume, n_axis, axis)
        L = torch.where(resume, 0, L)
        cx = torch.where(resume, vox_m[:, 0].to(i64), cx)
        cz = torch.where(resume, vox_m[:, 2].to(i64), cz)
        alive = alive & ~(inside0 & n_solid) \
            & ~(inside0 & (t_n > distance)) & ~(resume & ~inb_n)
    else:
        rec0 = alive & inside0
        hit = rec0.clone()
        hit_t = torch.zeros((B,), dtype=f32, device=dev)
        hit_axis = torch.where(rec0, axis, 3)
        hit_voxel = torch.where(rec0[:, None], v0, 0)
        alive = alive & ~inside0

    # live-lane state; lane[k] is the output row of live lane k
    lane = torch.nonzero(alive).squeeze(1)
    t, axis, L, cx, cz = t[lane], axis[lane], L[lane], cx[lane], cz[lane]
    s0x, s0y, s0z = s0[lane, 0], s0[lane, 1], s0[lane, 2]
    ix, iy, iz = inv_d[lane, 0], inv_d[lane, 1], inv_d[lane, 2]
    ddy = dd[lane, 1]
    fx, fy, fz = flip[lane, 0], flip[lane, 1], flip[lane, 2]
    dist, tend = distance[lane], tend[lane]

    while lane.numel():
        dc = n >> L  # child grid dim
        dp = torch.clamp_min(dc >> tl, 1)
        cell = (torch.ones_like(L) << L).to(f32)  # 2^L exactly
        tox = ((cx + 1).to(f32) * cell - s0x) * ix
        toz = ((cz + 1).to(f32) * cell - s0z) * iz
        t_out = torch.minimum(tox, toz)

        # the cell's max height: one float of its parent's row
        ucx = torch.where(fx, dc - 1 - cx, cx)
        ucz = torch.where(fz, dc - 1 - cz, cz)
        row = base[torch.div(L, tl, rounding_mode="floor")] \
            + (ucx >> tl) * dp + (ucz >> tl)
        at = row * W + (ucx & (TS - 1)) * TS + (ucz & (TS - 1))
        if touched is not None:
            touched[at // SECTOR_FLOATS] = True
        maxh = flat[at]

        # where the ray crosses the plane y == maxh, and whether it is
        # below it somewhere in [t, t_out) (strict: a graze stays above)
        mplane = torch.where(fy, bound - maxh, maxh)
        t_m = (mplane - s0y) * iy
        dip = torch.where(fy, t_m < t_out, t < t_m) & (maxh > 0.0)

        # column test (L == 0): entry into the solid span [0, h)
        at_col = L == 0
        t_solid = torch.where(fy, torch.maximum(t, t_m), t)
        in_col = torch.where(fy, t_solid < t_out, dip)
        col_hit = at_col & dip & in_col & (t_solid < tend)
        top_face = fy & (t_m > t)  # entered through y == h
        if skip_t0:
            # a lane that starts exactly on a boundary was placed in the
            # cell behind it: its t == 0 record is the skipped leaf
            col_hit = col_hit & (t_solid != 0.0)
        over = col_hit & (t_solid > dist)
        rec = col_hit & ~over
        if rec.any():
            out = lane[rec]
            pm_y = s0y[rec] + ddy[rec] * t_solid[rec]
            y_m = torch.floor(pm_y)
            y_e = torch.where(fy[rec], bound - 1.0 - y_m, y_m)
            top = maxh[rec] - 1.0
            y_vox = torch.where(
                top_face[rec], top,
                torch.minimum(torch.clamp_min(y_e, 0.0),
                              torch.clamp_min(top, 0.0)))
            hit[out] = True
            hit_t[out] = t_solid[rec]
            hit_axis[out] = torch.where(top_face[rec], 1, axis[rec])
            hit_voxel[out] = torch.stack(
                [ucx[rec], y_vox.to(i64), ucz[rec]], dim=1).to(i32)

        # descend (dip above the columns): tl chained strict picks
        do_desc = dip & ~at_col
        gcx, gcz = cx, cz
        sub = cell
        for _ in range(tl):
            sub = sub * 0.5
            tbx = ((2 * gcx + 1).to(f32) * sub - s0x) * ix
            tbz = ((2 * gcz + 1).to(f32) * sub - s0z) * iz
            gcx = 2 * gcx + (tbx < t).to(i64)
            gcz = 2 * gcz + (tbz < t).to(i64)

        # advance (no dip, or a column not entered): x before z on ties;
        # leaving the tile coarsens tl levels onto the neighbour cell
        adv = ~do_desc & ~col_hit
        ax_x = tox <= toz
        acx = cx + (adv & ax_x).to(i64)
        acz = cz + (adv & ~ax_x).to(i64)
        gone = adv & ((acx >= dc) | (acz >= dc))
        in_tile = adv & ((acx >> tl) == (cx >> tl)) \
            & ((acz >> tl) == (cz >> tl))
        exit_t = adv & ~in_tile & ~gone
        dead = col_hit | gone | (adv & ((t_out > dist) | (t_out >= tend)))

        L = torch.where(do_desc, L - tl, torch.where(exit_t, L + tl, L))
        cx = torch.where(do_desc, gcx, torch.where(
            exit_t, acx >> tl, torch.where(in_tile, acx, cx)))
        cz = torch.where(do_desc, gcz, torch.where(
            exit_t, acz >> tl, torch.where(in_tile, acz, cz)))
        t = torch.where(adv, t_out, t)
        axis = torch.where(adv, torch.where(ax_x, 0, 2), axis)

        if bool(dead.any()):
            keep = ~dead
            lane, t, axis, L, cx, cz = (lane[keep], t[keep], axis[keep],
                                        L[keep], cx[keep], cz[keep])
            s0x, s0y, s0z = s0x[keep], s0y[keep], s0z[keep]
            ix, iy, iz, ddy = ix[keep], iy[keep], iz[keep], ddy[keep]
            fx, fy, fz = fx[keep], fy[keep], fz[keep]
            dist, tend = dist[keep], tend[keep]

    normal = torch.where(hit_axis[:, None] == axes, -d_sign, 0.0) \
        * hit[:, None].to(f32)
    return dict(hit=hit, t=hit_t, normal=normal, voxel=hit_voxel)
