"""Heightfield ray casts over terrain columns: CUDA kernel K4
(csrc/hf_cast.cu) and its plain PyTorch version.

A generated world is exactly a heightfield: voxel (x, y, z) is solid iff
``y < h[x, z]``. Casting a ray is then a walk over a 2-D max-mip quadtree
of the columns instead of the 3-D octree: descend into an (x, z) cell
only when the ray's y over the cell's t-interval dips below the cell's
maximum height. Semantics are ``voxtracer/kernels/heightfield.py``
(``hf_raycast``) exactly, and through it the SVO traversal's: the
mirrored arithmetic ``s0 = flip ? bound - start : start``, ``inv_d =
1/max(|d|, EPS)``, ``t = (mirrored integer plane - s0) * inv_d``; hits at
t == 0 skipped (``skip_t0``), a ray that starts inside solid hits at its
next unit-plane crossing if that voxel is solid too; entry-axis priority
x > y > z; a STRICT ``distance`` (the traversal's is advisory).

The pack (``build_height_mips``) is the JAX package's, bit for bit: rows
of TS*TS floats (TS = 2**tile_log), row r the TS x TS children of one
parent cell ``tile_log`` levels down, for every child level 0,
tile_log, 2*tile_log, ..; ``offsets = (tile_log, row start of level 0,
of level tile_log, ...)``.

Every crossing t is an integer-valued float times a power of two and a
hit is only ever recorded by the column-level test, so which cells are
dip-tested on the way is a choice of schedule that cannot change an
output bit. The JAX package walks ``tile_steps`` cells per row gather and
compacts lanes between loop segments, because a gather on the TPU is
serialized per row; here a lane reads the one float it needs and takes
one cell per step. ``hf_raycast_plain`` walks all live lanes in lockstep,
drops lanes as they finish and counts the steps (``plain_lane_steps``);
the kernel takes the same steps, one thread a ray.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.core.vecmath import hmax, hmin
from voxtracer_torch.kernels import build
from voxtracer_torch.kernels.skyline import env_tmin
from voxtracer_torch.kernels.traverse import EPS, FAR, _lanes, svo_raycast
from voxtracer_torch.utils import profiling

MAX_LEVELS = 16  # row starts the kernel holds in shared memory
TILE_LOGS = (1, 2, 3)  # the kernel's instantiations (3 in production)
# lane fetch (csrc/lanes.cuh), as for K2
STATIC_PCT, CHUNK, REFILL = 75, 32, 4

# walk steps summed over lanes by the plain version since the last reset:
# the kernel takes the same steps, so this is its work for these rays
plain_lane_steps = 0
MOVES = ("descend", "in tile", "coarsen", "end")  # hf_raycast_plain's walk=


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


def build_height_mips(heights, tile_log: int = 3, device="cuda"):
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


def mips_from_numpy(flat_mips, offsets, height, device="cuda"):
    """A pack built elsewhere (the JAX package's ``build_height_mips``
    result, its array as numpy) as this module's ``(tiles, offsets,
    height)``."""
    tiles = torch.from_numpy(np.array(flat_mips, np.float32))
    return tiles.to(device), tuple(int(o) for o in offsets), int(height)


def patch_height_mips(tiles, offsets: tuple, height: int, heights, cols):
    """Update the pack IN PLACE after ``heights[x, z]`` changed for the
    columns ``cols`` (iterable of (x, z)): every row whose tile holds an
    edited column, at every level, is recomputed on the host from the
    post-edit ``heights`` and written with one ``index_copy_``. Equal to
    a fresh ``build_height_mips(heights)`` bit for bit. Returns
    ``tiles``."""
    h = np.asarray(heights)
    n = h.shape[0]
    tl = offsets[0]
    TS = 1 << tl
    ltop = _top_child_level(height, tl)
    rows, vals = [], []
    for lc_i, lc in enumerate(range(0, ltop + 1, tl)):
        dc = n >> lc  # child grid dim at this level
        cell = 1 << lc
        if dc < TS:  # the partial top grid: its one row
            m = h.reshape(dc, cell, dc, cell).max(axis=(1, 3))
            rows.append(offsets[1 + lc_i])
            vals.append(_partial_row(m.astype(np.float32), TS)[0])
            continue
        dp = dc // TS
        span = TS * cell
        for px, pz in sorted({(x // span, z // span) for x, z in cols}):
            blk = h[px * span:(px + 1) * span, pz * span:(pz + 1) * span]
            m = blk.reshape(TS, cell, TS, cell).max(axis=(1, 3))
            rows.append(offsets[1 + lc_i] + px * dp + pz)
            vals.append(m.astype(np.float32).reshape(-1))
    if rows:
        tiles.index_copy_(
            0, torch.as_tensor(rows, dtype=torch.int64, device=tiles.device),
            torch.from_numpy(np.stack(vals)).to(tiles.device))
    return tiles


def terrain_max(tiles, offsets: tuple):
    """The global terrain maximum as a (1,) tensor on the pack's device:
    the top row is the coarsest block, so its max is the world's. A cast
    reads it on the device; nothing crosses to the host."""
    return tiles[offsets[-1]].max().reshape(1)


_row_starts = {}  # (offsets, device) -> the row starts as an int32 tensor


def row_starts(offsets: tuple, device):
    """``offsets[1:]`` on ``device`` (int32), copied there once."""
    key = (offsets, str(device))
    if key not in _row_starts:
        _row_starts[key] = torch.tensor(offsets[1:], dtype=torch.int32,
                                        device=device)
    return _row_starts[key]


def hf_raycast(tiles, offsets: tuple, height: int, start, d, distance=FAR,
               skip_t0: bool = True, active=None, t_min=None,
               init_desc: int | None = None, hmax_w=None, sky_env=None):
    """Cast rays against the heightfield terrain (module doc).

    tiles/offsets/height: the pack. start, d: (..., 3) float32 (start
    broadcasts); distance: scalar or (...,) STRICT far cap; active:
    optional (...,) bool lane mask. ``t_min``: optional per-ray
    (broadcastable) resume: the walk starts at ``max(world entry t,
    t_min)``, and the caller guarantees the ray is in air up to and
    including it. ``sky_env``: optional ``(E, d0, g[, K[, S]])``, the horizon
    envelope built for ``start`` (kernels/skyline.py), in place of
    ``t_min``: each ray resumes at its certified-air ``t_min`` from K5,
    which changes no output bit. ``init_desc``: start the walk that many
    tile levels below the top (a choice of schedule: no output bit
    depends on it); None takes 3 with an envelope and 0 without, as the
    JAX package does. ``hmax_w``: ``terrain_max`` of the pack when the caller keeps it
    (computed here otherwise).

    Returns a dict of (...)-shaped tensors: hit (bool), t, normal (...,
    3), voxel (..., 3 int32); no ``node`` (every terrain voxel is one
    interned leaf, callers shade with the terrain colour).
    """
    if height < 1:
        raise ValueError("hf_raycast: height must be >= 1")
    start, d, distance, active, batch_shape = _lanes(start, d, distance,
                                                     active)
    if sky_env is not None:
        if t_min is not None:
            raise ValueError("hf_raycast: give t_min or sky_env, not both")
        # the rays in their batch shape: an image's go to K5 as one
        t_min = env_tmin(sky_env, d.reshape(batch_shape + (3,)))
    if init_desc is None:
        init_desc = 3 if sky_env is not None else 0
    if t_min is not None:
        t_min = torch.as_tensor(t_min, dtype=torch.float32, device=d.device)
        t_min = t_min.expand(batch_shape).reshape(-1).contiguous()
    if hmax_w is None:
        hmax_w = terrain_max(tiles, offsets)
    args = (tiles, offsets, height, start, d, distance, skip_t0, active,
            t_min, init_desc, hmax_w)
    if d.device.type == "cpu":
        out = hf_raycast_plain(*args)
    elif d.device.type == "cuda":
        out = _hf_raycast_cuda(*args)
    else:
        raise ValueError(f"hf_raycast: unsupported device {d.device}")
    return {k: v.reshape(batch_shape + v.shape[1:]) for k, v in out.items()}


def _hf_raycast_cuda(tiles, offsets, height, start, d, distance, skip_t0,
                     active, t_min, init_desc, hmax_w):
    dev = d.device
    if tiles.device != dev or tiles.dtype != torch.float32 \
            or tiles.dim() != 2 or not tiles.is_contiguous() \
            or tiles.shape[1] != (1 << offsets[0]) ** 2:
        raise ValueError("hf_raycast: tiles must be a contiguous float32 "
                         f"(R, TS*TS) tensor on {dev}")
    if hmax_w.device != dev or hmax_w.dtype != torch.float32:
        raise ValueError(f"hf_raycast: hmax_w must be float32 on {dev}")
    if len(offsets) - 1 > MAX_LEVELS or height > 30:
        raise ValueError("hf_raycast: pack too deep for the kernel")
    if offsets[0] not in TILE_LOGS:
        raise ValueError(f"hf_raycast: tile_log {offsets[0]} is not one of "
                         f"the kernel's {TILE_LOGS}")
    if tiles.numel() >= 1 << 31:
        raise ValueError(f"hf_raycast: a pack of {tiles.numel()} floats "
                         "overflows the kernel's 32-bit indices")
    B = d.shape[0]
    if B > build.MAX_LANES:
        raise ValueError(f"hf_raycast: {B} lanes > {build.MAX_LANES}")
    out = dict(
        hit=torch.empty((B,), dtype=torch.bool, device=dev),
        t=torch.empty((B,), dtype=torch.float32, device=dev),
        normal=torch.empty((B, 3), dtype=torch.float32, device=dev),
        voxel=torch.empty((B, 3), dtype=torch.int32, device=dev),
    )
    if B == 0:
        return out
    lib = build.library()
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    rows = row_starts(offsets, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.voxt_hf_cast(
            tiles.data_ptr(), int(offsets[0]), len(offsets) - 1,
            rows.data_ptr(), int(height), hmax_w.data_ptr(),
            start.data_ptr(), d.data_ptr(), distance.data_ptr(),
            None if active is None else active.data_ptr(),
            None if t_min is None else t_min.data_ptr(), int(bool(skip_t0)),
            int(init_desc), out["hit"].data_ptr(), out["t"].data_ptr(),
            out["normal"].data_ptr(), out["voxel"].data_ptr(), B,
            counter.data_ptr(), STATIC_PCT, CHUNK, REFILL, stream)
    build.check(err, "hf_raycast")
    profiling.count("launches.hf_cast")
    return out


def hf_raycast_plain(tiles, offsets: tuple, height: int, start, d, distance,
                     skip_t0: bool = True, active=None, t_min=None,
                     init_desc: int = 0, hmax_w=None, *, walk=None):
    """Plain PyTorch version of K4 on flattened lanes: start/d (B, 3),
    distance (B,), active (B,) bool or None, t_min (B,) or None. The same
    arithmetic as the kernel and as ``voxtracer/kernels/heightfield.py``
    (``_hf_init``, ``_hf_body`` one cell a step, ``_hf_finalize``).

    ``walk``: a dict to receive the walk's shape: ``per_lane`` (B,) int64,
    the steps each lane took (0 for a lane that never walked);
    ``by_level``, walk level -> lane-steps at that level; ``moves``, what
    the steps did (MOVES: descend, advance in the tile, coarsen past its
    edge, end the walk); ``iterations``, the loop's iterations (every
    walking lane starts at the first, so the longest lane's steps)."""
    global plain_lane_steps
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
    base = row_starts(offsets, dev).to(i64)
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

    def col_h(vx, vz, inb):
        """Exact column height at un-mirrored (vx, vz); 0 where ~inb."""
        vx = torch.where(inb, vx, 0).to(i64)
        vz = torch.where(inb, vz, 0).to(i64)
        idx = (base[0] + (vx >> tl) * dp0 + (vz >> tl)) * W \
            + (vx & (TS - 1)) * TS + (vz & (TS - 1))
        return torch.where(inb, flat[idx], 0.0)

    def unmirror(vm):
        return torch.where(flip, (bound - 1.0) - vm, vm).to(i32)

    def inside(v):
        return ((v >= 0) & (v < n)).all(dim=1)

    # occupancy at t = 0+: the mirrored floor of the start
    v0 = unmirror(torch.floor(s0))
    inb0 = inside(v0) & (t0 == 0.0)
    inside0 = inb0 & (v0[:, 1].to(f32) < col_h(v0[:, 0], v0[:, 2], inb0))

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
                       < col_h(vox_n[:, 0], vox_n[:, 2], inb_n))

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

    if walk is not None:
        per_lane = torch.zeros((B,), dtype=i64, device=dev)
        by_level = torch.zeros((MAX_LEVELS,), dtype=i64, device=dev)
        moves = torch.zeros((len(MOVES),), dtype=i64, device=dev)
    iterations = 0
    while lane.numel():
        plain_lane_steps += lane.numel()
        iterations += 1
        if walk is not None:
            by_level += torch.bincount(L // tl, minlength=MAX_LEVELS)
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
        maxh = flat[row * W + (ucx & (TS - 1)) * TS + (ucz & (TS - 1))]

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
        if walk is not None:
            moves += torch.stack([do_desc.sum(), (in_tile & ~dead).sum(),
                                  (exit_t & ~dead).sum(), dead.sum()])

        L = torch.where(do_desc, L - tl, torch.where(exit_t, L + tl, L))
        cx = torch.where(do_desc, gcx, torch.where(
            exit_t, acx >> tl, torch.where(in_tile, acx, cx)))
        cz = torch.where(do_desc, gcz, torch.where(
            exit_t, acz >> tl, torch.where(in_tile, acz, cz)))
        t = torch.where(adv, t_out, t)
        axis = torch.where(adv, torch.where(ax_x, 0, 2), axis)

        if bool(dead.any()):
            if walk is not None:
                per_lane[lane[dead]] = iterations
            keep = ~dead
            lane, t, axis, L, cx, cz = (lane[keep], t[keep], axis[keep],
                                        L[keep], cx[keep], cz[keep])
            s0x, s0y, s0z = s0x[keep], s0y[keep], s0z[keep]
            ix, iy, iz, ddy = ix[keep], iy[keep], iz[keep], ddy[keep]
            fx, fy, fz = fx[keep], fy[keep], fz[keep]
            dist, tend = dist[keep], tend[keep]

    if walk is not None:
        walk.update(per_lane=per_lane, iterations=iterations, by_level={
            tl * i: int(c) for i, c in enumerate(by_level.tolist()) if c},
            moves=dict(zip(MOVES, moves.tolist())))
    normal = torch.where(hit_axis[:, None] == axes, -d_sign, 0.0) \
        * hit[:, None].to(f32)
    return dict(hit=hit, t=hit_t, normal=normal, voxel=hit_voxel)


def hf_raycast_edited(tiles, offsets: tuple, height: int, table, root: int,
                      edit_bounds, start, d, distance=FAR, active=None,
                      sky_env=None, hmax_w=None):
    """Heightfield cast for an EDITED terrain world: K4 on the pre-edit
    pack, plus an exact SVO re-cast (K2) of the lanes whose segment can
    see the edits.

    Point edits confine every difference to ``edit_bounds``: (2, 3)
    float32 [lo, hi), or (K, 2, 3) for a list of boxes, each grown by at
    least one voxel by the caller. A lane's pre-edit result stands unless
    its ray reaches some box no later than that result, so only those
    lanes are re-cast against the current node table. The merge equals a
    pure ``svo_raycast`` of the edited world lane for lane (the
    integrator compares ``t <= cap`` after either: K4's cap is strict,
    K2's advisory).

    Returns hit/t/normal/voxel plus ``node`` (the SVO leaf of re-cast
    lanes, -1 where the heightfield answered) and ``from_svo`` (the
    re-cast mask). ``sky_env`` (hf_raycast) resumes the pre-edit walk
    only."""
    r1 = hf_raycast(tiles, offsets, height, start, d, distance=distance,
                    active=active, hmax_w=hmax_w, sky_env=sky_env)
    bshape = r1["hit"].shape
    dev = d.device
    p = torch.as_tensor(start, dtype=torch.float32, device=dev) \
        .expand(bshape + (3,)).reshape(-1, 3)
    dd = d.to(torch.float32).reshape(-1, 3)
    boxes = torch.as_tensor(edit_bounds, dtype=torch.float32, device=dev)
    if boxes.dim() == 2:
        boxes = boxes[None]  # (K, 2, 3)
    hit1 = r1["hit"].reshape(-1)
    t1 = r1["t"].reshape(-1)
    # conservative slab entry per box; an axis the ray is parallel to
    # constrains nothing along t and passes iff the origin is in-slab
    par = torch.abs(dd) < EPS
    inv = torch.div(torch.ones_like(dd), torch.where(par, EPS, dd))
    affected = torch.zeros(p.shape[0], dtype=torch.bool, device=dev)
    for k in range(boxes.shape[0]):
        lo, hi = boxes[k, 0], boxes[k, 1]
        ta = (lo - p) * inv
        tb = (hi - p) * inv
        mn = torch.where(par, -torch.inf, torch.minimum(ta, tb))
        mx = torch.where(par, torch.inf, torch.maximum(ta, tb))
        t_en = hmax(mn)
        t_ex = hmin(mx)
        par_ok = (~par | ((p >= lo) & (p <= hi))).all(dim=-1)
        reaches = (t_en <= t_ex) & (t_ex >= 0.0) & par_ok
        affected = affected | (
            reaches & (~hit1 | (torch.clamp_min(t_en, 0.0) <= t1 + 2.0)))
    if active is not None:
        affected = affected & torch.as_tensor(
            active, dtype=torch.bool, device=dev).expand(bshape).reshape(-1)

    dist2 = torch.as_tensor(distance, dtype=torch.float32, device=dev)
    if dist2.dim():
        dist2 = dist2.expand(bshape).reshape(-1)
    r2 = svo_raycast(table, root, height, p, dd, distance=dist2,
                     active=affected)
    aff = affected.reshape(bshape)

    def merge(key):
        a = r2[key].reshape(bshape + r2[key].shape[1:])
        m = aff[..., None] if a.dim() > aff.dim() else aff
        return torch.where(m, a, r1[key])

    return dict(hit=merge("hit"), t=merge("t"), normal=merge("normal"),
                voxel=merge("voxel"),
                node=torch.where(aff, r2["node"].reshape(bshape), -1),
                from_svo=aff)


def hf_frame_cast(tiles, offsets: tuple, height: int, cam_pos, cam_basis,
                  width_px: int, height_px: int, terrain_rgb,
                  terrain_node: int = -1, ray_dirs=None, distance=FAR,
                  init_desc: int | None = None, sky_env=None, cone=None,
                  sky=None):
    """Full-frame primary visibility on UNEDITED terrain: one
    ``hf_raycast`` over every pixel's camera ray, as the
    ``raster_cast_exact`` result (hit/t/normal/node/rgb/voxel, each (H,
    W[, 3]); misses zeroed, node -1). At the reference's 8192^3 this is
    the primary engine: it needs no soup and no bins.

    ``ray_dirs``: optional (H, W, 3) directions (jittered primaries);
    default the pixel centres, made op by op as ``camera.generate_rays``
    makes them. ``terrain_node``: the leaf reported for hits.
    ``sky_env``: optional ``(E, d0, g[, K[, S]])``, the horizon envelope
    built for ``cam_pos`` (kernels/skyline.py): every ray resumes at its
    certified-air ``t_min``, which changes no output bit. ``init_desc``:
    the walk's start depth (hf_raycast); None takes 3 with an envelope
    and 0 without, as the JAX package does.

    ``cone``: optional ``conemarch.build_cone_mips`` output: each 8x8
    pixel tile resumes at its cone-march prefix (``S * nmin``).
    ``sky``: optional ``skyline.build_skyline`` dict for ``cam_pos``:
    tiles whose every ray provably misses the terrain resume past the
    world (``skyline.tile_sky``, a host mask). Both certify air for every
    ray of the tile, jittered ones included, and compose with each other
    and with ``sky_env`` by max (``voxtracer/kernels/heightfield.py:
    853-870``); the frame is the same bit for bit. Unedited terrain
    only."""
    dev = tiles.device
    W, H = width_px, height_px
    if ray_dirs is None:
        basis = torch.as_tensor(cam_basis, dtype=torch.float32).to(dev)
        py, px = vcam.pixel_grid(W, H, dev)
        ray_dirs = vcam.ray_directions(basis, vcam.pixel_ndc(px, py, W, H))
    cam = torch.as_tensor(cam_pos, dtype=torch.float32).to(dev)
    d = ray_dirs.to(torch.float32).reshape(H, W, 3)
    t_min = None
    if cone is not None or sky is not None:
        tm = None
        if cone is not None:
            from voxtracer_torch.kernels.conemarch import (cone_prefix,
                                                           frame_tile_bundles)

            dc, sig, nmin = frame_tile_bundles(cam_basis, W, H, tile=8,
                                               device=dev)
            tm = cone_prefix(cone[0], cone[1], cone[2], height, cam_pos, dc,
                             sig) * nmin
        if sky is not None:
            from voxtracer_torch.kernels.skyline import tile_sky

            mask = torch.from_numpy(tile_sky(
                sky, np.asarray(cam_basis, np.float32), W, H, tile=8)).to(dev)
            sky_tm = torch.where(mask, 1e30, 0.0)
            tm = sky_tm if tm is None else torch.maximum(tm, sky_tm)
        ty, tx = -(-H // 8), -(-W // 8)
        tm = tm.reshape(ty, tx).repeat_interleave(8, 0) \
            .repeat_interleave(8, 1)
        t_min = tm[:H, :W]
    if sky_env is not None and t_min is not None:
        t_min = torch.maximum(t_min, env_tmin(sky_env, d))
        if init_desc is None:
            init_desc = 3
        sky_env = None
    r = hf_raycast(tiles, offsets, height, cam, d, distance=distance,
                   init_desc=init_desc, sky_env=sky_env, t_min=t_min)
    hit = r["hit"]
    trgb = torch.as_tensor(terrain_rgb, dtype=torch.float32).to(dev)
    return dict(
        hit=hit, t=r["t"], normal=r["normal"],
        node=torch.where(hit, terrain_node, -1).to(torch.int32),
        rgb=trgb.expand(H, W, 3) * hit[..., None], voxel=r["voxel"])
