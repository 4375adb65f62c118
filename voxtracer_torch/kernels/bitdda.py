"""Hierarchical bit-grid DDA: the port of ``voxtracer/kernels/bitdda.py``,
with CUDA kernel K8 (``csrc/bit_dda.cu``: the walker of
``csrc/bit_walk.cuh`` on the persistent lane fetch of ``csrc/lanes.cuh``;
K9's bit-grid engine runs the same walker) and its plain PyTorch version.

The walk steps through the packed occupancy pyramid of
``world/bitgrid.py`` (regions of 128^3 voxels, bricks of 8^3, voxels): at
each cell of the current level it tests one bit, descends into an occupied
region or brick, and otherwise steps to the next cell of that level,
ascending to the coarsest boundary it crossed. Mirrored-space
arithmetic, the EPS direction clamp, the x>y>z tie priority and the
t == 0 skip are ``traverse.svo_raycast``'s, so hits are the SVO walk's up
to edge-graze ties; colours come from the node table (``svo_color_at``).

The reference selects a word of the region or brick row it carried since
it descended, with a tree of selects (``_tree_select``: TPU mechanism).
Here the word is loaded directly from the region or brick the ray is in,
which is the carried row: a ray leaves a brick or a region only by an
ascent to its level.

One departure, a repair: on a step, the cells of the axes not stepped
come from ``floor(o + dm * m)``, and the reference lets them fall below
the cell the ray is in when that product rounds down. A ray through an
edge where two crossing t's are equal then steps back and forth between
two cells at the same t forever (found on the card: 2 of the 3,275,520
jittered primaries of a batch-8 call at 1024^3 from the smoke pose; the
reference's while_loop would not end either). In the mirrored space every
direction component is positive, so a cell index never decreases: the
port takes ``max(floor(o + dm * m), v)``. Walks that never step back are
unchanged.
"""

from __future__ import annotations

import torch

from voxtracer_torch.core.vecmath import hmax, hmin, rdiv
from voxtracer_torch.kernels import build
from voxtracer_torch.kernels.traverse import EPS, FAR, _lanes
from voxtracer_torch.utils import profiling
from voxtracer_torch.world.bitgrid import BRICK_VOX, CELLS, REGION_VOX

# K8's lane fetch (csrc/lanes.cuh): K2's settings
STATIC_PCT, CHUNK, REFILL = 75, 32, 4
# loop steps summed over lanes by the plain version since the last reset
plain_lane_steps = 0
# a list, or None: the plain version appends each step's word reads as
# level << 40 | (word index >> 3), the 32 B sector of that level's array
plain_sectors = None


def bitgrid_raycast(top, regions, bricks, size: int, start, d, distance=FAR,
                    skip_t0: bool = True, active=None):
    """Cast rays through the packed occupancy pyramid
    (``voxtracer/kernels/bitdda.py:44``).

    top (Tw,), regions (nr^3, 128), bricks (nb^3, 16): int32 bit patterns
    (``BitGrid.to_device``); size: the world edge; start, d: (..., 3)
    float32 (start broadcasts); distance: scalar or (...,) cap; active:
    optional (...,) lane mask. Returns hit, t, normal (..., 3) and voxel
    (..., 3 int32, world coordinates).
    """
    start, d, distance, active, batch_shape = _lanes(start, d, distance,
                                                     active)
    if d.device.type == "cpu":
        out = bitgrid_raycast_plain(top, regions, bricks, size, start, d,
                                    distance, skip_t0, active)
    elif d.device.type == "cuda":
        out = _bitgrid_raycast_cuda(top, regions, bricks, size, start, d,
                                    distance, skip_t0, active)
    else:
        raise ValueError(f"bitgrid_raycast: unsupported device {d.device}")
    return {k: v.reshape(batch_shape + v.shape[1:]) for k, v in out.items()}


def check_grid(top, regions, bricks, size: int, dev, what: str):
    """Raise unless the pyramid is what K8's walker takes: a power-of-two
    edge of at least one region, and three contiguous int32 tensors of
    its shapes on ``dev``."""
    if size < REGION_VOX or size & (size - 1):
        raise ValueError(f"{what}: bit grid edge {size} is not a power of "
                         f"two >= {REGION_VOX}")
    nr, nb = size // REGION_VOX, size // BRICK_VOX
    for name, a, shape in (("top", top, (top.shape[0],)),
                           ("regions", regions, (nr ** 3, 128)),
                           ("bricks", bricks, (nb ** 3, 16))):
        if a.device != dev or a.dtype != torch.int32 \
                or tuple(a.shape) != shape or not a.is_contiguous():
            raise ValueError(f"{what}: {name} must be a contiguous int32 "
                             f"{shape} tensor on {dev}")


def _bitgrid_raycast_cuda(top, regions, bricks, size, start, d, distance,
                          skip_t0, active, fetch=(STATIC_PCT, CHUNK, REFILL)):
    dev = d.device
    check_grid(top, regions, bricks, size, dev, "bitgrid_raycast")
    B = d.shape[0]
    if B > build.MAX_LANES:
        raise ValueError(f"bitgrid_raycast: {B} lanes > {build.MAX_LANES}")
    out = dict(
        hit=torch.empty((B,), dtype=torch.bool, device=dev),
        t=torch.empty((B,), dtype=torch.float32, device=dev),
        normal=torch.empty((B, 3), dtype=torch.float32, device=dev),
        voxel=torch.empty((B, 3), dtype=torch.int32, device=dev))
    if B == 0:
        return out
    lib = build.library()
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.voxt_bit_dda(
            top.data_ptr(), int(top.shape[0]), regions.data_ptr(),
            bricks.data_ptr(), int(size), start.data_ptr(), d.data_ptr(),
            distance.data_ptr(),
            None if active is None else active.data_ptr(), int(bool(skip_t0)),
            out["hit"].data_ptr(), out["t"].data_ptr(),
            out["normal"].data_ptr(), out["voxel"].data_ptr(), B,
            counter.data_ptr(), *fetch, stream)
    build.check(err, "bitgrid_raycast")
    profiling.count("launches.bit_dda")
    return out


def _bit(word, idx):
    return ((word >> (idx & 31).to(torch.int32)) & 1) == 1


def bitgrid_raycast_plain(top, regions, bricks, size: int, start, d,
                          distance, skip_t0: bool = True, active=None):
    """Plain PyTorch version of K8 on flattened lanes (start/d (B, 3),
    distance (B,)): the live lanes step in lockstep and leave as they
    finish. Same arithmetic as the kernel."""
    global plain_lane_steps
    B = d.shape[0]
    dev = d.device
    n = size
    nr, nb = n // REGION_VOX, n // BRICK_VOX
    i32, f32 = torch.int32, torch.float32
    bound = float(n)
    flip = d < 0.0
    d_sign = torch.sign(d)
    dm = torch.clamp_min(torch.abs(d), EPS)
    inv = rdiv(1.0, dm)
    o = torch.where(flip, bound - start, start)  # mirrored origin

    enter = -o * inv
    t0 = torch.clamp_min(hmax(enter), 0.0)
    t_exit = torch.minimum(hmin((bound - o) * inv), distance)
    ax0 = torch.where(enter[:, 0] == t0, 0,
                      torch.where(enter[:, 1] == t0, 1,
                                  torch.where(enter[:, 2] == t0, 2, 3)))
    ax0 = torch.where(t0 > 0.0, ax0, 3)

    def cell_of(x):
        """floor(x) clamped to the grid, as int (clamped first in float)."""
        return torch.clamp(torch.floor(x), 0.0, float(n - 1)).to(i32)

    v0 = cell_of(o + dm * t0[:, None])
    alive = t_exit >= t0
    if active is not None:
        alive = alive & active

    hit = torch.zeros((B,), dtype=torch.bool, device=dev)
    hit_t = torch.zeros((B,), dtype=f32, device=dev)
    hit_axis = torch.full((B,), 3, dtype=torch.int64, device=dev)
    hit_voxel = torch.zeros((B, 3), dtype=i32, device=dev)

    lane = torch.nonzero(alive).squeeze(1)
    v, t, axis = v0[lane], t0[lane], ax0[lane]
    lvl = torch.full((lane.numel(),), 2, dtype=i32, device=dev)
    o_l, dm_l, inv_l, flip_l, tex = (o[lane], dm[lane], inv[lane], flip[lane],
                                     t_exit[lane])
    axes = torch.arange(3, device=dev)
    top_f, reg_f, brk_f = top.reshape(-1), regions.reshape(-1), \
        bricks.reshape(-1)

    while lane.numel():
        plain_lane_steps += lane.numel()
        s = torch.where(lvl == 2, REGION_VOX,
                        torch.where(lvl == 1, BRICK_VOX, 1)).to(i32)
        c = v & ~(s - 1)[:, None]
        c_w = torch.where(flip_l, n - c - s[:, None], c)

        r_w = c_w >> 7
        ridx = (r_w[:, 0] * nr + r_w[:, 1]) * nr + r_w[:, 2]
        b_w = c_w >> 3
        cl = b_w & (CELLS - 1)
        cbit = (cl[:, 2] * CELLS + cl[:, 1]) * CELLS + cl[:, 0]
        bidx = (b_w[:, 0] * nb + b_w[:, 1]) * nb + b_w[:, 2]
        vl = c_w & (BRICK_VOX - 1)
        vbit = (vl[:, 2] * 8 + vl[:, 1]) * 8 + vl[:, 0]
        # one word a lane, from the level the lane is at
        ridx_c = ridx.clamp(0, nr ** 3 - 1).long()
        bidx_c = bidx.clamp(0, nb ** 3 - 1).long()
        widx = torch.where(
            lvl == 2, (ridx >> 5).long(),
            torch.where(lvl == 1, ridx_c * 128 + (cbit >> 5).long(),
                        bidx_c * 16 + (vbit >> 5).long()))
        word = torch.where(lvl == 2, top_f[widx.clamp(0, top_f.numel() - 1)],
                           torch.where(lvl == 1,
                                       reg_f[widx.clamp(0, reg_f.numel() - 1)],
                                       brk_f[widx.clamp(0, brk_f.numel() - 1)]))
        bidx_bit = torch.where(lvl == 2, ridx, torch.where(lvl == 1, cbit,
                                                           vbit))
        if plain_sectors is not None:
            plain_sectors.append((lvl.long() << 40) | (widx >> 3))
        occ = _bit(word, bidx_bit)

        is_hit = occ & (lvl == 0)
        if skip_t0:
            skip = is_hit & (t == 0.0)
            is_hit = is_hit & (t != 0.0)
        else:
            skip = torch.zeros_like(is_hit)
        if is_hit.any():
            out = lane[is_hit]
            hit[out] = True
            hit_t[out] = t[is_hit]
            hit_axis[out] = axis[is_hit]
            vh = v[is_hit]
            hit_voxel[out] = torch.where(flip_l[is_hit], n - vh - 1, vh)

        desc = occ & (lvl > 0) & ~skip
        adv = ~occ | skip
        planes = (c + s[:, None]).to(f32)
        tn = (planes - o_l) * inv_l
        m = hmin(tn)
        axx = tn[:, 0] == m
        axy = ~axx & (tn[:, 1] == m)
        step_axis = torch.where(axx, 0, torch.where(axy, 1, 2))
        v_flt = torch.maximum(cell_of(o_l + dm_l * m[:, None]), v)
        on_axis = axes[None, :] == step_axis[:, None]
        v_adv = torch.where(on_axis, c + s[:, None], v_flt)
        out_w = torch.any(v_adv >= n, dim=1) | (m > tex)
        reg_crossed = torch.any((v_adv >> 7) != (v >> 7), dim=1)
        brick_crossed = torch.any((v_adv >> 3) != (v >> 3), dim=1)
        lvl_adv = torch.where(reg_crossed, 2,
                              torch.where(brick_crossed,
                                          torch.clamp_min(lvl, 1), lvl))
        lvl = torch.where(adv, lvl_adv, torch.where(desc, lvl - 1, lvl)) \
            .to(i32)
        v = torch.where(adv[:, None], v_adv, v)
        t = torch.where(adv, m, t)
        axis = torch.where(adv, step_axis, axis)
        keep = ~is_hit & ~(adv & out_w)
        if not bool(keep.all()):
            lane, v, t, axis, lvl = (lane[keep], v[keep], t[keep], axis[keep],
                                     lvl[keep])
            o_l, dm_l, inv_l, flip_l, tex = (o_l[keep], dm_l[keep],
                                             inv_l[keep], flip_l[keep],
                                             tex[keep])

    normal = torch.where(hit_axis[:, None] == axes, -d_sign, 0.0) \
        * hit[:, None].to(f32)
    return dict(hit=hit, t=hit_t, normal=normal, voxel=hit_voxel)


def svo_color_at(table, root: int, height: int, voxel, mask):
    """RGB albedo of integer voxels from the node table: one masked
    descent of ``height`` levels (``voxtracer/kernels/bitdda.py:219``).
    voxel: (..., 3) int32 world coordinates; mask: (...,) lanes to
    resolve; others give zeros."""
    batch_shape = voxel.shape[:-1]
    p = voxel.reshape(-1, 3).to(torch.int64)
    m = torch.as_tensor(mask, device=voxel.device).expand(batch_shape) \
        .reshape(-1)
    flat = table.reshape(-1)
    node = torch.where(m, int(root), -1).to(torch.int64)
    for i in range(height):
        bit = 1 << (height - 1 - i)
        above = (p & bit) != 0
        idx = above[:, 0].long() | (above[:, 1].long() << 1) \
            | (above[:, 2].long() << 2)
        node = torch.where(node >= 0, flat[node.clamp_min(0) * 8 + idx]
                           .to(torch.int64), -1)
        p = torch.where(above, p & ~bit, p)
    rgb = table[node.clamp_min(0)][:, :3].contiguous().view(torch.float32)
    rgb = torch.where((node >= 0)[:, None], rgb, 0.0)
    return rgb.reshape(batch_shape + (3,))
