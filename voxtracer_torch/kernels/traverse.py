"""Ray casts through the SVO node table: CUDA kernel K2 (csrc/svo_cast.cu)
and its plain PyTorch version.

Semantics are ``voxtracer/kernels/traverse.py:svo_raycast`` exactly
(raytrace.wgsl:68-180): octant mirroring so every direction component is
positive, the subvoxel bits of all levels packed into three bit-words
(bit m of word a = the level-(m+1) cell's half along axis a, so the cell
offset at level h is ``word & ~((1<<h)-1)``), a node stack of
``height+1`` slots, pop by height, the optional skip of hits at t == 0,
and the ADVISORY distance cap: the pop test compares the crossing t with
the capped cell end by equality, so a crossing can step past ``distance``
and record a farther hit; callers that need a strict cap compare ``t``.

The plain version walks all live lanes in lockstep and drops lanes as
they finish, so each step costs work in proportion to the lanes still
walking.
"""

from __future__ import annotations

import torch

from voxtracer_torch.core.vecmath import hmax, hmin, rdiv, to_bits
from voxtracer_torch.kernels import build
from voxtracer_torch.utils import profiling

EPS = 1.0e-6  # raytrace.wgsl:53
FAR = 1.0e12  # "no cap" distance used by the integrator (raytrace.wgsl:343)
MAX_HEIGHT = 15  # the kernel's node stack holds height + 1 <= 16 slots
# lane fetch (csrc/lanes.cuh): percent of the lanes split evenly among
# the warps up front, lanes per later claim, idle threads of a warp that
# make it refill (measured on the card, PERF.md)
STATIC_PCT, CHUNK, REFILL = 75, 32, 4

dense_host_reads = 0  # dense_raycast's alive.any() reads since the last reset
# loop steps summed over lanes by the plain version since the last reset:
# the kernel takes the same steps, so this is its work for these rays
plain_lane_steps = 0


def _lanes(start, d, distance, active):
    """Flatten the batch: (B, 3) start/d, (B,) distance and active."""
    batch_shape = d.shape[:-1]
    B = 1
    for s in batch_shape:
        B *= int(s)
    dev = d.device
    start = torch.as_tensor(start, dtype=torch.float32, device=dev)
    start = start.expand(d.shape).reshape(B, 3).contiguous()
    d = d.to(torch.float32).reshape(B, 3).contiguous()
    if isinstance(distance, (int, float)):  # filled there: no host copy
        distance = torch.full((), distance, dtype=torch.float32, device=dev)
    distance = torch.as_tensor(distance, dtype=torch.float32, device=dev)
    distance = distance.expand(batch_shape).reshape(B).contiguous()
    if active is not None:
        active = torch.as_tensor(active, dtype=torch.bool, device=dev)
        active = active.expand(batch_shape).reshape(B).contiguous()
    return start, d, distance, active, batch_shape


def svo_raycast(table, root: int, height: int, start, d, distance=FAR,
                skip_t0: bool = True, active=None):
    """Cast rays through the flat SVO node table.

    table: int32 (N, 8) (EMPTY octants -1; leaf rows hold float32 RGB bits
    in columns 0..3); root: slot or -1; height: tree height >= 1.
    start, d: (..., 3) float32 (start broadcasts); distance: scalar or
    (...,) advisory far cap; active: optional (...,) bool lane mask.

    Returns a dict of (...)-shaped tensors: hit (bool), t, node (int32
    leaf slot, -1 on a miss), normal (..., 3), voxel (..., 3 int32).
    """
    if height < 1:
        raise ValueError("svo_raycast: height must be >= 1")
    start, d, distance, active, batch_shape = _lanes(start, d, distance,
                                                     active)
    if d.device.type == "cpu":
        out = svo_raycast_plain(table, root, height, start, d, distance,
                                skip_t0, active)
    elif d.device.type == "cuda":
        out = _svo_raycast_cuda(table, root, height, start, d, distance,
                                skip_t0, active)
    else:
        raise ValueError(f"svo_raycast: unsupported device {d.device}")
    return {k: v.reshape(batch_shape + v.shape[1:]) for k, v in out.items()}


def _svo_raycast_cuda(table, root, height, start, d, distance, skip_t0,
                      active):
    if height > MAX_HEIGHT:
        raise ValueError(f"svo_raycast: height {height} > {MAX_HEIGHT}, the "
                         "kernel's node stack limit")
    if table.device != d.device or table.dtype != torch.int32 \
            or table.dim() != 2 or table.shape[1] != 8 \
            or not table.is_contiguous():
        raise ValueError("svo_raycast: table must be a contiguous int32 (N, 8) "
                         f"tensor on {d.device}")
    B = d.shape[0]
    if B > build.MAX_LANES:
        raise ValueError(f"svo_raycast: {B} lanes > {build.MAX_LANES}")
    dev = d.device
    out = dict(
        hit=torch.empty((B,), dtype=torch.bool, device=dev),
        t=torch.empty((B,), dtype=torch.float32, device=dev),
        node=torch.empty((B,), dtype=torch.int32, device=dev),
        normal=torch.empty((B, 3), dtype=torch.float32, device=dev),
        voxel=torch.empty((B, 3), dtype=torch.int32, device=dev),
    )
    if B == 0:
        return out
    lib = build.library()
    counter = torch.zeros((1,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.voxt_svo_cast(
            table.data_ptr(), int(root), int(height), start.data_ptr(),
            d.data_ptr(), distance.data_ptr(),
            None if active is None else active.data_ptr(), int(bool(skip_t0)),
            out["hit"].data_ptr(), out["t"].data_ptr(), out["node"].data_ptr(),
            out["normal"].data_ptr(), out["voxel"].data_ptr(), B,
            counter.data_ptr(), STATIC_PCT, CHUNK, REFILL, stream)
    build.check(err, "svo_raycast")
    profiling.count("launches.svo_cast")
    return out


def svo_raycast_plain(table, root: int, height: int, start, d, distance,
                      skip_t0: bool = True, active=None):
    """Plain PyTorch version of K2 on flattened lanes: start/d (B, 3),
    distance (B,), active (B,) bool or None. Same arithmetic as the kernel
    and as ``voxtracer/kernels/traverse.py:_svo_cast_body``."""
    global plain_lane_steps
    B = d.shape[0]
    dev = d.device
    H = height
    i32 = torch.int32
    bound = float(1 << H)

    flip = d < 0.0
    d_sign = torch.sign(d)
    mirror = to_bits(flip)
    dd = torch.clamp_min(torch.abs(d), EPS)
    inv_d = torch.div(torch.ones_like(dd), dd)
    s0 = torch.where(flip, bound - start, start)

    enter = -s0 * inv_d
    t0 = torch.clamp_min(hmax(enter), 0.0)
    ex = enter[:, 0] == t0
    ey = ~ex & (enter[:, 1] == t0)
    ez = ~ex & ~ey & (enter[:, 2] == t0)
    axis0 = torch.where(ex, 0, torch.where(ey, 1, torch.where(ez, 2, 3)))

    tend_root = torch.minimum(hmin((bound - s0) * inv_d), distance)
    tmid_root = (float(1 << (H - 1)) - s0) * inv_d
    words0 = (tmid_root < t0[:, None]).to(i32) << (H - 1)
    alive = (tend_root >= t0) & (root >= 0)
    if active is not None:
        alive = alive & active

    hit = torch.zeros((B,), dtype=torch.bool, device=dev)
    hit_t = torch.zeros((B,), dtype=torch.float32, device=dev)
    hit_node = torch.full((B,), -1, dtype=i32, device=dev)
    hit_axis = torch.full((B,), 3, dtype=torch.int64, device=dev)
    hit_voxel = torch.zeros((B, 3), dtype=i32, device=dev)

    # live-lane state; lane[k] is the output row of live lane k
    lane = torch.nonzero(alive).squeeze(1)
    t = t0[lane]
    axis = axis0[lane]
    h = torch.full((lane.numel(),), H - 1, dtype=torch.int64, device=dev)
    words = words0[lane]
    stk = torch.full((lane.numel(), H + 1), -1, dtype=i32, device=dev)
    stk[:, H] = root
    s0, inv_d, mirror, dist = s0[lane], inv_d[lane], mirror[lane], distance[lane]
    flat_table = table.reshape(-1)
    axes = torch.arange(3, device=dev)

    while lane.numel():
        L = lane.numel()
        plain_lane_steps += L
        rows = torch.arange(L, device=dev)
        descend = stk[rows, h] == -1

        # cell geometry at level h from the packed words
        low_mask = (torch.ones_like(h) << h) - 1
        off_i = words & ~low_mask.to(i32)[:, None]
        offset = off_i.to(torch.float32)
        cell = (torch.ones_like(h) << h).to(torch.float32)[:, None]
        mid = cell * 0.5
        tmid = (offset + mid - s0) * inv_d
        tend = torch.minimum(hmin((offset + cell - s0) * inv_d), dist)

        # descend: the child octant of the parent cell
        sub_p = ((words >> h.to(i32)[:, None]) & 1) == 1
        parent = stk[rows, torch.clamp_max(h + 1, H)]
        child_idx = to_bits(sub_p) ^ mirror
        gidx = torch.clamp_min(parent, 0).to(torch.int64) * 8 + child_idx
        child = torch.where(parent >= 0, flat_table[gidx], -1)
        child_empty = child == -1
        at_leaf = h == 0
        leaf_hit = descend & ~child_empty & at_leaf
        if skip_t0:
            leaf_skip = leaf_hit & (t == 0.0)
            leaf_hit = leaf_hit & (t != 0.0)
        else:
            leaf_skip = torch.zeros_like(leaf_hit)
        do_push = descend & ~child_empty & ~at_leaf
        pop_d = descend & (child_empty | leaf_skip)

        # advance: next midplane crossing or leave the cell
        hm1 = torch.clamp_min(h - 1, 0)
        sub = ((words >> hm1.to(i32)[:, None]) & 1) == 1
        t_next = torch.where(sub, tend[:, None], tmid)
        m = hmin(t_next)
        pop_a = ~descend & (m == tend)
        cross = ~descend & ~pop_a
        cx = t_next[:, 0] == m
        cy = ~cx & (t_next[:, 1] == m)
        cross_axis = torch.where(cx, 0, torch.where(cy, 1, 2))

        # record hits: the leaf voxel is offset(0), un-mirrored
        if leaf_hit.any():
            out = lane[leaf_hit]
            hit[out] = True
            hit_t[out] = t[leaf_hit]
            hit_node[out] = child[leaf_hit]
            hit_axis[out] = axis[leaf_hit]
            vflip = ((mirror[leaf_hit, None] >> axes.to(i32)) & 1) == 1
            vm = off_i[leaf_hit]
            hit_voxel[out] = torch.where(vflip, (1 << H) - vm - 1, vm)

        # push: subv[h] bits (tmid < t) at word bit h-1
        bit = (torch.ones_like(h) << hm1).to(i32)[:, None]
        sub_new = tmid < t[:, None]
        pushed = (words & ~bit) | torch.where(sub_new, bit, 0)
        words = torch.where(do_push[:, None], pushed, words)
        # cross: set the crossed axis's subv[h] bit
        set_axis = cross[:, None] & (axes == cross_axis[:, None])
        words = torch.where(set_axis, words | bit, words)
        t = torch.where(cross, m, t)
        axis = torch.where(cross, cross_axis, axis)

        # node stack and height
        stk[rows[do_push], h[do_push]] = child[do_push]
        down = do_push | cross
        stk[rows[down], hm1[down]] = -1
        h = torch.where(pop_d | pop_a, h + 1, torch.where(down, h - 1, h))

        keep = ~leaf_hit & (h <= H)
        if not bool(keep.all()):
            lane, t, axis, h, words, stk = (lane[keep], t[keep], axis[keep],
                                            h[keep], words[keep], stk[keep])
            s0, inv_d, mirror, dist = (s0[keep], inv_d[keep], mirror[keep],
                                       dist[keep])

    normal = torch.where(hit_axis[:, None] == axes, -d_sign, 0.0) \
        * hit[:, None].to(torch.float32)
    return dict(hit=hit, t=hit_t, node=hit_node, normal=normal,
                voxel=hit_voxel)


def leaf_rgb(table, node):
    """Leaf RGB albedo for hit nodes (float32 bits in columns 0..3);
    misses (node < 0) give zeros."""
    idx = torch.clamp_min(node, 0).to(torch.int64)
    rgb = table[idx][..., :3].contiguous().view(torch.float32)
    return torch.where((node >= 0)[..., None], rgb, 0.0)


def dense_raycast(solid, start, d, size: int, distance=FAR):
    """Amanatides-Woo DDA through a dense bool (N, N, N) occupancy grid
    indexed [x, y, z] (``voxtracer/kernels/traverse.py:dense_raycast``,
    the config-1 reference path): slab entry into [0, N]^3, the entry
    face's normal for a hit in the first voxel, then one voxel a step
    along the smallest boundary t, ties broken x before y before z.

    A jnp loop in the JAX package, plain PyTorch here on ``solid``'s
    device: every lane steps in lockstep, and the loop ends on one host
    read of ``alive.any()`` a step (counted in ``dense_host_reads``).
    Returns hit, t, normal and voxel like ``svo_raycast`` (no node)."""
    global dense_host_reads
    n = size
    i32 = torch.int32
    start, d_in, distance, _, batch_shape = _lanes(start, d, distance, None)
    B = d_in.shape[0]
    dev = d_in.device

    dd = torch.where(torch.abs(d_in) < EPS,
                     torch.where(d_in < 0, -EPS, EPS), d_in)
    inv = rdiv(1.0, dd)
    step = torch.where(dd > 0, 1, -1).to(i32)
    lo = (0.0 - start) * inv
    hi = (float(n) - start) * inv
    tmin_ax = torch.minimum(lo, hi)
    tmax_ax = torch.maximum(lo, hi)
    t = torch.clamp_min(hmax(tmin_ax), 0.0)
    t_exit = torch.minimum(hmin(tmax_ax), distance)
    alive = t <= t_exit

    p = start + dd * t[:, None]
    voxel = torch.clamp(torch.floor(p).to(i32), 0, n - 1)
    ex = (tmin_ax[:, 0] == t) & (t > 0)
    ey = ~ex & (tmin_ax[:, 1] == t) & (t > 0)
    ez = ~ex & ~ey & (tmin_ax[:, 2] == t) & (t > 0)
    axis = torch.stack([ex, ey, ez], dim=-1)
    tmax = ((voxel + (step > 0).to(i32)).to(torch.float32) - start) * inv
    tdelta = torch.abs(inv)
    step_f = step.to(torch.float32)
    flat = solid.reshape(-1)

    hit = torch.zeros((B,), dtype=torch.bool, device=dev)
    hit_t = torch.zeros((B,), dtype=torch.float32, device=dev)
    hit_normal = torch.zeros((B, 3), dtype=torch.float32, device=dev)
    hit_voxel = torch.zeros((B, 3), dtype=i32, device=dev)
    while True:
        dense_host_reads += 1
        if not bool(alive.any()):
            break
        gidx = (voxel[:, 0].long() * n + voxel[:, 1]) * n + voxel[:, 2]
        rec = alive & flat[torch.clamp(gidx, 0, n * n * n - 1)]
        hit = hit | rec
        hit_t = torch.where(rec, t, hit_t)
        hit_normal = torch.where(rec[:, None],
                                 -torch.where(axis, step_f, 0.0), hit_normal)
        hit_voxel = torch.where(rec[:, None], voxel, hit_voxel)
        # step to the next voxel along the smallest tmax axis, x > y > z
        m = hmin(tmax)
        ax = tmax == m[:, None]
        ax = ax & (torch.cumsum(ax.to(i32), dim=-1) == 1)
        v_new = voxel + torch.where(ax, step, 0)
        out = ((v_new < 0).any(dim=-1) | (v_new >= n).any(dim=-1)
               | (m > distance))
        upd = alive & ~rec
        alive = upd & ~out
        voxel = torch.where(upd[:, None], v_new, voxel)
        tmax = torch.where(upd[:, None], tmax + torch.where(ax, tdelta, 0.0),
                           tmax)
        t = torch.where(upd, m, t)
        axis = torch.where(upd[:, None], ax, axis)
    return dict(hit=hit.reshape(batch_shape), t=hit_t.reshape(batch_shape),
                normal=hit_normal.reshape(batch_shape + (3,)),
                voxel=hit_voxel.reshape(batch_shape + (3,)))
