"""Box soup of a terrain world: the geometry the rasterizer iterates over.

The port's copy of the terrain path of ``voxtracer/world/boxes.py``
(numpy only). An unedited terrain world is a heightfield: voxel (x, y, z)
is solid iff y < heights[x, z] (worldgen.rs:26-59). Its exposed voxels
are found per column, merged into boxes, and every ray from non-solid
space meets the same first surface in the soup as in the SVO traversal.

Worlds that are not unedited terrain (edited worlds, ``from_dense``
worlds) have no soup here: ``extract_boxes`` raises and the renderer
keeps its per-ray primaries.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

_BLOCK = 0  # SvoSpace cell kind of a leaf block (world/svo.py)


@dataclass
class BoxSoup:
    """World-space boxes on the host: ``lo`` int32[M, 3] low corners,
    ``size`` int32[M, 3] extents, ``leaf`` int32[M] leaf slot id,
    ``rgb`` float32[M, 3] albedo, ``height`` tree height."""

    lo: np.ndarray
    size: np.ndarray
    leaf: np.ndarray
    rgb: np.ndarray
    height: int

    def __len__(self):
        return len(self.size)


def terrain_heights(dev):
    """The heightmap that exactly describes ``dev``'s world, or None.

    ``dev.space`` carries it when worldgen built the world and no point
    edit has changed it since (``heights_exact``; both packages' ``set``
    clear it)."""
    space = getattr(dev, "space", None)
    if not getattr(space, "heights_exact", False):
        return None
    return space.heights


def extract_boxes(dev, max_strip: int = 16) -> BoxSoup:
    """Box soup of an unedited terrain world (``voxtracer/world/boxes.py:
    84-95``): raises ValueError for any other world."""
    heights = terrain_heights(dev)
    if heights is None:
        raise ValueError("extract_boxes: the world carries no unedited "
                         "terrain heightmap")
    leaf = terrain_leaf_id(dev)
    rgb = np.ascontiguousarray(dev.table[leaf, :3]).view(np.float32)
    return extract_boxes_terrain(heights, leaf, rgb, max_strip=max_strip)


def extract_boxes_terrain(heights: np.ndarray, leaf: int, rgb,
                          max_strip: int = 16, max_tall: int = 16) -> BoxSoup:
    """Box soup straight from a terrain heightmap [x, z].

    Exposed voxels of a column: side faces from y = min of the 4
    neighbour heights (out-of-world neighbours count as 0), the top voxel,
    and the floor voxel y = 0. Each column's [ylo, h) becomes vertical
    boxes (split at ``max_tall``), merged along x into runs of equal
    (ylo, h) split at aligned ``max_strip`` boundaries, then runs equal
    at consecutive z into rectangles; floor voxels merge the same way.
    """
    h = heights.astype(np.int64)
    n = h.shape[0]
    assert h.shape == (n, n)
    pad = np.zeros((n + 2, n + 2), np.int64)
    pad[1:-1, 1:-1] = h
    nbr = np.minimum(
        np.minimum(pad[:-2, 1:-1], pad[2:, 1:-1]),
        np.minimum(pad[1:-1, :-2], pad[1:-1, 2:]),
    )
    ylo = np.minimum(nbr, np.maximum(h - 1, 0))

    # x-runs of equal (ylo, h) per z row, in [z, x] layout
    hz = h.T
    yz = ylo.T
    solid = hz > 0
    xs = np.broadcast_to(np.arange(n, dtype=np.int64)[None, :], (n, n))
    new_run = np.ones((n, n), bool)
    new_run[:, 1:] = (
        (hz[:, 1:] != hz[:, :-1])
        | (yz[:, 1:] != yz[:, :-1])
        | (xs[:, 1:] % max_strip == 0)
    )
    start = new_run & solid
    # a run ends at the next run start, the row end or the first air cell
    idx = np.nonzero(start.reshape(-1))[0]
    nxt = np.empty_like(idx)
    if len(idx):
        nxt[:-1] = idx[1:]
        nxt[-1] = n * n
    row_end = (idx // n + 1) * n
    air_after = _next_member(np.nonzero(~solid.reshape(-1))[0], idx, n * n)
    end = np.minimum(np.minimum(nxt, row_end), air_after)
    length = end - idx

    z0 = idx // n
    x0 = idx % n
    rl = yz.reshape(-1)[idx]
    rh = hz.reshape(-1)[idx]

    # equal x-runs at consecutive z merge into rectangles
    g, zlen = _merge_z(z0, (x0, rl, rh, length), max_depth=max_strip)
    z0, x0, rl, rh, length = z0[g], x0[g], rl[g], rh[g], length[g]

    # split each run's [ylo, h) into chunks of max_tall
    tall = rh - rl
    chunks = (tall + max_tall - 1) // max_tall
    total = int(chunks.sum())
    ends = np.cumsum(chunks)
    starts_c = ends - chunks
    owner = np.searchsorted(ends, np.arange(total, dtype=np.int64),
                            side="right")
    k = np.arange(total, dtype=np.int64) - starts_c[owner]
    ylo_c = rl[owner] + k * max_tall
    ext_c = np.minimum(rh[owner] - ylo_c, max_tall)
    lo = np.stack([x0[owner], ylo_c, z0[owner]], axis=1)
    size = np.stack([length[owner], ext_c, zlen[owner]], axis=1)

    # floor voxels (y = 0) not already inside [ylo, h)
    fmask = solid & (yz > 0)
    fnew = np.ones((n, n), bool)
    fnew[:, 1:] = (~fmask[:, :-1]) | (xs[:, 1:] % max_strip == 0)
    fstart = fnew & fmask
    fidx = np.nonzero(fstart.reshape(-1))[0]
    fnxt = np.empty_like(fidx)
    if len(fidx):
        fnxt[:-1] = fidx[1:]
        fnxt[-1] = n * n
    f_after = _next_member(np.nonzero(~fmask.reshape(-1))[0], fidx, n * n)
    frow_end = (fidx // n + 1) * n
    flen = np.minimum(np.minimum(fnxt, frow_end), f_after) - fidx
    fx0 = fidx % n
    fz0 = fidx // n
    fg, fzlen = _merge_z(fz0, (fx0, flen), max_depth=max_strip)
    fx0, fz0, flen = fx0[fg], fz0[fg], flen[fg]
    flo = np.stack([fx0, np.zeros(len(fx0), np.int64), fz0], axis=1)
    fsize = np.stack([flen, np.ones(len(fx0), np.int64), fzlen], axis=1)

    lo = np.concatenate([lo, flo]).astype(np.int32)
    size = np.concatenate([size, fsize]).astype(np.int32)
    m = len(lo)
    return BoxSoup(
        lo=lo, size=size,
        leaf=np.full(m, leaf, np.int32),
        rgb=np.broadcast_to(
            np.asarray(rgb, np.float32)[None, :], (m, 3)
        ).copy(),
        height=int(n).bit_length() - 1,
    )


def _merge_z(z0: np.ndarray, keys: tuple, max_depth: int = 16):
    """Group entries with identical ``keys`` at consecutive z into one
    box of z-extent == group size (split at aligned ``max_depth``
    boundaries). Returns (indices of group starts, int64 z-extents)."""
    m = len(z0)
    if m == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    order = np.lexsort((z0,) + keys)
    adj = np.zeros(m, bool)
    if m > 1:
        same = np.ones(m - 1, bool)
        for kk in keys:
            ks = kk[order]
            same &= ks[1:] == ks[:-1]
        zs = z0[order]
        adj[1:] = same & (zs[1:] == zs[:-1] + 1) & (zs[1:] % max_depth != 0)
    starts = np.nonzero(~adj)[0]
    ends = np.r_[starts[1:], m]
    return order[starts], (ends - starts).astype(np.int64)


def _next_member(sorted_pos: np.ndarray, query: np.ndarray, fill):
    """For each query index, the smallest member of sorted_pos >= it
    (``fill`` if none)."""
    if len(sorted_pos) == 0 or len(query) == 0:
        return np.full(len(query), fill, np.int64)
    p = np.searchsorted(sorted_pos, query)
    safe = p < len(sorted_pos)
    return np.where(safe, sorted_pos[np.minimum(p, len(sorted_pos) - 1)],
                    fill)


def terrain_leaf_id(dev) -> int:
    """Slot id of the terrain's single block leaf: the first slot whose
    node is a block, the same slot the JAX package finds through
    ``solid_leaf`` (blocks are the nodes whose solid leaf is themselves).
    A JAX ``DeviceSvo`` answers from its ``solid_leaf``, a native space
    from the leaf under its first solid column."""
    solid_leaf = getattr(dev, "solid_leaf", None)
    if solid_leaf is not None:
        ids = np.nonzero(
            solid_leaf == np.arange(len(solid_leaf), dtype=np.int64))[0]
    elif hasattr(dev.space, "leaf_at"):
        cols = np.argwhere(np.asarray(dev.space.heights) > 0)
        ids = [dev.space.leaf_at((x, 0, z)) for x, z in cols[:1]]
    else:
        kinds = dev.space._kind
        ids = [nid for nid, kind in enumerate(kinds) if kind == _BLOCK]
    if len(ids) == 0:
        raise ValueError("terrain_leaf_id: no block leaves in this world")
    return int(ids[0])
