"""Box soup of a world: the geometry the rasterizer iterates over.

The port's copy of ``voxtracer/world/boxes.py`` (numpy on the host, the
patcher's arrays on a torch device). An unedited terrain world is a
heightfield: voxel (x, y, z) is solid iff y < heights[x, z]
(worldgen.rs:26-59). Its exposed voxels are found per column and merged
into boxes. Any other world with ``solid_leaf`` (edited worlds,
``from_dense`` worlds) is enumerated instance by instance from its
octree: a subtree solid with one colour is one box, big cubes split,
enclosed boxes culled, unit voxels merged into x-strips; a native space
does the same in C++ (``extract_boxes_raw``). Either way every ray from
non-solid space meets the same first surface in the soup as in the SVO
traversal.

``SoupPatcher`` keeps a device soup current through point edits: each
edit replaces the boxes that hold the edited voxel by their pieces around
it, and adds the voxel and any neighbour a deletion exposes.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from voxtracer_torch.world.svo import EMPTY

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


def extract_boxes(dev, cull_enclosed: bool = True, max_size: int = 8,
                  max_strip: int = 16) -> BoxSoup:
    """Box soup of a serialized world (``voxtracer/world/boxes.py:48``).

    Unedited terrain (an exact heightmap) takes ``extract_boxes_terrain``;
    a native space its C++ extractor; any other world is enumerated from
    its table: ``solid_leaf[n] >= 0`` marks a subtree solid with one
    colour, emitted as one box (cubes above ``max_size`` split first).
    ``cull_enclosed`` drops boxes all six of whose faces are covered by
    solid voxels (no ray from empty space hits them first); it needs a
    dense occupancy grid, so it is skipped above 2048^3. Unit voxels merge
    into same-leaf x-strips of at most ``max_strip``. Raises ValueError
    for a world without ``solid_leaf`` (a table read from a checkpoint)."""
    H = dev.height
    heights = terrain_heights(dev)
    if heights is not None:
        leaf = terrain_leaf_id(dev)
        rgb = np.ascontiguousarray(dev.table[leaf, :3]).view(np.float32)
        return extract_boxes_terrain(heights, leaf, rgb, max_strip=max_strip)
    solid = getattr(dev, "solid_leaf", None)
    if solid is None:
        raise ValueError("extract_boxes: the world has no solid_leaf")
    table = dev.table
    cull_enclosed = cull_enclosed and H <= 11
    space = getattr(dev, "space", None)
    if hasattr(space, "extract_boxes_raw"):
        lo3, size3, leaf = space.extract_boxes_raw(
            cull_enclosed=cull_enclosed, max_size=max_size,
            max_strip=max_strip)
        return BoxSoup(lo=lo3, size=size3, leaf=leaf,
                       rgb=_leaf_rgb(table, leaf), height=H)
    if dev.root == EMPTY:
        return BoxSoup(lo=np.zeros((0, 3), np.int32),
                       size=np.zeros((0, 3), np.int32),
                       leaf=np.zeros(0, np.int32),
                       rgb=np.zeros((0, 3), np.float32), height=H)

    # breadth-first over instance positions: emit uniform solid subtrees
    out_lo, out_sz, out_leaf = [], [], []
    node = np.array([dev.root], np.int64)
    pos = np.zeros((1, 3), np.int64)
    offs8 = np.array([[i & 1, (i >> 1) & 1, (i >> 2) & 1] for i in range(8)],
                     np.int64)
    for level in range(H, -1, -1):
        s = 1 << level
        emit = solid[node] >= 0
        if emit.any():
            out_lo.append(pos[emit])
            out_sz.append(np.full(int(emit.sum()), s, np.int64))
            out_leaf.append(solid[node[emit]].astype(np.int64))
        rest = ~emit
        if not rest.any():
            break
        node, pos = node[rest], pos[rest]
        child = table[node].astype(np.int64).reshape(-1)
        cpos = (pos[:, None, :] + offs8[None] * (s >> 1)).reshape(-1, 3)
        keep = child != EMPTY
        node, pos = child[keep], cpos[keep]

    lo = np.concatenate(out_lo).astype(np.int32)
    size = np.concatenate(out_sz).astype(np.int32)
    leaf = np.concatenate(out_leaf).astype(np.int32)
    big = size > max_size
    if big.any():
        parts, sizes, leaves = [lo[~big]], [size[~big]], [leaf[~big]]
        for s in np.unique(size[big]):
            m = big & (size == s)
            k = s // max_size
            sub = np.stack(np.meshgrid(*[np.arange(k) * max_size] * 3,
                                       indexing="ij"), axis=-1).reshape(-1, 3)
            parts.append((lo[m][:, None, :] + sub[None]).reshape(-1, 3))
            sizes.append(np.full(int(m.sum()) * len(sub), max_size,
                                 size.dtype))
            leaves.append(np.repeat(leaf[m], len(sub)))
        lo = np.concatenate(parts)
        size = np.concatenate(sizes)
        leaf = np.concatenate(leaves)
    if cull_enclosed and len(size):
        keep = ~_enclosed_mask(lo, size, H)
        lo, size, leaf = lo[keep], size[keep], leaf[keep]

    unit = size == 1
    lo_u, leaf_u = _merge_strips(lo[unit], leaf[unit], max_strip)
    lo3 = np.concatenate([lo[~unit], lo_u[:, :3]])
    size3 = np.concatenate(
        [np.repeat(size[~unit][:, None], 3, axis=1),
         np.stack([lo_u[:, 3], np.ones(len(lo_u), np.int64),
                   np.ones(len(lo_u), np.int64)], axis=1)])
    leaf = np.concatenate([leaf[~unit], leaf_u]).astype(np.int32)
    return BoxSoup(lo=lo3.astype(np.int32), size=size3.astype(np.int32),
                   leaf=leaf, rgb=_leaf_rgb(table, leaf), height=H)


def _leaf_rgb(table, leaf):
    """float32 (M, 3) albedo of the leaf slots ``leaf``."""
    if not len(leaf):
        return np.zeros((0, 3), np.float32)
    return np.ascontiguousarray(
        table[np.asarray(leaf, np.int64), :3]).view(np.float32)


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


def _merge_strips(lo: np.ndarray, leaf: np.ndarray, max_len: int = 16):
    """Merge unit boxes into same-leaf runs along x, split at aligned
    ``max_len`` boundaries. Returns (int64[K, 4] of [x, y, z, len],
    int64[K] leaf)."""
    if len(lo) == 0:
        return np.zeros((0, 4), np.int64), np.zeros(0, np.int64)
    order = np.lexsort((lo[:, 0], lo[:, 2], lo[:, 1]))
    s = lo[order].astype(np.int64)
    sl = leaf[order].astype(np.int64)
    prev_adjacent = np.zeros(len(s), bool)
    prev_adjacent[1:] = (
        (s[1:, 1] == s[:-1, 1]) & (s[1:, 2] == s[:-1, 2])
        & (s[1:, 0] == s[:-1, 0] + 1) & (sl[1:] == sl[:-1])
        & (s[1:, 0] % max_len != 0))
    starts = np.nonzero(~prev_adjacent)[0]
    ends = np.r_[starts[1:], len(s)]
    out = np.empty((len(starts), 4), np.int64)
    out[:, :3] = s[starts]
    out[:, 3] = ends - starts
    return out, sl[starts]


def _enclosed_mask(lo: np.ndarray, size: np.ndarray,
                   height: int) -> np.ndarray:
    """True for the (octree-aligned, cubic) boxes all six of whose
    face-adjacent slabs are solid; a face on the world's boundary is
    exposed. Each face test is one lookup in an AND-pool of the dense
    occupancy grid over the face's two axes."""
    n = 1 << height
    occ = np.zeros((n, n, n), bool)
    for s in np.unique(size):
        blo = lo[size == s]
        if s == 1:
            occ[blo[:, 0], blo[:, 1], blo[:, 2]] = True
            continue
        k = n // s
        g = np.zeros((k, k, k), bool)
        c = blo // s
        g[c[:, 0], c[:, 1], c[:, 2]] = True
        occ.reshape(k, s, k, s, k, s)[...] |= g[:, None, :, None, :, None]

    def pool2(a, ax1, ax2):
        ix = [slice(None)] * 3
        for ax in (ax1, ax2):
            i0, i1 = list(ix), list(ix)
            i0[ax] = slice(0, None, 2)
            i1[ax] = slice(1, None, 2)
            a = a[tuple(i0)] & a[tuple(i1)]
        return a

    # per size: the grid pooled over (y, z), (x, z) and (x, y)
    pools = {1: (occ, occ, occ)}
    s = 1
    while s < int(size.max()):
        p_yz, p_xz, p_xy = pools[s]
        pools[2 * s] = (pool2(p_yz, 1, 2), pool2(p_xz, 0, 2),
                        pool2(p_xy, 0, 1))
        s *= 2

    enclosed = np.ones(len(size), bool)
    for s in np.unique(size):
        m = size == s
        blo = lo[m]
        # the face's own two axes index the pool in cells of s
        c = blo // s if s > 1 else blo
        p_yz, p_xz, p_xy = pools[s]
        cov = np.ones(len(blo), bool)
        for ax, pool, (ia, ib) in ((0, p_yz, (1, 2)), (1, p_xz, (0, 2)),
                                   (2, p_xy, (0, 1))):
            v0 = blo[:, ax]
            for idx, valid in ((v0 - 1, v0 - 1 >= 0),
                               (v0 + s, v0 + s <= n - 1)):
                ok = np.zeros(len(blo), bool)
                key = [None, None, None]
                key[ax] = np.clip(idx, 0, n - 1)[valid]
                key[ia] = c[valid, ia]
                key[ib] = c[valid, ib]
                ok[valid] = pool[tuple(key)]
                cov &= ok
        enclosed[m] = cov
    return enclosed


class SoupPatcher:
    """A device box soup kept current through point edits, in place
    (``voxtracer/world/boxes.py:325``).

    Host copies of the soup sit beside the device tensors, both with
    ``overlay`` spare rows that the rasterizer is not handed until used. Editing
    voxel v (delete or overwrite) kills every box that holds v and adds
    its pieces around v (at most 6: x-slabs, then y-slabs of the middle,
    then z-slabs); a solid new value adds a unit box for v; a delete adds
    a unit box for each solid face neighbour, since the culls may have
    left those out (a duplicate box gives the same first hit). The patched
    soup's first hits equal ``extract_boxes`` of the edited world.

    ``apply`` returns False when the overlay is full or the soup and the
    world disagree; the caller then rebuilds. The boxes that hold v are
    found through an index of the soup's rows by the xz tile of
    ``INDEX_TILE`` columns each box lies in (every extracted box does:
    runs and cubes split at aligned multiples of ``max_strip`` and
    ``max_size``), plus the rows added since and any box that spans tiles,
    so an edit scans a few hundred rows, not the soup (the JAX package
    scans every row)."""

    INDEX_TILE = 16

    def __init__(self, soup: BoxSoup, device, overlay: int = 4096):
        m = len(soup)
        self.height = soup.height
        self.lo = np.concatenate([soup.lo.astype(np.int32),
                                  np.zeros((overlay, 3), np.int32)])
        self.size = np.concatenate([soup.size.astype(np.int32),
                                    np.zeros((overlay, 3), np.int32)])
        self.leaf = np.concatenate([soup.leaf.astype(np.int32),
                                    np.full(overlay, -1, np.int32)])
        rgb = np.concatenate([soup.rgb.astype(np.float32),
                              np.zeros((overlay, 3), np.float32)])
        self.n_used = m
        self.capacity = m + overlay
        attr = np.concatenate([self.leaf.view(np.float32)[:, None], rgb],
                              axis=1)
        self._d = tuple(torch.from_numpy(a).to(device)
                        for a in (self.lo, self.size, attr))
        # rows by the tile they lie in, as (sorted keys, rows in that order)
        t = self.INDEX_TILE
        self._tiles_z = -(-(1 << self.height) // t)
        lo = self.lo[:m].astype(np.int64)
        hi = lo + np.maximum(self.size[:m].astype(np.int64), 1) - 1
        one = (lo[:, 0] // t == hi[:, 0] // t) & (lo[:, 2] // t == hi[:, 2] // t)
        rows = np.nonzero(one)[0]
        keys = (lo[rows, 0] // t) * self._tiles_z + lo[rows, 2] // t
        order = np.argsort(keys, kind="stable")
        self._keys, self._rows = keys[order], rows[order]
        self._extra = list(np.nonzero(~one)[0])  # rows scanned every edit

    @property
    def device_soup(self):
        """(box_lo, box_size, box_attr) on the device: the used rows (views
        of the spare-row tensors, so the rasterizer sees no spare row)."""
        return tuple(a[:self.n_used] for a in self._d)

    def apply(self, edits, space) -> bool:
        """``edits``: the (x, y, z) voxels already changed in ``space``.
        Patches the host and device arrays; False: rebuild instead."""
        rows = []  # (row, lo, size, leaf, rgb) of the boxes added
        kills = []

        def emit(lo3, size3, leaf, rgb):
            if self.n_used >= self.capacity:
                return False
            r = self.n_used
            self.n_used += 1
            self.lo[r] = lo3
            self.size[r] = size3
            self.leaf[r] = leaf
            self._extra.append(r)
            rows.append((r, lo3, size3, leaf, rgb))
            return True

        n_world = 1 << self.height
        for exyz in edits:
            v = np.asarray(exyz, np.int64)
            key = (v[0] // self.INDEX_TILE) * self._tiles_z \
                + v[2] // self.INDEX_TILE
            a, b = np.searchsorted(self._keys, [key, key + 1])
            cand = np.sort(np.concatenate(
                [self._rows[a:b], np.asarray(self._extra, np.int64)]))
            blo, bsz = self.lo[cand], self.size[cand]
            inside = cand[(blo <= v).all(axis=1) & (v < blo + bsz).all(axis=1)
                          & (bsz > 0).any(axis=1)]
            for bi in inside:
                blo = self.lo[bi].astype(np.int64)
                bhi = blo + self.size[bi].astype(np.int64)
                bleaf = int(self.leaf[bi])
                kills.append(int(bi))
                self.size[bi] = 0
                pieces = []
                lo_c, hi_c = blo.copy(), bhi.copy()
                for ax in range(3):
                    if v[ax] > lo_c[ax]:
                        psz = hi_c - lo_c
                        psz[ax] = v[ax] - lo_c[ax]
                        pieces.append((lo_c.copy(), psz))
                    if v[ax] + 1 < hi_c[ax]:
                        plo = lo_c.copy()
                        plo[ax] = v[ax] + 1
                        psz = hi_c - lo_c
                        psz[ax] = hi_c[ax] - v[ax] - 1
                        pieces.append((plo, psz))
                    lo_c[ax] = v[ax]
                    hi_c[ax] = v[ax] + 1
                if pieces:
                    # the box is one colour: any voxel of a piece has it
                    brgb = space.get(tuple(int(c) for c in pieces[0][0]))
                    if brgb is None:
                        return False
                    for plo, psz in pieces:
                        if not emit(plo, psz, bleaf, brgb):
                            return False
            new_rgb = space.get(tuple(int(c) for c in v))
            if new_rgb is not None:
                leaf = space.leaf_at(tuple(int(c) for c in v))
                if leaf is None or not emit(v, (1, 1, 1), int(leaf),
                                            new_rgb):
                    return False
                continue
            for ax in range(3):
                for dv in (-1, 1):
                    nb = v.copy()
                    nb[ax] += dv
                    if not 0 <= nb[ax] < n_world:
                        continue
                    rgb = space.get(tuple(int(c) for c in nb))
                    if rgb is None:
                        continue
                    leaf = space.leaf_at(tuple(int(c) for c in nb))
                    if leaf is None or not emit(nb, (1, 1, 1), int(leaf),
                                                rgb):
                        return False

        d_lo, d_size, d_attr = self._d
        dev = d_lo.device
        if kills:
            d_size[torch.as_tensor(kills, dtype=torch.int64, device=dev)] = 0
        if rows:
            idx = torch.as_tensor([r[0] for r in rows], dtype=torch.int64,
                                  device=dev)
            attr = np.zeros((len(rows), 4), np.float32)
            for i, (_, _, _, leaf, rgb) in enumerate(rows):
                attr[i, 0] = np.int32(leaf).view(np.float32)
                attr[i, 1:] = rgb
            d_lo[idx] = torch.from_numpy(
                np.stack([np.asarray(r[1], np.int32) for r in rows])).to(dev)
            d_size[idx] = torch.from_numpy(
                np.stack([np.asarray(r[2], np.int32) for r in rows])).to(dev)
            d_attr[idx] = torch.from_numpy(attr).to(dev)
        return True
