"""Procedural terrain: noise heightmap -> min/max pyramid -> octree.

Pipeline of ``voxtracer/world/worldgen.py`` (behavioural reference
worldgen.rs:10-96): the heightmap is evaluated in torch on the given
device; the octree is built on the host, by the native C++ builder
(world/native.py) or by the numpy pyramid and the Python bottom-up
builder below, node for node the same tree.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from voxtracer_torch.core.vecmath import div
from voxtracer_torch.world import native
from voxtracer_torch.world.noise import fbm2, simplex2
from voxtracer_torch.world.svo import SvoSpace

SEED_SCALE = 0xAFE29979  # worldgen.rs:14
SEED_NOISE = 0x1C766E2E  # worldgen.rs:15
REFERENCE_LOG2_SIZE = 13  # worldgen.rs:17
TERRAIN_RGB = (0.5, 0.5, 0.5)  # every terrain voxel (build_octree's default)


def heightmap(log2_size: int, seed_scale: int = SEED_SCALE,
              seed_noise: int = SEED_NOISE, device="cuda") -> np.ndarray:
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


def minmax_pyramid(heights: np.ndarray):
    """[(min, max)] per level; level 0 = per-column, last = 1x1 global."""
    mins = [heights.astype(np.int64)]
    maxs = [heights.astype(np.int64)]
    while mins[-1].shape[0] > 1:
        m = mins[-1]
        x = maxs[-1]
        mins.append(np.minimum.reduce(
            [m[0::2, 0::2], m[0::2, 1::2], m[1::2, 0::2], m[1::2, 1::2]]))
        maxs.append(np.maximum.reduce(
            [x[0::2, 0::2], x[0::2, 1::2], x[1::2, 0::2], x[1::2, 1::2]]))
    return mins, maxs


def _ranges(lo: np.ndarray, hi: np.ndarray):
    """Concatenate [lo_i, hi_i) aranges; returns (values, repeats)."""
    counts = np.maximum(hi - lo, 0)
    total = int(counts.sum())
    if total == 0:
        return np.zeros(0, np.int64), counts
    ends = np.cumsum(counts)
    starts = ends - counts
    idx = np.arange(total, dtype=np.int64)
    owner = np.searchsorted(ends, idx, side="right")
    vals = idx - starts[owner] + lo[owner]
    return vals, counts


def build_octree(mins, maxs, space: SvoSpace | None = None,
                 rgb=TERRAIN_RGB) -> SvoSpace:
    """Bottom-up vectorized octree build from a min/max column pyramid.

    Cell (cx, cy, cz) at level L (size s = 2^L) is solid iff
    (cy+1)*s <= min over its column footprint, empty iff cy*s >= max,
    mixed otherwise (worldgen.rs:67-74). Solid regions are shared solid
    cubes: a block wrapped in k levels of identical children.
    """
    if space is None:
        space = SvoSpace()
    log2 = len(mins) - 1
    n = 1 << log2

    solid_ids = [space.create_block(rgb)]
    for _ in range(log2):
        solid_ids.append(space.create_children([solid_ids[-1]] * 8))

    # per level: sorted packed keys of mixed cells and their node ids
    prev_keys = np.zeros(0, np.int64)
    prev_ids = np.zeros(0, np.int64)

    for level in range(1, log2 + 1):
        s = 1 << level
        dim = n >> level  # cells per axis at this level
        pmin = mins[level].reshape(-1)  # indexed [cx*dim + cz]
        pmax = maxs[level].reshape(-1)
        lo = np.clip(pmin // s, 0, dim)
        hi = np.clip(-(-pmax // s), 0, dim)
        cy, counts = _ranges(lo, hi)
        col = np.repeat(np.arange(dim * dim, dtype=np.int64), counts)
        cx = col // dim
        cz = col % dim

        if len(cy) == 0:
            prev_keys = np.zeros(0, np.int64)
            prev_ids = np.zeros(0, np.int64)
            continue

        # classify the 8 children of every mixed cell against level-1
        cdim = dim * 2
        s2 = s >> 1
        cmin_l = mins[level - 1]
        cmax_l = maxs[level - 1]
        children = np.empty((len(cy), 8), np.int64)
        for oz in (0, 1):
            for oy in (0, 1):
                for ox in (0, 1):
                    i = ox | (oy << 1) | (oz << 2)
                    ccx = 2 * cx + ox
                    ccy = 2 * cy + oy
                    ccz = 2 * cz + oz
                    cmn = cmin_l[ccx, ccz]
                    cmx = cmax_l[ccx, ccz]
                    is_solid = (ccy + 1) * s2 <= cmn
                    is_empty = ccy * s2 >= cmx
                    out = np.full(len(cy), -1, np.int64)
                    out[is_solid] = solid_ids[level - 1]
                    is_mixed = ~(is_solid | is_empty)
                    if is_mixed.any():
                        key = (ccx[is_mixed] * cdim + ccz[is_mixed]) * cdim \
                            + ccy[is_mixed]
                        pos = np.searchsorted(prev_keys, key)
                        assert len(prev_keys) and (prev_keys[pos] == key).all(), (
                            "mixed child must exist at previous level"
                        )
                        out[is_mixed] = prev_ids[pos]
                    children[:, i] = out

        uniq_rows, inv = np.unique(children, axis=0, return_inverse=True)
        created = np.fromiter(
            (
                space.create_children([None if c < 0 else int(c) for c in row])
                for row in uniq_rows
            ),
            dtype=np.int64,
            count=len(uniq_rows),
        )
        ids = created[inv.reshape(-1)]
        keys = (cx * dim + cz) * dim + cy
        order = np.argsort(keys)
        prev_keys = keys[order]
        prev_ids = ids[order]

    # root: the single level-log2 cell
    pmin = int(mins[log2][0, 0])
    pmax = int(maxs[log2][0, 0])
    if n <= pmin:
        root = solid_ids[log2]
    elif pmax <= 0:
        root = None
    else:
        assert len(prev_ids) == 1
        root = int(prev_ids[0])
    space.set_root(root)
    return space


def generate(log2_size: int = REFERENCE_LOG2_SIZE, verbose: bool = True,
             backend: str = "auto", seed_scale: int | None = None,
             seed_noise: int | None = None, device="cuda"):
    """Full worldgen (worldgen.rs:10-59): heightmap on ``device``, then
    the octree on the host.

    backend: ``"native"`` (the C++ builder; raises without ``g++``),
    ``"python"``, or ``"auto"`` (native when it can be built). Both give
    identical octrees; the native one builds its pyramid internally.

    The space keeps its heightmap (``heights``, uint32 [x, z]), the
    terrain colour and ``heights_exact``: an unedited terrain world is a
    heightfield, which world/boxes.py turns into the raster box soup.
    A point edit clears ``heights_exact`` (SvoSpace.set)."""
    t0 = time.monotonic()
    h = heightmap(
        log2_size,
        seed_scale=SEED_SCALE if seed_scale is None else seed_scale,
        seed_noise=SEED_NOISE if seed_noise is None else seed_noise,
        device=device,
    )
    t1 = time.monotonic()
    if backend not in ("auto", "native", "python"):
        raise ValueError(f"generate: unknown backend {backend!r}")
    if backend == "auto":
        backend = "native" if native.available() else "python"
    if backend == "native":
        space = native.NativeSvoSpace()
        space.build_terrain(h, TERRAIN_RGB)
    else:
        mins, maxs = minmax_pyramid(h)
        space = build_octree(mins, maxs)
    t2 = time.monotonic()
    if verbose:
        print(f"heightmaps in {t1 - t0:.3f}s")
        print(f"octree in {t2 - t1:.3f}s [{backend}]")
        print(f"world size: {space.mem_usage() / 1024 / 1024:.0f} mib "
              f"({space.num_nodes()} nodes)")
    space.heights = h
    space.terrain_rgb = TERRAIN_RGB
    space.heights_exact = True
    return space
