"""Packed occupancy bit-grids: the port's copy of
``voxtracer/world/bitgrid.py`` (host numpy; ``to_device`` uploads the
three levels as int32 bit patterns for ``kernels/bitdda.py``). What
follows is the reference's own account.

Measured on TPU v5e (docs/PERF_TPU.md): one XLA row gather costs ~10 ns whether the
row is 4 bytes or 512. The SVO's per-node gathers therefore dominate
every traversal. This module re-expresses occupancy as three dense
levels of packed bits sized so that traversal fetches one *row* per
structure crossed instead of one element per step:

  top    : 1 bit per 128^3-voxel region, whole grid <= 512 bits at
           1024^3 — broadcast to the kernel as constants (zero gathers);
  region : (n/128)^3 rows of 128 u32 = one bit per 8^3-voxel brick in a
           16^3-brick region (one gather per region entered);
  brick  : (n/8)^3 rows of 16 u32 = one bit per voxel (one gather per
           occupied brick entered).

Colors stay in the SVO node table (hit rays do one masked descent).
Bit order: within a region, brick (bx,by,bz) local bit = bz*256+by*16+bx;
within a brick, voxel (vx,vy,vz) local bit = vz*64+vy*8+vx.

Scales to 2048^3 (brick table 1 GiB); larger worlds keep using the SVO
traversal.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

REGION_VOX = 128  # voxels per region edge
BRICK_VOX = 8  # voxels per brick edge
CELLS = REGION_VOX // BRICK_VOX  # 16 bricks per region edge


@dataclass
class BitGrid:
    """Packed occupancy pyramid (host arrays; ``to_device`` uploads them)."""

    size: int  # world edge in voxels (power of two, >= 128)
    top: np.ndarray  # uint32[ceil(nr^3/32)] region occupancy bits
    regions: np.ndarray  # uint32[nr^3, 128] brick bits per region
    bricks: np.ndarray  # uint32[nb^3, 16] voxel bits per brick

    @property
    def nr(self) -> int:
        return self.size // REGION_VOX

    @property
    def nb(self) -> int:
        return self.size // BRICK_VOX

    def to_device(self, device):
        """(top, regions, bricks) as int32 tensors (the uint32 bits) on
        ``device``: the ``bitworld`` of ``bitgrid_raycast`` and
        ``trace_paths``."""
        import torch

        return tuple(torch.from_numpy(np.ascontiguousarray(a).view(np.int32))
                     .to(device) for a in (self.top, self.regions,
                                           self.bricks))


def _pack_bits(bits: np.ndarray, words: int) -> np.ndarray:
    """bits: bool[N, words*32] -> uint32[N, words] little-bit-endian."""
    n = bits.shape[0]
    b = bits.reshape(n, words, 32).astype(np.uint32)
    shifts = np.arange(32, dtype=np.uint32)
    return (b << shifts[None, None, :]).sum(axis=-1, dtype=np.uint32)


def from_dense(solid: np.ndarray) -> BitGrid:
    """Build the bit pyramid from a dense bool[n,n,n] occupancy grid.

    Worlds smaller than one region (n < 128) are zero-padded up to 128
    (the traversal still clips rays to the true world bound).
    """
    n0 = solid.shape[0]
    n = max(n0, REGION_VOX)
    if n0 < n:
        padded = np.zeros((n, n, n), bool)
        padded[:n0, :n0, :n0] = solid
        solid = padded
    assert n % REGION_VOX == 0
    nr = n // REGION_VOX
    nb = n // BRICK_VOX

    # voxel bits -> bricks: index (bx,by,bz) row-major x-major like the
    # SVO convention grid[x,y,z]; local bit = vz*64 + vy*8 + vx
    s = solid.reshape(nb, 8, nb, 8, nb, 8)  # (bx, vx, by, vy, bz, vz)
    s = s.transpose(0, 2, 4, 5, 3, 1)  # (bx, by, bz, vz, vy, vx)
    vox_bits = s.reshape(nb * nb * nb, 512)
    bricks = _pack_bits(vox_bits, 16)

    brick_occ = vox_bits.any(axis=1).reshape(nb, nb, nb)

    # brick bits -> regions: local bit = cz*256 + cy*16 + cx
    r = brick_occ.reshape(nr, CELLS, nr, CELLS, nr, CELLS)
    r = r.transpose(0, 2, 4, 5, 3, 1)  # (rx, ry, rz, cz, cy, cx)
    reg_bits = r.reshape(nr * nr * nr, CELLS**3)
    regions = _pack_bits(reg_bits, 128)

    region_occ = reg_bits.any(axis=1).reshape(-1)
    top_words = max((region_occ.size + 31) // 32, 1)
    top_bits = np.zeros(top_words * 32, bool)
    top_bits[: region_occ.size] = region_occ
    top = _pack_bits(top_bits[None], top_words)[0]

    return BitGrid(size=n, top=top, regions=regions, bricks=bricks)


def from_heightmap(heights: np.ndarray) -> BitGrid:
    """Terrain occupancy (solid iff y < height[x, z]) without
    materializing the dense grid (vectorized per brick layer)."""
    n = heights.shape[0]
    h = np.asarray(heights, np.int64)
    solid = (np.arange(n)[None, :, None] < h[:, None, :])
    return from_dense(solid)


def set_voxel(grid: BitGrid, p, value: bool) -> None:
    """In-place single-voxel edit of the packed pyramid (editor path)."""
    x, y, z = int(p[0]), int(p[1]), int(p[2])
    nb, nr = grid.nb, grid.nr
    bx, by, bz = x // 8, y // 8, z // 8
    bi = (bx * nb + by) * nb + bz
    vbit = (z % 8) * 64 + (y % 8) * 8 + (x % 8)
    w, b = vbit >> 5, np.uint32(1 << (vbit & 31))
    if value:
        grid.bricks[bi, w] |= b
    else:
        grid.bricks[bi, w] &= ~b
    brick_occ = bool(grid.bricks[bi].any())

    rx, ry, rz = x // REGION_VOX, y // REGION_VOX, z // REGION_VOX
    ri = (rx * nr + ry) * nr + rz
    cbit = ((bz % CELLS) * CELLS + (by % CELLS)) * CELLS + (bx % CELLS)
    w, b = cbit >> 5, np.uint32(1 << (cbit & 31))
    if brick_occ:
        grid.regions[ri, w] |= b
    else:
        grid.regions[ri, w] &= ~b
    region_occ = bool(grid.regions[ri].any())
    w, b = ri >> 5, np.uint32(1 << (ri & 31))
    if region_occ:
        grid.top[w] |= b
    else:
        grid.top[w] &= ~b
