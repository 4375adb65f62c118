"""Dense voxel grids: the BASELINE config-1 world representation
(``voxtracer/world/dense.py``).

Occupancy is a ``bool[N, N, N]`` grid and colours a ``float32[N, N, N,
3]`` grid gathered only at hit points (``kernels/traverse.dense_raycast``,
``kernels/shade.dense_primary_frame``). Grids index as ``grid[x, y, z]``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass
class DenseWorld:
    solid: np.ndarray  # bool[N, N, N] (a tensor after to_device)
    rgb: np.ndarray  # float32[N, N, N, 3]

    @property
    def size(self) -> int:
        return int(self.solid.shape[0])

    def to_device(self, device="cuda") -> "DenseWorld":
        """The grids as tensors on ``device``."""
        return DenseWorld(torch.as_tensor(np.asarray(self.solid),
                                          device=device),
                          torch.as_tensor(np.asarray(self.rgb),
                                          device=device))


def from_heightmap(heights: np.ndarray, size: int,
                   rgb=(0.5, 0.5, 0.5)) -> DenseWorld:
    """Terrain columns: voxel (x, y, z) is solid iff y < heights[x, z]."""
    n = size
    heights = np.asarray(heights)
    if heights.shape != (n, n):
        raise ValueError(f"from_heightmap: heights {heights.shape}, world "
                         f"edge {n}")
    y = np.arange(n)[None, :, None]
    solid = y < heights[:, None, :]
    colors = np.zeros((n, n, n, 3), np.float32)
    colors[solid] = np.asarray(rgb, np.float32)
    return DenseWorld(solid=solid, rgb=colors)


def from_svo_space(space) -> DenseWorld:
    """Rasterize an SvoSpace to a dense grid (test-scale worlds only)."""
    n = 1 << space.height()
    solid = np.zeros((n, n, n), bool)
    rgb = np.zeros((n, n, n, 3), np.float32)
    for x in range(n):
        for y in range(n):
            for z in range(n):
                c = space.get((x, y, z))
                if c is not None:
                    solid[x, y, z] = True
                    rgb[x, y, z] = c
    return DenseWorld(solid=solid, rgb=rgb)
