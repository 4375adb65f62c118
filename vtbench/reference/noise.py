"""Frozen copy of the port's plain arithmetic, ``voxtracer_torch/world/noise.py``, kept
beside the reference so that it imports nothing of the program.

2-D simplex gradient noise and fBm on tensors.

Same lattice hash, gradients and expression order as
``voxtracer/world/noise.py``. The uint32 hash runs in int64 masked to 32
bits after every add and multiply (core/rng.py explains why).
"""

from __future__ import annotations

import torch

from vtbench.reference.rng import MASK
from vtbench.reference.vecmath import div

_F2 = 0.3660254037844386  # (sqrt(3)-1)/2
_G2 = 0.21132486540518713  # (3-sqrt(3))/6
_GX = (1.0, -1.0, 1.0, -1.0, 1.41421356, -1.41421356, 0.0, 0.0)
_GY = (1.0, 1.0, -1.0, -1.0, 0.0, 0.0, 1.41421356, -1.41421356)


def _hash2(ix, iy, seed: int):
    """Integer lattice hash -> uint32 value held in int64."""
    h = ((ix.to(torch.int64) & MASK) * 0x9E3779B1
         + (iy.to(torch.int64) & MASK) * 0x85EBCA77 + (seed & MASK)) & MASK
    h = h ^ (h >> 15)
    h = (h * 0x2C1B3C6D) & MASK
    h = h ^ (h >> 12)
    h = (h * 0x297A2D39) & MASK
    h = h ^ (h >> 15)
    return h


def _grad2(h):
    """Map a hash to one of 8 gradients; returns (gx, gy)."""
    idx = h & 7
    gx = torch.tensor(_GX, dtype=torch.float32, device=h.device)
    gy = torch.tensor(_GY, dtype=torch.float32, device=h.device)
    return gx[idx], gy[idx]


def simplex2(x, y, seed: int = 0):
    """2-D simplex gradient noise, roughly in [-1, 1]."""
    s = (x + y) * _F2
    i = torch.floor(x + s)
    j = torch.floor(y + s)
    t = (i + j) * _G2
    x0 = x - (i - t)
    y0 = y - (j - t)
    upper = x0 > y0
    i1 = upper.to(torch.float32)
    j1 = (~upper).to(torch.float32)
    x1 = x0 - i1 + _G2
    y1 = y0 - j1 + _G2
    x2 = x0 - 1.0 + 2.0 * _G2
    y2 = y0 - 1.0 + 2.0 * _G2
    ii = i.to(torch.int32)
    jj = j.to(torch.int32)

    def corner(cx, cy, hx, hy):
        gx, gy = _grad2(_hash2(hx, hy, seed))
        tt = 0.5 - cx * cx - cy * cy
        tt = torch.clamp_min(tt, 0.0)
        tt = tt * tt
        return tt * tt * (gx * cx + gy * cy)

    n = (
        corner(x0, y0, ii, jj)
        + corner(x1, y1, ii + i1.to(torch.int32), jj + j1.to(torch.int32))
        + corner(x2, y2, ii + 1, jj + 1)
    )
    return 70.0 * n


def fbm2(x, y, seed: int = 0, octaves: int = 7, lacunarity: float = 2.0,
         gain: float = 0.5):
    """Fractional Brownian motion: ``octaves`` stacked simplex2 layers,
    amplitude-normalized to roughly [-1, 1]."""
    total = torch.zeros(torch.broadcast_shapes(x.shape, y.shape),
                        dtype=torch.float32, device=x.device)
    amp = 1.0
    freq = 1.0
    norm = 0.0
    for o in range(octaves):
        total = total + amp * simplex2(x * freq, y * freq, seed=seed + o * 1013)
        norm += amp
        amp *= gain
        freq *= lacunarity
    return div(total, norm)
