"""Deterministic shading paths (``voxtracer/kernels/shade.py``).

``shade_primary`` is the CPU reference renderer's shading
(software.rs:260-276): primary ray only, ``color * (sun·n / 2 + 1)``,
black background. ``shade_shadow`` adds the hard sun-shadow term the
reference left commented out (software.rs:270-271), ``lighting *=
shadow/2 + 0.5``, and a simple sky gradient for misses. Both are fully
deterministic, so they anchor the goldens ``primary_64w`` and
``shadow_64w``; ``kernels/raster.raster_primary_frame`` renders the same
image as ``svo_primary_frame`` on the rasterizer, and the ``dense_*``
frames the same on a dense grid (BASELINE configs 1 and 2).
"""

from __future__ import annotations

import torch

from voxtracer_torch.core.sampling import COS_SUN_RADIUS
from voxtracer_torch.core.vecmath import dot
from voxtracer_torch.kernels.traverse import (dense_raycast, leaf_rgb,
                                              svo_raycast)

ZENITH = (0.25, 0.45, 0.85)
HORIZON = (0.65, 0.75, 0.9)


def _svo_cast(table, root: int, height: int):
    def cast(start, d):
        r = svo_raycast(table, root, height, start, d)
        return r, leaf_rgb(table, r["node"])

    return cast


def _dense_cast(solid, rgb, size: int):
    def cast(start, d):
        r = dense_raycast(solid, start, d, size)
        v = r["voxel"].long()
        col = rgb[v[..., 0], v[..., 1], v[..., 2]]
        return r, torch.where(r["hit"][..., None], col, 0.0)

    return cast


def shade_primary(cast, start, d, sun):
    """software.rs raytrace(): N·L-ish lighting, black background."""
    r, rgb = cast(start, d)
    lighting = dot(sun, r["normal"]) / 2.0 + 1.0
    return rgb * lighting[..., None] * r["hit"][..., None]


def sky_color(d, sun):
    """Horizon-to-zenith blue gradient plus a white sun disk."""
    zenith = torch.tensor(ZENITH, dtype=torch.float32, device=d.device)
    horizon = torch.tensor(HORIZON, dtype=torch.float32, device=d.device)
    h = torch.clamp(d[..., 1], 0.0, 1.0)[..., None]
    sky = horizon * (1 - h) + zenith * h
    disk = (dot(d, sun) > COS_SUN_RADIUS)[..., None]
    return torch.where(disk, torch.full_like(sky, 10.0), sky)


def shade_shadow(cast, start, d, sun, shadow_eps: float = 1.0e-3):
    """Primary + hard sun-shadow ray + sky for misses. The shadow ray
    starts at hit_point - d*eps (software.rs:270)."""
    r, rgb = cast(start, d)
    hit = r["hit"]
    p = start + d * r["t"][..., None] - d * shadow_eps
    sr, _ = cast(p, sun.expand(d.shape))
    lit = ~sr["hit"]
    lighting = dot(sun, r["normal"]) / 2.0 + 1.0
    lighting = lighting * torch.where(lit, 1.0, 0.5)
    surface = rgb * lighting[..., None]
    return torch.where(hit[..., None], surface, sky_color(d, sun))


def svo_primary_frame(table, root: int, height: int, start, d, sun):
    """Shaded primary frame through the SVO cast (K2 on the card)."""
    return shade_primary(_svo_cast(table, root, height), start, d, sun)


def svo_shadow_frame(table, root: int, height: int, start, d, sun):
    """Shaded frame with hard sun shadows through the SVO cast."""
    return shade_shadow(_svo_cast(table, root, height), start, d, sun)


def dense_primary_frame(solid, rgb, size: int, start, d, sun):
    """Shaded primary frame through the dense-grid DDA (config 1)."""
    return shade_primary(_dense_cast(solid, rgb, size), start, d, sun)


def dense_shadow_frame(solid, rgb, size: int, start, d, sun):
    """Shaded frame with hard sun shadows on the dense grid (config 2)."""
    return shade_shadow(_dense_cast(solid, rgb, size), start, d, sun)
