"""The reference's atmosphere: the planet and exponential-fog cast.

Frozen copy of the port's plain arithmetic (``voxtracer_torch/kernels/
fog.py:fog_march_plain`` and ``voxtracer_torch/kernels/atmosphere.py:
raycast_planet``; behavioural reference raytrace.wgsl:262-327), kept
beside the reference so that it imports nothing of the program. Every
lane is marched ``n_steps`` segments from the far end; 3 random draws a
call, whatever the outcome.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from vtbench.reference import rng as vrng
from vtbench.reference.sampling import cos_hemisphere
from vtbench.reference.vecmath import div, normalize, sqrt

PLANET_RADIUS = 6371000.0  # raytrace.wgsl:262
FOG_HALFLIFE = 10400.0 / math.log(2.0)  # raytrace.wgsl:263
FOG_RADIUS = PLANET_RADIUS + 10.0 * FOG_HALFLIFE  # raytrace.wgsl:264
FOG_FACTOR = math.log(2.0) / FOG_HALFLIFE  # raytrace.wgsl:265
GROUND_RGBA = (0.25, 0.25, 0.25, 0.0)  # raytrace.wgsl:300
FOG_RGBA = (1.0, 1.0, 1.0, 0.0)  # raytrace.wgsl:320


def _sphere_span(start, direction):
    """Shell entry/exit (t0, t1 clipped at the planet), valid and surf
    masks, and the planet-centred origin; shared with
    ``atmosphere.transmittance_to_escape``."""
    px, py, pz = start[..., 0], start[..., 1], start[..., 2]
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    pyr = py + PLANET_RADIUS
    pp = px * px + pyr * pyr + pz * pz
    b = 2.0 * (px * dx + pyr * dy + pz * dz)
    c = pp - FOG_RADIUS * FOG_RADIUS
    det = b * b - 4.0 * c
    sq = sqrt(torch.clamp_min(det, 0.0))
    t0 = torch.clamp_min((-b - sq) / 2.0, 0.0)
    t1 = (-b + sq) / 2.0
    valid = (det >= 0.0) & (t1 >= 0.0)

    c_pl = pp - PLANET_RADIUS * PLANET_RADIUS
    det_pl = b * b - 4.0 * c_pl
    sq_pl = sqrt(torch.clamp_min(det_pl, 0.0))
    t0_pl = (-b - sq_pl) / 2.0
    surf = valid & (det_pl >= 0.0) & (t0_pl > 0.0)
    t1 = torch.where(surf, t0_pl, t1)
    return t0, t1, valid, surf, (px, pyr, pz)


def _segment(i: int, n: int, t0, t1):
    """Segment i of n, marched from the far end: (t_s0, t_s1)."""
    a1 = np.float32(i + 1) / np.float32(n)
    a0 = np.float32(i) / np.float32(n)
    t_s0 = float(a0) * t0 + float(np.float32(1.0) - a0) * t1
    t_s1 = float(a1) * t0 + float(np.float32(1.0) - a1) * t1
    return t_s0, t_s1


def _altitude(p, direction, t):
    px, pyr, pz = p
    sx = px + direction[..., 0] * t
    sy = pyr + direction[..., 1] * t
    sz = pz + direction[..., 2] * t
    return sqrt(sx * sx + sy * sy + sz * sz) - PLANET_RADIUS


def fog_march_plain(start, direction, density, y0, n_steps: int = 64,
                    active=None):
    """Plain PyTorch version of K1, on any device, same arithmetic; marches
    every lane and zeroes the inactive ones."""
    t0, t1, valid, surf, p = _sphere_span(start, direction)
    density_scaled = div(t1 - t0, float(n_steps)) * density
    y = y0
    found = torch.zeros_like(valid)
    t_sc = torch.zeros_like(t1)
    for i in range(n_steps):
        t_s0, t_s1 = _segment(i, n_steps, t0, t1)
        alt = _altitude(p, direction, t_s1)
        d_seg = density_scaled * torch.exp(-alt * FOG_FACTOR)
        scatter = ~found & (y < d_seg)
        frac = torch.where(d_seg > 0, y / torch.clamp_min(d_seg, 1e-30), 0.0)
        t_new = frac * t_s0 + (1.0 - frac) * t_s1
        t_sc = torch.where(scatter, t_new, t_sc)
        found = found | scatter
        y = torch.where(found, y, y - d_seg)
    found = found & valid
    code = torch.where(found, 2, torch.where(surf, 1, 0)).to(torch.int32)
    t = torch.where(found, t_sc, torch.where(surf, t1, 0.0))
    if active is not None:
        code = torch.where(active, code, 0).to(torch.int32)
        t = torch.where(active, t, 0.0)
    return code, t


def raycast_planet(state, start, direction, sea_level_density,
                   n_steps: int = 64, active=None):
    """Planet/fog cast.

    state: (..., 3) int64 RNG state; start, direction: (..., 3) float32
    (start broadcasts; direction unit length); sea_level_density: (...,)
    per-ray fog density; active: optional (...,) bool lane mask: inactive
    lanes are not marched and come back as misses (hit False, t 0), while
    the state advances on every lane alike. Returns (new_state, dict(hit,
    t, rgba (..., 4), normal (..., 3))).
    """
    batch_shape = direction.shape[:-1]
    start_b = start.expand(direction.shape).reshape(-1, 3).contiguous()
    dir_b = direction.reshape(-1, 3).contiguous()
    dens_b = sea_level_density.expand(batch_shape).reshape(-1).contiguous()
    if active is not None:
        active = active.expand(batch_shape).reshape(-1).contiguous()

    state, r = vrng.random3(state)
    y0 = (-torch.log(1.0 - r[..., 0])).reshape(-1).contiguous()
    code, t = fog_march_plain(start_b, dir_b, dens_b, y0, n_steps=n_steps,
                            active=active)
    code = code.reshape(batch_shape)
    t = t.reshape(batch_shape)

    state, scatter_dir = cos_hemisphere(state, direction)

    surf = code == 1
    found = code == 2
    hit = code > 0
    p = start + torch.tensor([0.0, PLANET_RADIUS, 0.0], dtype=torch.float32,
                             device=direction.device)
    normal = torch.where(
        surf[..., None],
        normalize(p + direction * t[..., None]),
        torch.where(found[..., None], scatter_dir, 0.0),
    )
    dev = direction.device
    rgba = torch.where(
        surf[..., None],
        torch.tensor(GROUND_RGBA, dtype=torch.float32, device=dev),
        torch.where(found[..., None],
                    torch.tensor(FOG_RGBA, dtype=torch.float32, device=dev),
                    0.0),
    )
    return state, dict(hit=hit, t=t, rgba=rgba, normal=normal)
