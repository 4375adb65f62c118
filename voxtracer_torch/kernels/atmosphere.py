"""Planet surface + exponential-atmosphere fog scattering
(behavioural reference raycast_planet, raytrace.wgsl:262-327).

``raycast_planet`` runs the march in ``fog.fog_march`` (kernel K1 on a
card) and keeps the random draws and the assembly of the result outside
it, as ``voxtracer/kernels/atmosphere.py:_raycast_planet_pallas`` does:
3 draws per call (1 free path + 2 in cos_hemisphere), whatever the
outcome.
"""

from __future__ import annotations

import torch

from voxtracer_torch.core import rng as vrng
from voxtracer_torch.core.sampling import cos_hemisphere
from voxtracer_torch.core.vecmath import div, normalize
from voxtracer_torch.kernels import fog
from voxtracer_torch.kernels.fog import FOG_FACTOR, PLANET_RADIUS

GROUND_RGBA = (0.25, 0.25, 0.25, 0.0)  # raytrace.wgsl:300
FOG_RGBA = (1.0, 1.0, 1.0, 0.0)  # raytrace.wgsl:320


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
    code, t = fog.fog_march(start_b, dir_b, dens_b, y0, n_steps=n_steps,
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


def transmittance_to_escape(start, direction, sea_level_density,
                            n_steps: int = 256):
    """Probability that a ray leaves the atmosphere without scattering or
    hitting the planet (plain PyTorch; for the statistics tests)."""
    t0, t1, valid, surf, p = fog._sphere_span(start, direction)
    density_scaled = div(t1 - t0, float(n_steps)) * sea_level_density
    tau = torch.zeros_like(t1)
    for i in range(n_steps):
        _, t_s1 = fog._segment(i, n_steps, t0, t1)
        alt = fog._altitude(p, direction, t_s1)
        tau = tau + density_scaled * torch.exp(-alt * FOG_FACTOR)
    escape = torch.where(valid, torch.exp(-tau), 1.0)
    return torch.where(surf, 0.0, escape)
