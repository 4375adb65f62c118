"""The reference renderer: spectral path samples, shaded previews and
crosshair picks at chosen pixels, over ``world.World``.

The bounce loop is the masked loop of the port's plain integrator
(``voxtracer_torch/kernels/integrator.py:trace_paths_plain``, behavioural
reference raytrace.wgsl:329-430), frozen here with its casts on the
reference's own world: every lane runs every bounce under an ``alive``
mask, 11 random3 draws a bounce, the loop ends once no lane is alive.
A pixel's path depends only on its frame seed and its pixel, so any set
of pixels is traced alone, bit for bit as in the full frame.

``low=True`` is the check's control: the same computation with every ray
that enters a cast (origin and direction) and all of the radiance
arithmetic rounded to bfloat16, the precision below the float32 that
the configurations state.
"""

from __future__ import annotations

import numpy as np
import torch

from vtbench.reference import atmosphere, camera as vcam, rng as vrng
from vtbench.reference import sampling
from vtbench.reference.sampling import (COS_SUN_RADIUS, PI, SUN_COLOR,
                                        SUN_WEIGHT)
from vtbench.reference.spectra import (build_wl_to_rgb_lut, fog_density,
                                       spectral_throughput)
from vtbench.reference.terrain import FAR
from vtbench.reference.vecmath import dot

RR_THRESHOLD = 0.5


def _q(low):
    if not low:
        return lambda x: x
    return lambda x: x.to(torch.bfloat16).to(torch.float32)


def lut(device):
    return torch.from_numpy(build_wl_to_rgb_lut()).to(device)


def trace(world, lut_t, start, d, wavelength, sun, state, max_bounces,
          fog_steps, world_state=None, low=False, counts=None,
          touched=None):
    """One spectral path per lane: start (B, 3) or (3,), d (B, 3),
    wavelength (B,), sun (3,) unit, state (B, 3) int64. Returns the
    radiance (B, 3). ``counts``: a dict that receives the work the paths
    define: bounces begun by live paths, and fog marches (along the path
    and toward the sun). ``touched``: the pack's sectors that the casts
    after the primaries read are marked in it (``World.cast``)."""
    q = _q(low)
    B = d.shape[0]
    density = fog_density(wavelength)
    light = q(spectral_throughput(lut_t, wavelength))
    color = torch.zeros_like(light)
    alive = torch.ones(B, dtype=torch.bool, device=d.device)
    pos = start.expand(d.shape).to(torch.float32)
    bounces = marches = 0
    for i in range(max_bounces):
        bounces += int(alive.sum())
        marches += int(alive.sum())
        state, planet = atmosphere.raycast_planet(
            state, pos, d, density, n_steps=fog_steps, active=alive)
        cap = torch.where(planet["hit"], planet["t"], FAR)
        w = world.cast(q(pos), q(d), cap, alive, world_state,
                       touched=touched if i else None)
        use_w = w["hit"] & (w["t"] <= cap)
        hit_any = planet["hit"] | use_w
        rgba = torch.where(
            use_w[:, None],
            torch.cat([w["rgb"], torch.ones_like(w["rgb"][:, :1])], dim=-1),
            planet["rgba"])
        t_hit = torch.where(use_w, w["t"], planet["t"])
        normal = torch.where(use_w[:, None], w["normal"], planet["normal"])
        live_hit = alive & hit_any
        if i == 0:
            sun_disk = dot(d, sun) > COS_SUN_RADIUS
            color = q(color + torch.where((alive & ~hit_any & sun_disk)[:, None],
                                          q(light * SUN_COLOR), 0.0))
        pos = torch.where(live_hit[:, None], pos + d * t_hit[:, None], pos)

        state, sun_dir = sampling.sample_sun(state, sun)
        facing = dot(sun_dir, normal) > 0.0
        marches += int((live_hit & facing).sum())
        state, sun_planet = atmosphere.raycast_planet(
            state, pos, sun_dir, density, n_steps=fog_steps,
            active=live_hit & facing)
        nee_act = live_hit & facing & ~sun_planet["hit"]
        occl = world.cast(q(pos), q(sun_dir), FAR, nee_act, world_state,
                          touched=touched)["hit"]
        sun_visible = ~sun_planet["hit"] & ~occl
        nee = q(q(q(SUN_COLOR * rgba[:, :3]) * sampling.brdf(d, sun_dir, normal))
                * q(dot(normal, sun_dir) * 2.0 * PI * SUN_WEIGHT)[:, None])
        color = q(color + torch.where((live_hit & facing & sun_visible)[:, None],
                                      q(light * nee), 0.0))
        emissive = torch.all(rgba == 1.0, dim=-1)
        color = q(color + torch.where(
            (live_hit & emissive)[:, None],
            q(q(light * 10.0 * rgba[:, :3]) * rgba[:, 3:4]), 0.0))

        state, ind_dir = sampling.cos_hemisphere(state, normal)
        light = torch.where(
            live_hit[:, None],
            q(q(light * rgba[:, :3]) * (sampling.brdf(d, ind_dir, normal) * PI)),
            light)
        d = torch.where(live_hit[:, None], ind_dir, d)

        state, rr = vrng.random3(state)
        rr_active = live_hit & torch.all(light < RR_THRESHOLD, dim=-1)
        survive = rr[:, 0] < RR_THRESHOLD
        light = torch.where((rr_active & survive)[:, None],
                            q(light * (1.0 / RR_THRESHOLD)), light)
        alive = live_hit & (~rr_active | survive)
        if not bool(alive.any()):
            break
    if counts is not None:
        counts["paths"] = counts.get("paths", 0) + B
        counts["bounces"] = counts.get("bounces", 0) + bounces
        counts["marches"] = counts.get("marches", 0) + marches
    return color


def samples(world, lut_t, jobs, px, py, W, H, sun, max_bounces, fog_steps,
            low=False, counts=None, touched=None):
    """Path samples at the P pixels ``px``, ``py`` (int32 tensors) of a
    W x H frame, seeded and jittered as the port's ``render_sample`` does
    each pixel, for every job: a dict with the camera ``pos``, ``basis``,
    the frame ``seeds`` ((3,) uint32 each) and the edit ``state`` (or
    None), traced together. Returns one (S, P, 3) radiance per job.
    ``counts``, ``touched``: as ``trace`` takes them."""
    dev = px.device
    q = _q(low)
    P = px.shape[0]
    ld = vcam.pixel_ndc(px, py, W, H)
    st, dirs, wls, pos, ws, sizes = [], [], [], [], [], []
    for job in jobs:
        p = torch.as_tensor(np.asarray(job["pos"], np.float32), device=dev)
        for s in job["seeds"]:
            state = vrng.seed_pixels(s, px, py)
            state, rnd = vrng.random3(state)
            dirs.append(vcam.ray_directions(job["basis"], ld,
                                            jitter=rnd[:, :2], height=H))
            wls.append(rnd[:, 2])
            st.append(state)
            pos.append(p.expand(P, 3))
            ws.append(job.get("state") or 0)
        sizes.append(len(job["seeds"]))
    wstate = None
    if any(ws):
        wstate = torch.as_tensor(np.repeat(np.asarray(ws, np.int64), P),
                                 device=dev)
    sun_t = torch.as_tensor(np.asarray(sun, np.float32), device=dev)
    r = trace(world, lut_t, q(torch.cat(pos)), torch.cat(dirs),
              torch.cat(wls), sun_t, torch.cat(st), max_bounces, fog_steps,
              wstate, low, counts, touched)
    out, k = [], 0
    for n in sizes:
        out.append(r[k * P:(k + n) * P].reshape(n, P, 3))
        k += n
    return out


def preview(world, jobs, px, py, W, H, sun, low=False):
    """The shaded first-hit frame at pixels ``px``, ``py`` (P,) for each
    job (``pos``, ``basis``, ``state``): terrain or block colour x
    (dot(sun, normal) / 2 + 1), black where the ray leaves the world
    (software.rs:260-276). (J, P, 3)."""
    dev = px.device
    q = _q(low)
    P = px.shape[0]
    ld = vcam.pixel_ndc(px, py, W, H)
    d = torch.cat([vcam.ray_directions(j["basis"], ld) for j in jobs])
    pos = torch.cat([torch.as_tensor(np.asarray(j["pos"], np.float32),
                                     device=dev).expand(P, 3) for j in jobs])
    ws = [j.get("state") or 0 for j in jobs]
    wstate = torch.as_tensor(np.repeat(np.asarray(ws, np.int64), P),
                             device=dev) if any(ws) else None
    r = world.cast(q(pos), q(d), FAR, None, wstate)
    sun_t = torch.as_tensor(np.asarray(sun, np.float32), device=dev)
    lighting = q(dot(sun_t, r["normal"]) / 2.0 + 1.0)
    img = q(r["rgb"] * lighting[:, None]) * r["hit"][:, None]
    return img.reshape(len(jobs), P, 3)


def pick(world, jobs, low=False):
    """The block under the crosshair for each job (``pos``, ``yaw``,
    ``pitch``, ``state``): ((x, y, z), normal) int tuples of the
    view-centre ray's first hit (hits at t == 0 count), or None."""
    q = _q(low)
    dev = world.device
    start = torch.as_tensor(np.stack([np.asarray(j["pos"], np.float32)
                                      for j in jobs]), device=dev)
    d = torch.cat([vcam.camera_basis(j["yaw"], j["pitch"])[:, 2][None]
                   for j in jobs]).to(dev)
    ws = [j.get("state") or 0 for j in jobs]
    wstate = torch.as_tensor(ws, dtype=torch.int64, device=dev) \
        if any(ws) else None
    r = world.cast(q(start), q(d), FAR, None, wstate, skip_t0=False)
    out = []
    for k in range(len(jobs)):
        if not bool(r["hit"][k]):
            out.append(None)
        else:
            out.append((tuple(int(c) for c in r["voxel"][k].tolist()),
                        tuple(int(c) for c in r["normal"][k].tolist())))
    return out
