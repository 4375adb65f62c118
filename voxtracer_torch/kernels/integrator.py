"""The spectral path-tracing integrator, on the SVO cast or, for terrain
worlds, the heightfield walk.

Per bounce, as ``voxtracer/kernels/integrator.py:trace_paths``
(behavioural reference raytrace.wgsl:329-413):

1. cast planet/fog (atmosphere.raycast_planet) and the SVO capped at the
   fog event distance; the nearer event wins, compared here because the
   traversal's cap is advisory (raytrace.wgsl:342-347),
2. on a miss, primary rays looking into the sun cone add the sun; every
   missing ray ends (raytrace.wgsl:349-355),
3. next-event estimation toward the sun disk: one planet cast and a
   two-stage shadow cast (a cast capped at NEE_NEAR, then a full cast for
   the lanes it left open) (raytrace.wgsl:362-383),
4. emissive rule: a hit whose rgba == (1,1,1,1) adds light*10*rgb*a
   (raytrace.wgsl:386-389),
5. cosine-hemisphere bounce, light *= albedo * brdf * pi
   (raytrace.wgsl:390-397),
6. Russian roulette below throughput 0.5 (raytrace.wgsl:401-409).

Every bounce draws 11 random3 values per lane, masks or not:
raycast_planet 3 + sample_sun 2 + raycast_planet 3 + cos_hemisphere 2 +
roulette 1 (integrator.py:548-553 of the JAX package).

The bounce loop is masked, as the JAX package's uncompacted loop: every
lane runs every bounce, the ``alive`` mask gates what a finished path
may change, and the loop ends early once no lane is alive. The casts
skip the lanes whose results no live path reads: the SVO casts take
their masks as the JAX loop does, the bounce march takes ``alive`` and
the NEE march ``live_hit & facing`` (every use of its result is under
that mask), so radiance and RNG state are those of the unmasked loop.

With a heightfield pack (``hf_mips``, ``hf_offsets``, ``terrain_rgb``;
kernels/heightfield.py) every bounce cast is the heightfield walk (K4)
capped at the fog event, NEE is ONE uncapped walk (it settles near
occluders in a few steps, so the two stages buy nothing), and hits shade
with the terrain colour, the bits ``leaf_rgb`` reads from the one
interned terrain leaf. The two engines return the same hits lane for
lane, so radiance and RNG state are the same. With ``hf_edit_bounds``
the cast is ``hf_raycast_edited`` and re-cast lanes shade by their leaf.

With a box soup (``render_sample(..., soup=...)``) the first bounce takes
its world hit from the rasterizer (``kernels/raster.raster_cast_exact``
on the jittered camera rays) instead of an SVO cast: the same first hit,
so the same radiance. Without a soup, on unedited terrain, ``hf_sky_env``
(the pose's horizon envelope, kernels/skyline.py) resumes every camera
ray's walk in certified air (K5 then K4): again the same first hit.
"""

from __future__ import annotations

import torch

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.core import rng as vrng
from voxtracer_torch.core import sampling
from voxtracer_torch.core.sampling import (COS_SUN_RADIUS, PI, SUN_COLOR,
                                           SUN_WEIGHT)
from voxtracer_torch.core.spectra import fog_density, spectral_throughput
from voxtracer_torch.core.vecmath import dot
from voxtracer_torch.kernels import (atmosphere, beam, bitdda,
                                     heightfield, raster, sunshadow)
from voxtracer_torch.kernels.traverse import FAR, leaf_rgb, svo_raycast

# most blocked shadow rays block within a few voxels (terrain self-shadow;
# voxtracer/kernels/integrator.py:176-181), so a cast capped here settles
# them cheaply and only the open lanes take the full cast
NEE_NEAR = 8.0
RR_THRESHOLD = 0.5


def trace_paths(table, root: int, height: int, lut, start, direction,
                wavelength, sun, state, max_bounces: int = 24,
                fog_steps: int = 64, primary=None, hf_mips=None,
                hf_offsets: tuple | None = None, terrain_rgb=None,
                hf_edit_bounds=None, sun_maps=None, bitworld=None,
                bit_size: int = 0):
    """Trace one spectral path per ray; returns (state, radiance (..., 3)).

    table/root/height: the node table (kernels.traverse conventions);
    lut: (L, 3) wavelength -> linear RGB; start: (..., 3) ray origins
    (broadcasts); direction: (..., 3) unit directions; wavelength: (...,)
    in [0, 1); sun: (3,) unit sun direction; state: (..., 3) int64 RNG
    state. ``primary``: optional uncapped first-bounce world hit (dict
    hit/t/normal/rgb of the batch shape, e.g. rasterized); bounce 0 then
    casts no SVO ray. An uncapped first hit nearer than the fog event is
    what the capped cast would return. ``hf_mips``/``hf_offsets``/
    ``terrain_rgb``: the world's heightfield pack (pre-edit) and terrain
    colour; the casts then walk it (module doc). ``hf_edit_bounds``: (2,
    3) or (K, 2, 3) boxes covering every point edit since worldgen, which
    keeps the walk on an edited world. ``sun_maps``: the sun-visibility
    thresholds of this (world, sun) (``sunshadow.upload(sunshadow.build(
    ...))``), with the heightfield pack: NEE lanes the maps prove lit skip
    the shadow walk, and the occlusion boolean is unchanged, so radiance
    and state are the same bit for bit; dropped with edit bounds (the maps
    prove pre-edit visibility only). ``bitworld``/``bit_size``: the
    world's packed occupancy pyramid (``BitGrid.to_device``) and edge:
    bounce and shadow casts then take the bit-grid DDA (K8), hits coloured
    from the node table (``bitdda.svo_color_at``); as in the JAX package it
    comes before the heightfield for those casts.
    """
    use_hf = hf_mips is not None
    if hf_edit_bounds is not None:
        sun_maps = None
    if use_hf:
        hmax_w = heightfield.terrain_max(hf_mips, hf_offsets)
        trgb = torch.as_tensor(terrain_rgb, dtype=torch.float32).to(
            hf_mips.device)
    density = fog_density(wavelength)
    light = spectral_throughput(lut, wavelength)
    color = torch.zeros_like(light)
    alive = torch.ones(wavelength.shape, dtype=torch.bool,
                       device=wavelength.device)
    pos = start.expand(direction.shape).to(torch.float32)
    d = direction

    def cast(p, dr, distance, active):
        if not use_hf:
            return svo_raycast(table, root, height, p, dr, distance=distance,
                               active=active)
        if hf_edit_bounds is not None:
            return heightfield.hf_raycast_edited(
                hf_mips, hf_offsets, height, table, root, hf_edit_bounds, p,
                dr, distance=distance, active=active, hmax_w=hmax_w)
        return heightfield.hf_raycast(hf_mips, hf_offsets, height, p, dr,
                                      distance=distance, active=active,
                                      hmax_w=hmax_w)

    def nee_occluded(p, sun_dir, act):
        if bitworld is not None:
            return bitdda.bitgrid_raycast(*bitworld, bit_size, p, sun_dir,
                                          active=act)["hit"]
        if use_hf:
            if sun_maps is not None:
                lit = sunshadow.sun_clear(sun_maps, p)
                return cast(p, sun_dir, FAR, act & ~lit)["hit"] & ~lit
            return cast(p, sun_dir, FAR, act)["hit"]
        blocked = cast(p, sun_dir, NEE_NEAR, act)["hit"]
        return blocked | cast(p, sun_dir, FAR, act & ~blocked)["hit"]

    for i in range(max_bounces):
        state, planet = atmosphere.raycast_planet(state, pos, d, density,
                                                  n_steps=fog_steps,
                                                  active=alive)
        cap = torch.where(planet["hit"], planet["t"], FAR)
        if i == 0 and primary is not None:
            svo = primary
            svo_rgb = primary["rgb"]
        elif bitworld is not None:
            svo = bitdda.bitgrid_raycast(*bitworld, bit_size, pos, d,
                                         distance=cap, active=alive)
            svo_rgb = bitdda.svo_color_at(
                table, root, height, svo["voxel"],
                svo["hit"] & (svo["t"] <= cap) & alive)
        else:
            svo = cast(pos, d, cap, alive)
            if not use_hf:
                svo_rgb = leaf_rgb(table, svo["node"])
            else:
                svo_rgb = trgb.expand(svo["normal"].shape)
                if hf_edit_bounds is not None:
                    svo_rgb = torch.where(
                        (svo["from_svo"] & svo["hit"])[..., None],
                        leaf_rgb(table, svo["node"]), svo_rgb)
        use_svo = svo["hit"] & (svo["t"] <= cap)
        hit_any = planet["hit"] | use_svo
        rgba = torch.where(
            use_svo[..., None],
            torch.cat([svo_rgb, torch.ones_like(svo_rgb[..., :1])], dim=-1),
            planet["rgba"],
        )
        t_hit = torch.where(use_svo, svo["t"], planet["t"])
        normal = torch.where(use_svo[..., None], svo["normal"],
                             planet["normal"])
        live_hit = alive & hit_any

        # miss: primary rays see the sun disk directly
        if i == 0:
            sun_disk = dot(d, sun) > COS_SUN_RADIUS
            color = color + torch.where((alive & ~hit_any & sun_disk)[..., None],
                                        light * SUN_COLOR, 0.0)

        pos = torch.where(live_hit[..., None], pos + d * t_hit[..., None], pos)

        # next-event estimation toward the sun
        state, sun_dir = sampling.sample_sun(state, sun)
        facing = dot(sun_dir, normal) > 0.0
        state, sun_planet = atmosphere.raycast_planet(
            state, pos, sun_dir, density, n_steps=fog_steps,
            active=live_hit & facing)
        nee_act = live_hit & facing & ~sun_planet["hit"]
        sun_visible = ~sun_planet["hit"] \
            & ~nee_occluded(pos, sun_dir, nee_act)
        nee = (
            SUN_COLOR
            * rgba[..., :3]
            * sampling.brdf(d, sun_dir, normal)
            * (dot(normal, sun_dir) * 2.0 * PI * SUN_WEIGHT)[..., None]
        )
        color = color + torch.where((live_hit & facing & sun_visible)[..., None],
                                    light * nee, 0.0)

        # emissive (pure-white placed blocks)
        emissive = torch.all(rgba == 1.0, dim=-1)
        color = color + torch.where(
            (live_hit & emissive)[..., None],
            light * 10.0 * rgba[..., :3] * rgba[..., 3:4],
            0.0,
        )

        # indirect bounce
        state, ind_dir = sampling.cos_hemisphere(state, normal)
        light = torch.where(
            live_hit[..., None],
            light * rgba[..., :3] * (sampling.brdf(d, ind_dir, normal) * PI),
            light,
        )
        d = torch.where(live_hit[..., None], ind_dir, d)

        # Russian roulette
        state, rr = vrng.random3(state)
        rr_active = live_hit & torch.all(light < RR_THRESHOLD, dim=-1)
        survive = rr[..., 0] < RR_THRESHOLD
        light = torch.where((rr_active & survive)[..., None],
                            light * (1.0 / RR_THRESHOLD), light)
        alive = live_hit & (~rr_active | survive)
        if not bool(alive.any()):
            break
    return state, color


def _primary(cam_pos, cam_basis, frame_seed, width_px, height_px, device,
             row0: int = 0, rows: int | None = None):
    """Seeded per-pixel state, jittered camera rays and wavelengths of the
    frame rows [row0, row0 + rows) (all rows by default), each pixel
    seeded and mapped by its row in the full frame."""
    py, px = vcam.pixel_grid(width_px, height_px if rows is None else rows,
                             device)
    py = py + row0
    state = vrng.seed_pixels(frame_seed, px, py)
    state, rnd = vrng.random3(state)
    ld = vcam.pixel_ndc(px, py, width_px, height_px)
    d = vcam.ray_directions(cam_basis, ld, jitter=rnd[..., :2],
                            height=height_px)
    return state, d, rnd[..., 2]


def _raster_primary(table, root, height, cam_pos, cam_basis, d, width_px,
                    height_px, soup, soup_bins, hf=None, band=None):
    """The first world hit of every jittered camera ray from the box soup
    (one k-batched resolve when ``d`` has a leading sample axis); ``hf``
    = (hf_mips, hf_offsets, terrain_rgb) puts the fallback on K4;
    ``band`` = (row0, rows), TILE-aligned, when ``d`` holds those rows of
    the frame only."""
    row0, rows = band if band is not None else (0, None)
    pr = raster.raster_cast_exact(
        soup[0], soup[1], soup[2], cam_pos, cam_basis, height, width_px,
        height_px, table=table, root=root, ray_dirs=d, bins=soup_bins, hf=hf,
        want_voxel=False, band_row0=row0, band_rows=rows)
    # a single sample comes back without its leading axis
    lead = pr["hit"].dim()
    return {k: pr[k].reshape(d.shape[:-1] + pr[k].shape[lead:])
            for k in ("hit", "t", "normal", "rgb")}


def _fallback_hf(hf_mips, hf_offsets, terrain_rgb, hf_edit_bounds):
    """The rasterizer's fallback rides the heightfield walk on unedited
    terrain only (the walk alone does not see edits)."""
    if hf_mips is None or terrain_rgb is None or hf_edit_bounds is not None:
        return None
    return hf_mips, hf_offsets, terrain_rgb


def _hf_env_primary(hf_mips, hf_offsets: tuple, height: int, cam_pos, d,
                    terrain_rgb, hf_sky_env):
    """The uncapped first hit of every camera ray ``d`` (..., 3) on the
    heightfield, each walk resumed at its certified-air ``t_min`` from the
    pose's envelope ``hf_sky_env = (E, d0, g[, K[, S]])`` and started 3
    tile levels down (``voxtracer/kernels/integrator.py:567``). The
    resumed walk equals the walk from the start, and an uncapped first
    hit is what bounce 0's capped cast would return below the cap, so the
    radiance is the same bit for bit."""
    sh = d.shape[:-1]
    pos = torch.as_tensor(cam_pos, dtype=torch.float32).to(d.device)
    # d keeps its (k, H, W) shape: K5 walks an image in pixel tiles
    pr = heightfield.hf_raycast(hf_mips, hf_offsets, height, pos, d,
                                sky_env=hf_sky_env)
    trgb = torch.as_tensor(terrain_rgb, dtype=torch.float32).to(d.device)
    return dict(hit=pr["hit"], t=pr["t"], normal=pr["normal"],
                rgb=trgb.expand(sh + (3,)))


def _beam_primary(table, aug, root, height, cam_pos, d):
    """The first world hit of every jittered camera ray on the beam engine
    (``voxtracer/kernels/integrator.py:744-751``: 8x8 tiles, K 64, 1024
    steps, 4 rounds), one frame at a time when ``d`` has a leading sample
    axis."""
    if d.shape[-3] % 8 or d.shape[-2] % 8:
        raise ValueError("beam-primary path tracing needs 8-aligned "
                         "dimensions")
    frames = d.reshape((-1,) + d.shape[-3:])
    parts = [beam.beam_primary_frame_cast(table, aug, root, height, cam_pos,
                                          f, tile=8, K=64, max_steps=1024,
                                          rounds=4) for f in frames]
    return {k: torch.stack([p[k] for p in parts]).reshape(
        d.shape[:-1] + parts[0][k].shape[2:])
        for k in ("hit", "t", "normal", "rgb")}


def _first_hits(table, root, height, cam_pos, cam_basis, d, width_px,
                height_px, soup, soup_bins, hf_mips, hf_offsets, terrain_rgb,
                hf_edit_bounds, hf_sky_env, band=None, aug=None):
    """Bounce 0's world hits when an engine other than the bounce cast
    serves them: the rasterizer with a soup, else the beam engine with
    ``aug``, else the envelope-resumed walk on unedited terrain with an
    envelope; else None. ``band``: the rasterizer's TILE-aligned (row0,
    rows) when ``d`` is a band."""
    if soup is not None:
        return _raster_primary(
            table, root, height, cam_pos, cam_basis, d, width_px, height_px,
            soup, soup_bins,
            hf=_fallback_hf(hf_mips, hf_offsets, terrain_rgb, hf_edit_bounds),
            band=band)
    if aug is not None:
        return _beam_primary(table, aug, root, height, cam_pos, d)
    if hf_mips is not None and hf_sky_env is not None \
            and hf_edit_bounds is None:
        return _hf_env_primary(hf_mips, hf_offsets, height, cam_pos, d,
                               terrain_rgb, hf_sky_env)
    return None


def _aligned_band(row0: int, rows: int, height_px: int):
    """The TILE-aligned run of frame rows ``(r0a, rp)`` that a band [row0,
    row0 + rows) rasterizes, and the band's offset in it
    (``voxtracer/kernels/integrator.py:709-742``): whole tiles with one
    to spare, inside the tile-padded frame."""
    TILE = raster.TILE
    th_f = -(-height_px // TILE)
    rp = min(-(-rows // TILE) * TILE + TILE, th_f * TILE)
    r0a = min(max(row0 // TILE * TILE, 0), th_f * TILE - rp)
    if not 0 <= row0 - r0a <= rp - rows:
        raise ValueError(f"render_sample: rows [{row0}, {row0 + rows}) lie "
                         f"outside the {th_f * TILE}-row tiled frame")
    return r0a, rp, row0 - r0a


def render_sample(table, root: int, height: int, lut, cam_pos, cam_basis,
                  sun, frame_seed, width_px: int, height_px: int,
                  max_bounces: int = 24, fog_steps: int = 64, soup=None,
                  soup_bins=None, hf_mips=None,
                  hf_offsets: tuple | None = None, terrain_rgb=None,
                  hf_edit_bounds=None, hf_sky_env=None, row0: int = 0,
                  rows: int | None = None, sun_maps=None, aug=None,
                  bitworld=None, bit_size: int = 0):
    """One progressive sample, 1 spectral path per pixel
    (raytrace.wgsl:415-430): seed from (frame_seed, pixel), draw jitter
    and wavelength, trace. ``soup``: optional (box_lo, box_size,
    box_attr) on the table's device (``raster.soup_to_device``); the
    first bounce is then rasterized, against ``soup_bins`` (the pose's
    jittered ``raster.raster_bins``) when given. ``hf_*``/``terrain_rgb``:
    the heightfield pack for ``trace_paths``; without edit bounds the
    rasterizer's fallback rides it too. ``hf_sky_env``: ``(E, d0, g[, K[,
    S]])``, the envelope built for ``cam_pos``; taken for the primaries when
    ``hf_mips`` is given, without a soup and without edit bounds (as in
    the JAX package). ``row0``/``rows``: render only the frame rows
    [row0, row0 + rows) (the tile-sharded step's band); every pixel is
    seeded and mapped by its row in the full ``height_px`` frame, so the
    band's rows are the full frame's, bit for bit, and rows past the
    frame's edge are traced like any other. With a soup the band
    rasterizes its TILE-aligned run of rows (``_aligned_band``).
    ``aug``: the beam engine's rows (``beam.build_aug_table``) for the
    primaries when there is no soup (8-aligned frames and bands);
    ``sun_maps``, ``bitworld``/``bit_size``: as ``trace_paths``. Returns
    the (rows, W, 3) radiance on the table's device ((H, W, 3) for the
    whole frame)."""
    dev = table.device
    if rows is None:
        rows = height_px
    band = None
    r0a, rp, off = row0, rows, 0
    if soup is not None and rows != height_px:
        r0a, rp, off = _aligned_band(row0, rows, height_px)
        band = (r0a, rp)
    state, d, wavelength = _primary(cam_pos, cam_basis, frame_seed, width_px,
                                    height_px, dev, r0a, rp)
    primary = _first_hits(table, root, height, cam_pos, cam_basis, d,
                          width_px, height_px, soup, soup_bins, hf_mips,
                          hf_offsets, terrain_rgb, hf_edit_bounds, hf_sky_env,
                          band, aug)
    if band is not None:
        state, d, wavelength = (a[off:off + rows]
                                for a in (state, d, wavelength))
        primary = {k: v[off:off + rows] for k, v in primary.items()}
    pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    _, radiance = trace_paths(table, root, height, lut, pos, d, wavelength,
                              sun.to(dev), state, max_bounces, fog_steps,
                              primary=primary, hf_mips=hf_mips,
                              hf_offsets=hf_offsets, terrain_rgb=terrain_rgb,
                              hf_edit_bounds=hf_edit_bounds,
                              sun_maps=sun_maps, bitworld=bitworld,
                              bit_size=bit_size)
    return radiance


def render_samples(table, root: int, height: int, lut, cam_pos, cam_basis,
                   sun, frame_seeds, width_px: int, height_px: int,
                   max_bounces: int = 24, fog_steps: int = 64, soup=None,
                   soup_bins=None, hf_mips=None,
                   hf_offsets: tuple | None = None, terrain_rgb=None,
                   hf_edit_bounds=None, hf_sky_env=None, sun_maps=None,
                   aug=None, bitworld=None, bit_size: int = 0):
    """k samples traced as one batch of k*H*W paths; returns the (H, W, 3)
    radiance SUM, added sample by sample in order, so it equals k
    render_sample calls summed in sequence, bit for bit. With a ``soup``
    the k samples' primaries are ONE k-batched resolve against one set of
    pose bins (``soup_bins``, or bins built here once for all k); with
    ``hf_sky_env`` one envelope lookup and one resumed walk for all k."""
    dev = table.device
    parts = [_primary(cam_pos, cam_basis, s, width_px, height_px, dev)
             for s in frame_seeds]
    state = torch.stack([p[0] for p in parts])
    d = torch.stack([p[1] for p in parts])
    wavelength = torch.stack([p[2] for p in parts])
    if soup is not None and soup_bins is None:
        soup_bins = raster.raster_bins(*soup, cam_pos, cam_basis, height,
                                       width_px, height_px, jittered=True)
    primary = _first_hits(table, root, height, cam_pos, cam_basis, d,
                          width_px, height_px, soup, soup_bins, hf_mips,
                          hf_offsets, terrain_rgb, hf_edit_bounds, hf_sky_env,
                          aug=aug)
    pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    _, r = trace_paths(table, root, height, lut, pos, d, wavelength,
                       sun.to(dev), state, max_bounces, fog_steps,
                       primary=primary, hf_mips=hf_mips,
                       hf_offsets=hf_offsets, terrain_rgb=terrain_rgb,
                       hf_edit_bounds=hf_edit_bounds, sun_maps=sun_maps,
                       bitworld=bitworld, bit_size=bit_size)
    acc = r[0]
    for k in range(1, r.shape[0]):
        acc = acc + r[k]
    return acc
