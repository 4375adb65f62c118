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

On the card ``trace_paths`` is kernel K9 (csrc/path_trace.cu) for every
argument combination: stage kernels over queues of paths on the card, a
bounce at a time (the planet draw and the scatter-free test of the
march, K1's march, the world cast with K4's, K2's or K8's walk, the
fixed logic up to the sun march with the sun maps' test, the sun march,
the shadow cast, the end of the bounce), and a last pass burns the draws
of the bounces each path skipped, so radiance and RNG state are the
masked loop's bit for bit. The masked loop, ``trace_paths_plain``, is
K9's plain version, which the CPU runs (``route``).

The masked loop is the JAX package's uncompacted loop: every
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

import ctypes
import os

import numpy as np
import torch

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.core import rng as vrng
from voxtracer_torch.core import sampling
from voxtracer_torch.core.sampling import (COS_SUN_RADIUS, PI, SUN_COLOR,
                                           SUN_WEIGHT)
from voxtracer_torch.core.spectra import fog_density, spectral_throughput
from voxtracer_torch.core.vecmath import dot
from voxtracer_torch.kernels import (atmosphere, beam, bitdda, build, fog,
                                     heightfield, raster, sunshadow)
from voxtracer_torch.kernels.traverse import (EPS, FAR, MAX_HEIGHT, leaf_rgb,
                                              svo_raycast)
from voxtracer_torch.utils import profiling

# most blocked shadow rays block within a few voxels (terrain self-shadow;
# voxtracer/kernels/integrator.py:176-181), so a cast capped here settles
# them cheaply and only the open lanes take the full cast
NEE_NEAR = 8.0
RR_THRESHOLD = 0.5
EMISSIVE_GAIN = 10.0
# VOXT_PT_FUSE=1 turns the fused bounce/NEE on by default (trace_paths
# fuse_nee=None), as in the JAX package (voxtracer/kernels/integrator.py:
# 60-67), read once at import. There the fused loop pools each bounce's
# shadow rays with the next bounce's rays in one walk; its radiance is the
# unfused loop's bit for bit and its returned state leads by one planet
# cast's 3 draws (the next bounce's fog event, drawn at the tail of the
# last iteration). K9 already packs each walk into its own stage, so
# pooling buys it nothing: here fusing only advances the returned state
# by those 3 draws, which keeps chained states equal to the JAX
# package's.
_FUSE = os.environ.get("VOXT_PT_FUSE", "0") == "1"
PLANET_DRAWS = 3  # random3 draws of one atmosphere.raycast_planet

# the work of K9's last call, counted by its stages on the card (an int64
# tensor there, read by chip_smoke for the kernel's bound): walk steps,
# fog segments marched, bounces; the marches set up and those the
# scatter-free test settled (csrc/fog_walk.cuh), along d and toward the
# sun; with stats on (k9_args(stats=True), a slower build of the stages
# kept for measurement), the lane steps and the warp steps of each
# lane-fetch stage
K9_STAGES = ("march", "cast", "sun_march", "shadow", "recast",
             "shadow_recast")
# the counts of every build (walk steps by walk; sun_lit: the live, facing
# lanes the sun planet cast left open that the sun maps proved lit, which
# take no shadow walk), then the stats build's
K9_COUNTS = ("hf_steps", "svo_steps", "bit_steps", "fog_segments", "bounces",
             "marches", "marches_free", "sun_marches", "sun_marches_free",
             "sun_lit")
K9_WORK = K9_COUNTS + tuple(
    f"{s}_{k}_steps" for k in ("lane", "warp") for s in K9_STAGES)
last_work = None
# the per-bounce counters of K9's last call (int32 on the card): the
# lengths of the live, march, sun-march, shadow and the edited engine's
# two re-cast queues, then the stages' lane-fetch claims
K9_QUEUES = ("live", "march", "sun_march", "shadow", "recast",
             "shadow_recast")
K9_COUNTERS = 12
last_queues = None
K9_WORDS_PER_PATH = 37  # the path state's words a path (path_trace.cu)
# K9's lane fetch in each stage (csrc/lanes.cuh): K4's settings
STATIC_PCT, CHUNK, REFILL = 75, 32, 4
ENGINES = {"hf": 0, "svo": 1, "edited": 2, "bit": 3}  # K9's engine codes
# the NEE lanes the sun maps settled in the masked loop since the last
# reset (K9 counts the same lanes as its work's sun_lit)
plain_sun_lit = 0


# K9's float32 constants, in csrc/path_trace.cu's PathConsts order: each
# is the float the plain version rounds its Python expression to (a
# constant expression folded in double, then rounded once)
_K9_CONSTS = np.array([
    FAR, NEE_NEAR, COS_SUN_RADIUS, 1.0 - COS_SUN_RADIUS, PI, SUN_WEIGHT,
    SUN_COLOR, sampling.brdf(None, None, None),
    sampling.brdf(None, None, None) * PI, RR_THRESHOLD, 1.0 / RR_THRESHOLD,
    EMISSIVE_GAIN, EPS, fog.PLANET_R_F, fog.PLANET_R2_F, fog.FOG_R2_F,
    fog.FOG_FACTOR_F, *atmosphere.GROUND_RGBA, *atmosphere.FOG_RGBA,
], dtype=np.float32)


def _fuses(fuse_nee, hf_mips, hf_edit_bounds, sun_maps, bitworld,
           wavelength) -> bool:
    """JAX's condition for the fused bounce/NEE: asked for (or
    VOXT_PT_FUSE), on the unedited heightfield, without sun maps or the
    bit grid."""
    return bool((_FUSE if fuse_nee is None else fuse_nee)
                and hf_mips is not None and hf_edit_bounds is None
                and sun_maps is None and bitworld is None
                and wavelength.dim() >= 1)


def k9_engine(hf_mips=None, hf_edit_bounds=None, bitworld=None) -> str:
    """K9's engine for these arguments, as the masked loop picks its
    casts: the bit grid before a heightfield pack, the edited heightfield
    with edit bounds, the SVO without a pack."""
    if bitworld is not None:
        return "bit"
    if hf_mips is None:
        return "svo"
    return "hf" if hf_edit_bounds is None else "edited"


def route(device) -> str:
    """Where ``trace_paths`` sends a call whose tensors lie on ``device``:
    "plain", the masked loop, for the CPU; "k9" for CUDA, whatever the
    options (K9 takes every engine, ``k9_engine``; it reads the sun maps
    on its unedited heightfield engine and, as the masked loop, uses them
    on no other). Any other device raises."""
    kind = torch.device(device).type
    if kind == "cpu":
        return "plain"
    if kind == "cuda":
        return "k9"
    raise ValueError(f"trace_paths: unsupported device {device}")


def trace_paths(table, root: int, height: int, lut, start, direction,
                wavelength, sun, state, max_bounces: int = 24,
                fog_steps: int = 64, primary=None, hf_mips=None,
                hf_offsets: tuple | None = None, terrain_rgb=None,
                hf_edit_bounds=None, sun_maps=None, bitworld=None,
                bit_size: int = 0, fuse_nee: bool | None = None):
    """Trace one spectral path per ray; returns (state, radiance (..., 3)).

    On CUDA tensors K9 (csrc/path_trace.cu) traces every engine (the
    heightfield, with or without sun maps, the edited heightfield, the
    SVO and the bit grid); on CPU tensors the masked loop
    ``trace_paths_plain`` runs. Any other device raises (``route``). Both
    give the same radiance and state bit for bit. ``fuse_nee``: the fused
    bounce/NEE (``_FUSE``, JAX's conditions in ``_fuses``): the same
    radiance, the returned state 3 draws ahead. Arguments as
    ``trace_paths_plain``.
    """
    if route(direction.device) == "plain":
        return trace_paths_plain(
            table, root, height, lut, start, direction, wavelength, sun,
            state, max_bounces, fog_steps, primary, hf_mips, hf_offsets,
            terrain_rgb, hf_edit_bounds, sun_maps, bitworld, bit_size,
            fuse_nee)
    fuse = _fuses(fuse_nee, hf_mips, hf_edit_bounds, sun_maps, bitworld,
                  wavelength)
    return _trace_paths_k9(table, root, height, lut, start, direction,
                           wavelength, sun, state, max_bounces, fog_steps,
                           primary, hf_mips, hf_offsets, terrain_rgb,
                           hf_edit_bounds, sun_maps, bitworld, bit_size,
                           PLANET_DRAWS if fuse else 0)


def k9_launches(max_bounces: int, edited: bool = False) -> int:
    """Kernel launches of one K9 call: a bounce kernel per bounce and one
    more, the two marches, the cast, the shade and the shadow stage per
    bounce (and the two re-casts on the edited engine), and the burn
    pass; the same on the heightfield with sun maps and on the bit
    grid."""
    return (8 if edited else 6) * max_bounces + 2


def k9_inputs(args, kw) -> tuple:
    """``k9_args``' positional inputs for the CUDA tensors of a
    ``trace_paths(*args, **kw)`` call that takes K9 (the fused draws
    included)."""
    fuse = _fuses(kw.get("fuse_nee"), kw.get("hf_mips"),
                  kw.get("hf_edit_bounds"), kw.get("sun_maps"),
                  kw.get("bitworld"), args[6])
    return tuple(args[:11]) + (
        kw.get("primary"), kw.get("hf_mips"), kw.get("hf_offsets"),
        kw.get("terrain_rgb"), kw.get("hf_edit_bounds"), kw.get("sun_maps"),
        kw.get("bitworld"), kw.get("bit_size", 0),
        PLANET_DRAWS if fuse else 0)


def _k9_input(name, x, shape, dtype, dev, move=False):
    """``x`` as a contiguous ``dtype`` tensor of ``shape`` on ``dev``; a
    per-path input must already lie there, a small one (``move``) is
    copied there."""
    if isinstance(x, torch.Tensor) and x.device != dev and not move:
        raise ValueError(f"trace_paths: {name} lies on {x.device}, not {dev}")
    x = torch.as_tensor(x, device=dev)
    return x.to(dtype).expand(shape).contiguous()


def _trace_paths_k9(table, root, height, lut, start, direction, wavelength,
                    sun, state, max_bounces, fog_steps, primary, hf_mips,
                    hf_offsets, terrain_rgb, hf_edit_bounds, sun_maps,
                    bitworld, bit_size, extra_draws):
    """K9's stages and its burn pass on the card, with ``extra_draws``
    more draws on every path's state."""
    global last_work, last_queues
    dev = direction.device
    if max_bounces < 1 or direction.numel() == 0:  # the draws only
        for _ in range(extra_draws):
            state = vrng.pcg3d(state)
        return state, torch.zeros(direction.shape, dtype=torch.float32,
                                  device=dev)
    args, outs = k9_args(table, root, height, lut, start, direction,
                         wavelength, sun, state, max_bounces, fog_steps,
                         primary, hf_mips, hf_offsets, terrain_rgb,
                         hf_edit_bounds, sun_maps, bitworld, bit_size,
                         extra_draws)
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.voxt_path_trace(*args,
                                  torch.cuda.current_stream().cuda_stream)
    build.check(err, "trace_paths")
    profiling.count("launches.path_trace")
    last_work, last_queues = outs[3]["work"], outs[3]["counters"]
    # while the profiler records: this call's queue lengths by bounce, as
    # k9.queued.<queue> (the counters tensor is the call's own)
    profiling.hold("k9.queued", K9_QUEUES, last_queues[:, :len(K9_QUEUES)])
    return k9_result(outs)


def k9_args(table, root, height, lut, start, direction, wavelength, sun,
            state, max_bounces, fog_steps, primary, hf_mips, hf_offsets,
            terrain_rgb, hf_edit_bounds, sun_maps=None, bitworld=None,
            bit_size: int = 0, extra_draws: int = 0,
            fetch=(STATIC_PCT, CHUNK, REFILL), stats: bool = False):
    """The inputs of K9's C entry ``voxt_path_trace`` but its stream, on
    ``direction``'s device, and its outputs (color, state, batch shape,
    and a dict of what the call must keep alive: each path's last bounce
    ``last``, the ``work`` count, the per-bounce ``counters``, the
    tensors that must be ``zeroed`` at launch) for ``k9_result``. The
    engine is ``k9_engine``'s; the sun maps reach the kernel on the
    unedited heightfield only. ``stats``: the stages count their lane and
    warp steps (a slower build, for measurement). Checks what the kernel
    does not take."""
    dev = direction.device
    batch = direction.shape[:-1]
    B = direction.numel() // 3
    if B > build.MAX_LANES:
        raise ValueError(f"trace_paths: {B} paths > {build.MAX_LANES}")
    if not 0 <= fog_steps <= fog.MAX_STEPS:
        raise ValueError(f"trace_paths: fog_steps {fog_steps} outside "
                         f"0..{fog.MAX_STEPS}")
    f32 = torch.float32
    engine = k9_engine(hf_mips, hf_edit_bounds, bitworld)
    if engine in ("svo", "edited") and height > MAX_HEIGHT:
        raise ValueError(f"trace_paths: height {height} > {MAX_HEIGHT}, the "
                         "SVO walk's node stack limit")
    if table.device != dev or table.dtype != torch.int32 \
            or table.dim() != 2 or table.shape[1] != 8 \
            or not table.is_contiguous():
        raise ValueError("trace_paths: table must be a contiguous int32 "
                         f"(N, 8) tensor on {dev}")
    pos = _k9_input("start", start, direction.shape, f32, dev).reshape(B, 3)
    d = _k9_input("direction", direction, direction.shape, f32,
                  dev).reshape(B, 3)
    density = fog_density(wavelength).reshape(B).contiguous()
    light = spectral_throughput(lut, wavelength).reshape(B, 3).contiguous()
    # the uint32 bits as int32: values from 2^31 up less 2^32
    st = _k9_input("state", state, batch + (3,), torch.int64, dev)
    state_in = torch.where(st >= 1 << 31, st - (1 << 32), st) \
        .to(torch.int32).reshape(B, 3)
    sun_t = _k9_input("sun", sun, (3,), f32, dev, move=True)
    tiles = rows = hmax_w = trgb = boxes = None
    tile_log = levels = n_boxes = 0
    if engine in ("hf", "edited"):
        if hf_mips.device != dev or hf_mips.dtype != f32 \
                or not hf_mips.is_contiguous() or hf_mips.dim() != 2 \
                or hf_mips.shape[1] != (1 << hf_offsets[0]) ** 2:
            raise ValueError("trace_paths: hf_mips must be a contiguous "
                             f"float32 (R, TS*TS) tensor on {dev}")
        if hf_offsets[0] not in heightfield.TILE_LOGS \
                or len(hf_offsets) - 1 > heightfield.MAX_LEVELS \
                or height > 30 or hf_mips.numel() >= 1 << 31:
            raise ValueError("trace_paths: the heightfield pack does not "
                             "fit the kernel")
        tiles, tile_log, levels = hf_mips, hf_offsets[0], len(hf_offsets) - 1
        rows = heightfield.row_starts(hf_offsets, dev)
        hmax_w = heightfield.terrain_max(hf_mips, hf_offsets)
        trgb = _k9_input("terrain_rgb", terrain_rgb, (3,), f32, dev,
                         move=True)
    if engine == "edited":
        boxes = torch.as_tensor(hf_edit_bounds, dtype=f32, device=dev)
        boxes = boxes.reshape(-1, 2, 3).contiguous()
        n_boxes = boxes.shape[0]
    grid = (None,) * 3
    if engine == "bit":
        bitdda.check_grid(*bitworld, int(bit_size), dev, "trace_paths")
        grid = tuple(bitworld)
    maps = (None,) * 2
    near_n = far_n = subres = pool = 0
    if engine == "hf" and sun_maps is not None:
        maps = tuple(sun_maps[k] for k in ("t_near", "t_far"))
        for name, m in zip(("t_near", "t_far"), maps):
            if m.device != dev or m.dtype != f32 or m.dim() != 2 \
                    or m.shape[0] != m.shape[1] or not m.is_contiguous():
                raise ValueError(f"trace_paths: sun map {name} must be a "
                                 f"contiguous square float32 tensor on {dev}")
        near_n, far_n = maps[0].shape[0], maps[1].shape[0]
        subres, pool = int(sun_maps["subres"]), int(sun_maps["pool"])
    prim = (None,) * 4
    if primary is not None:
        prim = (_k9_input("primary hit", primary["hit"], batch, torch.bool,
                          dev),
                _k9_input("primary t", primary["t"], batch, f32, dev),
                _k9_input("primary normal", primary["normal"], batch + (3,),
                          f32, dev),
                _k9_input("primary rgb", primary["rgb"], batch + (3,), f32,
                          dev))
    color = torch.empty((B, 3), dtype=f32, device=dev)
    state_out = torch.empty((B, 3), dtype=torch.int32, device=dev)
    last = torch.empty((B,), dtype=torch.int32, device=dev)
    max_last = torch.zeros((1,), dtype=torch.int32, device=dev)
    work = torch.zeros((len(K9_WORK),), dtype=torch.int64, device=dev)
    # the path state, and each bounce's queue lengths and claims (zeroed)
    ws = torch.empty((K9_WORDS_PER_PATH * B,), dtype=torch.int32, device=dev)
    counters = torch.zeros((K9_COUNTERS * (int(max_bounces) + 1),),
                           dtype=torch.int32, device=dev)
    keep = dict(inputs=(pos, d, density, light, state_in, sun_t, rows, hmax_w,
                        trgb, boxes, grid, maps, prim, ws),
                last=last, work=work, zeroed=(max_last, work, counters),
                counters=counters.view(-1, K9_COUNTERS)[:int(max_bounces)])

    def ptr(x):
        return None if x is None else x.data_ptr()

    args = (_K9_CONSTS.ctypes.data_as(ctypes.c_void_p), _K9_CONSTS.size,
            ENGINES[engine], ptr(tiles), tile_log, levels, ptr(rows),
            ptr(hmax_w), table.data_ptr(), int(root), int(height),
            ptr(boxes), n_boxes, ptr(grid[0]),
            0 if grid[0] is None else grid[0].shape[0], ptr(grid[1]),
            ptr(grid[2]), int(bit_size) if engine == "bit" else 0,
            ptr(maps[0]), ptr(maps[1]), near_n, far_n, subres, pool,
            ptr(trgb), sun_t.data_ptr(), pos.data_ptr(),
            d.data_ptr(), light.data_ptr(), density.data_ptr(),
            state_in.data_ptr(), *(ptr(x) for x in prim), color.data_ptr(),
            state_out.data_ptr(), last.data_ptr(), max_last.data_ptr(),
            work.data_ptr(), len(K9_WORK), ws.data_ptr(), ws.numel(),
            counters.data_ptr(), counters.numel(), B, int(max_bounces),
            int(fog_steps), int(extra_draws), int(stats), *fetch)
    return args, (color, state_out, batch, keep)


def k9_result(outs):
    """(state (..., 3) int64, radiance (..., 3)) from K9's outputs."""
    color, state_out, batch, _ = outs
    state = state_out.to(torch.int64) & vrng.MASK
    return state.reshape(batch + (3,)), color.reshape(batch + (3,))


def trace_paths_plain(table, root: int, height: int, lut, start, direction,
                      wavelength, sun, state, max_bounces: int = 24,
                      fog_steps: int = 64, primary=None, hf_mips=None,
                      hf_offsets: tuple | None = None, terrain_rgb=None,
                      hf_edit_bounds=None, sun_maps=None, bitworld=None,
                      bit_size: int = 0, fuse_nee: bool | None = None):
    """K9's plain version, the masked bounce loop on any device: trace one
    spectral path per ray; returns (state, radiance (..., 3)).

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
    comes before the heightfield for those casts. ``fuse_nee``: as
    ``trace_paths``; the loop below is the unfused one, and the fused
    state is its state advanced by one more planet cast's draws.
    """
    fuse = _fuses(fuse_nee, hf_mips, hf_edit_bounds, sun_maps, bitworld,
                  wavelength)
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
        global plain_sun_lit
        if bitworld is not None:
            return bitdda.bitgrid_raycast(*bitworld, bit_size, p, sun_dir,
                                          active=act)["hit"]
        if use_hf:
            if sun_maps is not None:
                lit = sunshadow.sun_clear(sun_maps, p)
                plain_sun_lit += int((act & lit).sum())
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
    if fuse:  # the fused loop's one more fog event, drawn at its tail
        for _ in range(PLANET_DRAWS):
            state = vrng.pcg3d(state)
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
    ``sun_maps``, ``bitworld``/``bit_size``: as ``trace_paths``.
    ``frame_seed``: three uint32 values, or their int64 tensor on the
    table's device; ``cam_pos``, ``cam_basis``, ``terrain_rgb`` and the
    sun may lie there too (float32), and then nothing of the call is
    copied from the host, as a CUDA graph's capture needs
    (``dist/shard.py``). Returns the (rows, W, 3) radiance on the table's
    device ((H, W, 3) for the whole frame)."""
    dev = table.device
    if rows is None:
        rows = height_px
    band = None
    r0a, rp, off = row0, rows, 0
    if soup is not None and rows != height_px:
        r0a, rp, off = _aligned_band(row0, rows, height_px)
        band = (r0a, rp)
    with profiling.span("vt:primary"):
        state, d, wavelength = _primary(cam_pos, cam_basis, frame_seed,
                                        width_px, height_px, dev, r0a, rp)
    with profiling.span("vt:first_hits"):
        primary = _first_hits(table, root, height, cam_pos, cam_basis, d,
                              width_px, height_px, soup, soup_bins, hf_mips,
                              hf_offsets, terrain_rgb, hf_edit_bounds,
                              hf_sky_env, band, aug)
    if band is not None:
        state, d, wavelength = (a[off:off + rows]
                                for a in (state, d, wavelength))
        primary = {k: v[off:off + rows] for k, v in primary.items()}
    pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    with profiling.span("vt:k9"):
        _, radiance = trace_paths(
            table, root, height, lut, pos, d, wavelength, sun.to(dev), state,
            max_bounces, fog_steps, primary=primary, hf_mips=hf_mips,
            hf_offsets=hf_offsets, terrain_rgb=terrain_rgb,
            hf_edit_bounds=hf_edit_bounds, sun_maps=sun_maps,
            bitworld=bitworld, bit_size=bit_size)
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
    ``hf_sky_env`` one envelope lookup and one resumed walk for all k.
    ``frame_seeds``: (k, 3) uint32 values, or their int64 tensor on the
    table's device; the other inputs as ``render_sample``'s."""
    dev = table.device
    with profiling.span("vt:primary"):
        parts = [_primary(cam_pos, cam_basis, s, width_px, height_px, dev)
                 for s in frame_seeds]
        state = torch.stack([p[0] for p in parts])
        d = torch.stack([p[1] for p in parts])
        wavelength = torch.stack([p[2] for p in parts])
    with profiling.span("vt:first_hits"):
        if soup is not None and soup_bins is None:
            soup_bins = raster.raster_bins(*soup, cam_pos, cam_basis, height,
                                           width_px, height_px, jittered=True)
        primary = _first_hits(table, root, height, cam_pos, cam_basis, d,
                              width_px, height_px, soup, soup_bins, hf_mips,
                              hf_offsets, terrain_rgb, hf_edit_bounds,
                              hf_sky_env, aug=aug)
    pos = torch.as_tensor(cam_pos, dtype=torch.float32, device=dev)
    with profiling.span("vt:k9"):
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
