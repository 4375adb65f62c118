"""Per-pose horizon envelope: every primary ray resumes its heightfield walk
in certified air (the port of ``voxtracer/kernels/skyline.py``'s device
path). CUDA kernel K5 (csrc/sky_tmin.cu) is the per-ray lookup; its plain
PyTorch version is ``skyline_env_tmin_plain``. K5 searches a row in two
levels: ``env_summary`` (every ``SUMMARY_BLOCK``-th rung of each row, made
with the table) names the block of 16 rungs that holds ``k*``, then that
block of ``E`` is searched.

For rays from one origin over a heightfield, a ray at azimuth ``a`` with
elevation slope ``tan = d_y / |d_xz|`` passes over a column at horizontal
distance ``d`` and height ``h`` iff ``tan`` exceeds ``(h - o_y) / d``. The
envelope ``E[az, k]`` bounds that slope over every column whose azimuth
falls in bin ``az`` (padded one bin each side) and whose horizontal
distance is at most ``d_k = d0 * g^k`` (a log ladder with ``d_{K-1} = 4n``).
``E`` is nondecreasing in k, so a ray with margin-adjusted slope ``tan``
is in air up to ``d_{k*-1}``, where ``k*`` counts the rungs with ``E <
tan``; ``k* == K`` proves that the ray misses all terrain.

``build_skyline_env_device`` builds the table for one origin from the
pyramid that ``sky_levels_from_hf`` derives from the heightfield pack:
fine levels from a local tile window of the pack, coarse levels from the
pyramid, each cell's bound scatter-maxed into its azimuth-width class and
rung, dilated over the class's width, then a cumulative max over rungs.
CUDA kernel K10 (csrc/sky_env.cu) builds it on the card; its plain
PyTorch version is ``_env_device``, which the CPU runs. Both take their
windows, levels and constants from one host plan (``_env_plan``), and
their tables are equal by bits.
All in float32 with the reference's margins: ``NUM_MARGIN`` over every
cell top, ``REL_MARGIN``/``ABS_MARGIN`` on the ray's slope, one bin of
azimuth padding, the rung rounded down by 1e-3 (a boundary cell lands a
rung early, never late), the class rounded up by 1e-4, and ``ENV_SLACK``
voxels shaved off every resume. The table need not equal the JAX
package's bit for bit: any sound table resumes a walk to the same result
as the walk from the start (``heightfield.hf_raycast``'s t_min contract).
"""

from __future__ import annotations

import ctypes
import math
from typing import NamedTuple

import numpy as np
import torch

from voxtracer_torch.kernels import build
from voxtracer_torch.utils import profiling

NUM_MARGIN = 0.5    # voxels added over every cell max (walk f32 wobble)
REL_MARGIN = 1e-5   # relative tan slack (f32 direction/test rounding)
ABS_MARGIN = 1e-6   # absolute tan slack
ENV_SLACK = 2.0     # voxels shaved off per-ray envelope resumes (f32)
FAR = 3e38          # t_min of a ray that provably misses all terrain
PATCH_COLS = 16     # patch_sky_levels rebuilds above this many columns
PLAIN_CHUNK = 1 << 20  # lanes a chunk of the plain lookup gathers rows for
SUMMARY_BLOCK = 16  # rungs of E that one entry of the summary stands for
MAX_ENV_BINS = 16384  # K10 dilates a row of bins x 3 uint32 in shared memory


_TWO_PI = float(np.float32(2.0 * np.pi))
_PI = float(np.float32(np.pi))


def _jmod(a, b: float):
    """``a % b`` as JAX computes it for floats: the exact ``fmod``, moved
    into [0, b) when its sign differs from b's."""
    r = torch.fmod(a, b)
    return torch.where((r != 0.0) & ((r < 0.0) != (b < 0.0)), r + b, r)


def _strided_max2(a):
    """2x2 max reduce of a square grid."""
    return torch.maximum(torch.maximum(a[0::2, 0::2], a[0::2, 1::2]),
                         torch.maximum(a[1::2, 0::2], a[1::2, 1::2]))


def _coarse_levels(tiles, offsets: tuple, height: int):
    """The pyramid from level ``tile_log`` up: a level-0 row of the pack is
    one level-``tile_log`` cell's columns, so its max is that cell's; a
    column of fractional height h fills the voxel it ends in, so its
    certified top is ceil(h)."""
    tl = offsets[0]
    dp = max((1 << height) >> tl, 1)
    r0max = tiles[offsets[1]:offsets[1] + dp * dp].max(dim=1).values
    coarse = [torch.ceil(r0max).reshape(dp, dp)]
    while coarse[-1].shape[0] > 1:
        coarse.append(_strided_max2(coarse[-1]))
    return tuple(coarse)


def sky_levels_from_hf(tiles, offsets: tuple, height: int):
    """The envelope build's pyramid pack, derived from the heightfield
    pack already on the device (kernels/heightfield.py
    ``build_height_mips``): ``dict(flat, offsets, height, coarse)``."""
    return dict(flat=tiles, offsets=tuple(offsets), height=height,
                coarse=_coarse_levels(tiles, tuple(offsets), height))


def patch_sky_levels(pack, new_flat, cols):
    """The pack after heightfield-exact edits: ``new_flat`` is the patched
    heightfield pack (``patch_height_mips``), ``cols`` the edited (x, z)
    columns. Recomputes the coarse cells above those columns only; above
    ``PATCH_COLS`` columns it rebuilds. Equal to ``sky_levels_from_hf``
    of ``new_flat`` bit for bit (max and ceil are exact)."""
    cols = list(cols)
    if len(cols) > PATCH_COLS:
        return sky_levels_from_hf(new_flat, pack["offsets"], pack["height"])
    offsets, height = pack["offsets"], pack["height"]
    tl = offsets[0]
    dp = max((1 << height) >> tl, 1)
    dev = new_flat.device
    xz = torch.as_tensor(np.asarray(cols, np.int64).reshape(-1, 2),
                         device=dev)
    cx = torch.clamp(xz[:, 0] >> tl, 0, dp - 1)
    cz = torch.clamp(xz[:, 1] >> tl, 0, dp - 1)
    v = torch.ceil(new_flat[offsets[1] + cx * dp + cz].max(dim=1).values)
    c0 = pack["coarse"][0].clone()
    c0[cx, cz] = v
    out = [c0]
    for level in pack["coarse"][1:]:
        # every cell is a function of the level below, already patched,
        # so columns that share a cell write it the same value
        cx, cz = cx >> 1, cz >> 1
        prev = out[-1]
        m = torch.maximum(
            torch.maximum(prev[2 * cx, 2 * cz], prev[2 * cx, 2 * cz + 1]),
            torch.maximum(prev[2 * cx + 1, 2 * cz], prev[2 * cx + 1, 2 * cz + 1]))
        nxt = level.clone()
        nxt[cx, cz] = m
        out.append(nxt)
    return dict(pack, flat=new_flat, coarse=tuple(out))


def _dilate_max(b, w: int):
    """Wraparound sliding max of half-width w over the last axis, by
    log-doubling rolls (the reference's shift schedule)."""
    out = b
    s, done = 1, 0
    while done < w:
        step = min(s, w - done)
        out = torch.maximum(out, torch.maximum(torch.roll(out, step, -1),
                                               torch.roll(out, -step, -1)))
        done += step
        s = min(2 * s, w - done) if w - done > 0 else s
    return out


class _EnvLevel(NamedTuple):
    """One level of the envelope build's fold: cells of ``c`` voxels, the
    window's first cell (``i0``, ``j0``) and its edge ``size``; ``lf`` the
    level's log2 c below the pack's tile (a fine level, read from the
    pack's level-0 rows) or -1, then ``src`` the index of its pyramid
    level in the pack's ``coarse`` (edge ``dim``); ``is_top`` the top
    level, which has no parent gate; the ladder selects the cells from
    ``a_lo`` (nearest distance) whose parent is nearer than ``a_hi``."""
    c: float
    i0: int
    j0: int
    size: int
    lf: int
    src: int
    dim: int
    is_top: bool
    a_lo: float
    a_hi: float


def _env_plan(offsets: tuple, height: int, origin, bins: int, ratio: int,
              K: int, d0: float, cls_step: float):
    """The host's numbers of one envelope build, shared by the plain build
    and K10: the origin and the ladder's and classes' float32 constants,
    each width class's dilation half-width, and the fold's levels
    (``_EnvLevel``) in its order: the fine window levels 0..tile_log-1,
    then the coarse windows tile_log..top."""
    o = np.asarray(origin, np.float32)
    ox, oz = float(o[0]), float(o[2])
    tl = offsets[0]
    TS = 1 << tl
    n = 1 << height
    dp = max(n >> tl, 1)
    # width class c dilates by ceil(2^(c * cls_step)) bins
    n_cls = max(1, int(math.ceil(math.log2(max(bins, 2)) / cls_step)))
    plan = dict(
        ox=ox, oy=float(o[1]), oz=oz,
        bin_w=float(np.float32(2.0 * np.pi / bins)),
        log2_g=float(np.float32(
            math.log2((4.0 * n / d0) ** (1.0 / (K - 1.0))))),
        log2_d0=float(np.float32(math.log2(d0))),
        inv_step=float(np.float32(1.0 / cls_step)),
        cls_w=[min(int(math.ceil(2.0 ** (c * cls_step))), bins // 2)
               for c in range(n_cls)])

    # fine levels 0..tl-1 from a local window of WG x WG tiles: a selected
    # fine cell lies within (ratio + 1) * 2^tl voxels of the origin, and
    # the window reaches (ratio + 2) * 2^tl each side of the origin's tile
    # (shifted inward at the grid's edges, where it still covers the
    # in-grid side)
    span_half = (ratio + 2) * (1 << tl)
    WG = min(2 * (-(-span_half // TS)) + 2, dp)
    tx0 = tz0 = 0
    if dp > WG:
        tx0 = min(max(int(np.floor(np.float32(ox) / np.float32(TS)))
                      - WG // 2, 0), dp - WG)
        tz0 = min(max(int(np.floor(np.float32(oz) / np.float32(TS)))
                      - WG // 2, 0), dp - WG)
    levels = [_EnvLevel(float(1 << lf), (tx0 * TS) >> lf, (tz0 * TS) >> lf,
                        (WG * TS) >> lf, lf, -1, 0, False,
                        float(ratio << lf) if lf else 0.0,
                        float(ratio << lf) * 2.0)
              for lf in range(min(tl, height))]

    # coarse levels tl..top from the pyramid, windowed like the host build
    ext = 2 * ratio + 4  # ceil(a_hi / c) + 4 at every level
    WSZ = 2 * ext + 1
    for idx in range(dp.bit_length()):
        L = tl + idx
        c = float(1 << L)
        dim = max(dp >> idx, 1)
        ci0 = cj0 = 0
        size = dim
        if dim > WSZ:
            size = WSZ
            ci0 = min(max(int(np.floor(np.float32(ox) / np.float32(c))) - ext,
                          0), dim - WSZ)
            cj0 = min(max(int(np.floor(np.float32(oz) / np.float32(c))) - ext,
                          0), dim - WSZ)
        levels.append(_EnvLevel(c, ci0, cj0, size, -1, idx, dim,
                                L == height, ratio * c if c > 1.0 else 0.0,
                                ratio * c * 2.0))
    plan.update(levels=levels, WG=WG, tx0=tx0, tz0=tz0)
    return plan


def _env_device(flat, coarse, origin, offsets: tuple, bins: int, ratio: int,
                K: int, d0: float, height: int, cls_step: float):
    """The envelope table (bins, K) for one origin (``voxtracer/kernels/
    skyline.py:648`` ``_env_device``, op for op in float32): K10's plain
    version, on any device."""
    dev = flat.device
    f32, i64 = torch.float32, torch.int64
    p = _env_plan(offsets, height, origin, bins, ratio, K, d0, cls_step)
    ox, oy, oz = p["ox"], p["oy"], p["oz"]
    tl = offsets[0]
    TS = 1 << tl
    dp = max((1 << height) >> tl, 1)
    log2_d0, inv_step, cls_w = p["log2_d0"], p["inv_step"], p["cls_w"]
    n_cls = len(cls_w)
    # the divisors as tensors on the device: CUDA divides by a Python
    # float as a product with its reciprocal, a rounding off the IEEE
    # quotient that the CPU and K10 take
    bin_w = torch.tensor(p["bin_w"], dtype=f32, device=dev)
    log2_g = torch.tensor(p["log2_g"], dtype=f32, device=dev)
    wide_hw = float(np.float32(np.pi * (1.0 - 1e-6)))
    cls_b = torch.full((n_cls * K * bins,), -math.inf, dtype=f32, device=dev)
    all_k = torch.full((K,), -math.inf, dtype=f32, device=dev)
    ninf = torch.tensor(-math.inf, dtype=f32, device=dev)

    def box_d(bx0, bx1, bz0, bz1):
        dx = torch.clamp_min(torch.maximum(bx0 - ox, ox - bx1), 0.0)
        dz = torch.clamp_min(torch.maximum(bz0 - oz, oz - bz1), 0.0)
        fx = torch.maximum(torch.abs(bx0 - ox), torch.abs(bx1 - ox))
        fz = torch.maximum(torch.abs(bz0 - oz), torch.abs(bz1 - oz))
        return torch.hypot(dx, dz), torch.hypot(fx, fz)

    def fold(hm, lvl: _EnvLevel):
        """Scatter one level's cells (maxima hm over the level's window)
        into the accumulators."""
        c = lvl.c
        iig, jjg = torch.meshgrid(
            lvl.i0 + torch.arange(lvl.size, dtype=i64, device=dev),
            lvl.j0 + torch.arange(lvl.size, dtype=i64, device=dev),
            indexing="ij")
        x0 = iig.reshape(-1).to(f32) * c
        z0 = jjg.reshape(-1).to(f32) * c
        x1, z1 = x0 + c, z0 + c
        d_min, d_max = box_d(x0, x1, z0, z1)
        if lvl.is_top:
            sel = d_min >= lvl.a_lo
        else:
            pc = 2.0 * c
            px0 = torch.floor(x0 / pc) * pc  # exact: pc a power of two
            pz0 = torch.floor(z0 / pc) * pc
            pd_min, _ = box_d(px0, px0 + pc, pz0, pz0 + pc)
            sel = (d_min >= lvl.a_lo) & (pd_min < lvl.a_hi)
        num = hm + NUM_MARGIN - oy
        # a cell above the origin divides by its true nearest distance:
        # one that touches or holds the origin blocks its bins (inf)
        bound = torch.where(num >= 0.0, num / d_min,
                            num / torch.clamp_min(d_max, 1e-12))
        bound = torch.where(torch.isnan(bound), math.inf, bound)
        bound = torch.where(sel, bound, ninf)

        # azimuth centre and half-spread from the four corners
        ac = torch.atan2(0.5 * (z0 + z1) - oz, 0.5 * (x0 + x1) - ox)
        hw = torch.zeros_like(ac)
        for gx, gz in ((x0, z0), (x0, z1), (x1, z0), (x1, z1)):
            dlt = torch.atan2(gz - oz, gx - ox) - ac
            dlt = _jmod(dlt + _PI, _TWO_PI) - _PI
            hw = torch.maximum(hw, torch.abs(dlt))
        inside = (x0 <= ox) & (ox <= x1) & (z0 <= oz) & (oz <= z1)
        hw = torch.where(inside, _PI, hw)

        rk = torch.ceil((torch.log2(torch.clamp_min(d_min, 1e-6)) - log2_d0)
                        / log2_g - 1e-3)
        rung = torch.clamp(rk, 0, K - 1).to(i64)
        wide = hw >= wide_hw
        wb = torch.ceil(hw / bin_w) + 1.0
        cls = torch.ceil(torch.log2(torch.clamp_min(wb, 1.0)) * inv_step
                         + 1e-4).to(i64)
        cls = torch.clamp(cls, 0, n_cls - 1)
        cb = torch.floor(_jmod(ac, _TWO_PI) / bin_w).to(i64)
        cb = torch.clamp(cb, 0, bins - 1)
        all_k.scatter_reduce_(0, rung, torch.where(wide, bound, ninf), "amax")
        cls_b.scatter_reduce_(0, (cls * K + rung) * bins + cb,
                              torch.where(wide, ninf, bound), "amax")

    # the fine levels' maxima from the window's tiles, 2x2 max a level
    WG, tx0, tz0 = p["WG"], p["tx0"], p["tz0"]
    ar = torch.arange(WG, dtype=i64, device=dev)
    ridx = offsets[1] + (tx0 + ar)[:, None] * dp + (tz0 + ar)[None, :]
    rows = flat[ridx.reshape(-1)]
    lv = torch.ceil(rows).reshape(WG, WG, TS, TS).permute(0, 2, 1, 3) \
        .reshape(WG * TS, WG * TS)
    for lvl in p["levels"]:
        if lvl.lf >= 0:
            fold(lv.reshape(-1), lvl)
            if lvl.lf + 1 < tl:
                lv = _strided_max2(lv)
        else:
            fold(coarse[lvl.src][lvl.i0:lvl.i0 + lvl.size,
                                 lvl.j0:lvl.j0 + lvl.size].reshape(-1), lvl)

    # per-class dilation, the all-bins floor, the cumulative max over rungs
    E = all_k[:, None].expand(K, bins)
    cb3 = cls_b.reshape(n_cls, K, bins)
    for cidx in range(n_cls):
        E = torch.maximum(E, _dilate_max(cb3[cidx], cls_w[cidx]))
    E = torch.cummax(E, dim=0).values
    E = torch.where(torch.isneginf(E), -3e38, E)
    return E.t().contiguous()


def _env_launch(fn, flat, coarse, plan, offsets: tuple, height: int,
                bins: int, K: int, stream=None):
    """Call K10's C entry ``fn`` (``voxt_sky_env``) for ``_env_plan``'s
    ``plan``, with its outputs and scratch allocated on the pack's device:
    returns (error code, E (bins, K), S (bins, ceil(K / 16)), the
    workspace: all_k (K), the class rows' used flags (n_cls * K) and the
    class plane (n_cls * K * bins), int32 holding csrc/sky_env.cu's
    encoding)."""
    dev = flat.device
    for t in (flat, *coarse):
        if t.device != dev or t.dtype != torch.float32 \
                or not t.is_contiguous():
            raise ValueError("build_skyline_env_device: the pack must be "
                             f"contiguous float32 tensors on {dev}")
    n_cls = len(plan["cls_w"])
    sw = -(-K // SUMMARY_BLOCK)
    if not 2 <= bins <= MAX_ENV_BINS or n_cls * K * bins >= 1 << 31:
        raise ValueError(f"build_skyline_env_device: bins {bins} x K {K} "
                         "outside K10's limits")
    ints, floats, srcs, start = [], [], [], 0
    for lvl in plan["levels"]:
        ints += [lvl.i0, lvl.j0, lvl.size, lvl.dim, lvl.lf, int(lvl.is_top),
                 start]
        floats += [lvl.c, lvl.a_lo, lvl.a_hi]
        srcs.append(coarse[lvl.src].data_ptr() if lvl.src >= 0 else None)
        start += lvl.size * lvl.size
    if start >= 1 << 31:
        raise ValueError("build_skyline_env_device: too many cells for "
                         "K10's 32-bit indices")
    # every constant rounded to float32 from the plain version's Python
    # float, as torch rounds a Python scalar
    consts = [plan["ox"], plan["oy"], plan["oz"], plan["bin_w"],
              plan["log2_d0"], plan["log2_g"], plan["inv_step"], _PI,
              _TWO_PI, *(float(np.float32(x)) for x in (
                  np.pi * (1.0 - 1e-6), NUM_MARGIN, 1e-6, 1e-3, 1e-4, 1e-12,
                  -3e38))]
    tl = offsets[0]
    ws = torch.empty((K + n_cls * K * (bins + 1),), dtype=torch.int32,
                     device=dev)
    ed = torch.empty((K * bins,), dtype=torch.int32, device=dev)
    E = torch.empty((bins, K), dtype=torch.float32, device=dev)
    S = torch.empty((bins, sw), dtype=torch.float32, device=dev)
    err = fn(flat.data_ptr(), offsets[1], max((1 << height) >> tl, 1), tl,
             (ctypes.c_int * len(ints))(*ints),
             (ctypes.c_float * len(floats))(*floats),
             (ctypes.c_void_p * len(srcs))(*srcs), len(srcs), start,
             (ctypes.c_int * n_cls)(*plan["cls_w"]), n_cls,
             (ctypes.c_float * len(consts))(*consts), bins, K, sw,
             ws.data_ptr(), ed.data_ptr(), E.data_ptr(), S.data_ptr(),
             stream)
    return err, E, S, ws


def build_skyline_env_device(pack, origin, bins: int = 4096, ratio: int = 16,
                             K: int = 64, d0: float = 4.0,
                             cls_step: float = 1.0):
    """The envelope for rays from ``origin`` (host (3,)), built on the
    pack's device from ``sky_levels_from_hf``'s pack: ``dict(E (bins, K)
    float32, S (K5's summary, ``env_summary(E)``), d0, g, bins, K)``, the
    JAX package's layout. K10 on a CUDA pack, ``_env_device`` on a CPU
    pack."""
    height = pack["height"]
    if pack["offsets"][0] > height:
        raise ValueError("build_skyline_env_device: world smaller than a tile")
    flat = pack["flat"]
    if flat.device.type == "cpu":
        E = _env_device(flat, pack["coarse"], origin, pack["offsets"], bins,
                        ratio, K, float(d0), height, float(cls_step))
        S = env_summary(E)
    elif flat.device.type == "cuda":
        plan = _env_plan(pack["offsets"], height, origin, bins, ratio, K,
                         float(d0), float(cls_step))
        lib = build.library()
        with torch.cuda.device(flat.device):
            err, E, S, _ = _env_launch(
                lib.voxt_sky_env, flat, pack["coarse"], plan, pack["offsets"],
                height, bins, K, torch.cuda.current_stream().cuda_stream)
        build.check(err, "build_skyline_env_device")
        profiling.count("launches.env_build")
    else:
        raise ValueError(f"build_skyline_env_device: unsupported device "
                         f"{flat.device}")
    g = (4.0 * (1 << height) / d0) ** (1.0 / (K - 1.0))
    return dict(E=E, S=S, d0=float(d0), g=float(g), bins=bins, K=K)


def env_summary(E):
    """K5's first search level for the table E (bins, K): (bins, ceil(K /
    16)) float32, entry j of a row the row's rung ``min(16 j + 15, K -
    1)``, the last of block j, so the entries below a slope count the
    blocks wholly below it."""
    K = E.shape[1]
    last = torch.clamp(torch.arange(1, -(-K // SUMMARY_BLOCK) + 1,
                                    device=E.device) * SUMMARY_BLOCK - 1,
                       max=K - 1)
    return E[:, last]


def _consts(bins: int, d0: float, g: float):
    """The lookup's float32 constants, computed once on the host for the
    kernel and the plain version alike: bin width, log2 d0, log2 g."""
    f = np.float32
    return (float(f(_TWO_PI) / f(bins)), float(np.log2(f(d0))),
            float(np.log2(f(g))))


def skyline_env_tmin(E, d, d0: float, g: float, K: int | None = None,
                     far: float = FAR, summary=None):
    """Per-ray certified-air ``t_min`` from an envelope table, in the
    parameterization of ``d`` itself (directions of any length from the
    envelope's origin).

    E: (bins, K) float32; d: (..., 3) float32 on E's device: (B, 3) rays
    in any order, or an image's, (H, W, 3) or (S, H, W, 3) (S samples of
    one H x W frame), which K5 walks in pixel tiles so that rays with one
    row of E share a warp. ``summary``: ``env_summary(E)``, made here when
    not given. Returns ``d.shape[:-1]`` float32: 0 where nothing
    certifies, ``far`` where the ray provably misses all terrain, else
    ``(d_{k*-1} - ENV_SLACK) / |d_xz|``. K5 on a CUDA tensor,
    ``skyline_env_tmin_plain`` on a CPU tensor."""
    bins, k = E.shape
    if K is not None and K != k:
        raise ValueError(f"skyline_env_tmin: K {K} != E's {k}")
    consts = _consts(bins, d0, g)
    if d.device.type == "cpu":
        return skyline_env_tmin_plain(E, d.reshape(-1, 3), *consts, far=far) \
            .reshape(d.shape[:-1])
    if d.device.type == "cuda":
        if summary is None:
            summary = env_summary(E)
        return _skyline_env_tmin_cuda(E, summary, d, *consts, far)
    raise ValueError(f"skyline_env_tmin: unsupported device {d.device}")


def env_tmin(sky_env, d):
    """``skyline_env_tmin`` of the rays ``d`` (..., 3) from an envelope
    tuple ``(E, d0, g[, K[, S]])``, S the summary (``Renderer.
    _get_sky_env`` gives all five)."""
    E, d0, g, *rest = sky_env
    return skyline_env_tmin(E, d, d0, g, *rest[:1],
                            summary=rest[1] if len(rest) > 1 else None)


def _skyline_env_tmin_cuda(E, S, d, bin_w, log2_d0, log2_g, far):
    dev = d.device
    if E.device != dev or E.dtype != torch.float32 or E.dim() != 2 \
            or not E.is_contiguous():
        raise ValueError("skyline_env_tmin: E must be a contiguous float32 "
                         f"(bins, K) tensor on {dev}")
    if S.device != dev or S.dtype != torch.float32 or S.dim() != 2 \
            or not S.is_contiguous() or S.shape != (
                E.shape[0], -(-E.shape[1] // SUMMARY_BLOCK)):
        raise ValueError("skyline_env_tmin: summary must be env_summary(E)")
    if d.dtype != torch.float32 or not d.is_contiguous():
        raise ValueError("skyline_env_tmin: d must be contiguous float32")
    shape = d.shape[:-1]
    B = d.numel() // 3
    # (S, H, W): an image's rays, leading axes folded into S; (0, 0, 0):
    # lane order
    img = (B // max(shape[-2] * shape[-1], 1), shape[-2], shape[-1]) \
        if len(shape) >= 2 else (0, 0, 0)
    if E.numel() >= 1 << 31 or S.numel() >= 1 << 31 \
            or B > build.MAX_LANES:
        raise ValueError("skyline_env_tmin: too large for 32-bit indices")
    out = torch.empty(shape, dtype=torch.float32, device=dev)
    if B == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        err = lib.voxt_sky_tmin(E.data_ptr(), S.data_ptr(), E.shape[0],
                                E.shape[1], S.shape[1], d.data_ptr(), B,
                                *img, bin_w, log2_d0, log2_g, far,
                                out.data_ptr(),
                                torch.cuda.current_stream().cuda_stream)
    build.check(err, "skyline_env_tmin")
    profiling.count("launches.sky_tmin")
    return out


def azimuth_bin(d, bin_w: float, bins: int):
    """The table row each (B, 3) direction reads: its azimuth bin, (B,)
    int64."""
    az = torch.atan2(d[:, 2], d[:, 0])
    cb = torch.floor(_jmod(az, _TWO_PI) / bin_w).to(torch.int64)
    return torch.clamp(cb, 0, bins - 1)


def lane_slopes(d, bin_w: float, bins: int):
    """Each (B, 3) direction's row of the table (``azimuth_bin``), its
    horizontal length |d_xz| and its margin-adjusted elevation slope
    ``tan_adj``, the value the row is searched for."""
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    xz = torch.hypot(dx, dz)
    big = torch.full_like(dy, 3e38)
    tan = torch.where(xz > 0.0, dy / torch.clamp_min(xz, 1e-30),
                      torch.where(dy >= 0.0, big, -big))
    tan_adj = torch.where(torch.abs(tan) >= 3e38, tan,
                          tan - (REL_MARGIN * torch.abs(tan) + ABS_MARGIN))
    return azimuth_bin(d, bin_w, bins), xz, tan_adj


def skyline_env_tmin_plain(E, d, bin_w: float, log2_d0: float, log2_g: float,
                           far: float = FAR):
    """Plain PyTorch version of K5 on (B, 3) directions, with the
    constants of ``_consts`` (``voxtracer/kernels/skyline.py:441``
    ``skyline_env_tmin_traced``): the azimuth bin, the margin-adjusted
    slope, the count of rungs below it (a full count over the gathered
    row, in chunks of ``PLAIN_CHUNK`` lanes), and t_min from it."""
    bins, K = E.shape
    out = []
    for s in range(0, d.shape[0], PLAIN_CHUNK):
        cb, xz, tan_adj = lane_slopes(d[s:s + PLAIN_CHUNK], bin_w, bins)
        ks = (E[cb] < tan_adj[:, None]).sum(dim=1)
        dk = torch.exp2(log2_d0 + (ks - 1).to(torch.float32) * log2_g)
        t = torch.clamp_min(dk - ENV_SLACK, 0.0) / torch.clamp_min(xz, 1e-30)
        out.append(torch.where(ks == 0, 0.0,
                               torch.where(ks == K, far, t)))
    if not out:
        return torch.empty((0,), dtype=torch.float32, device=d.device)
    return torch.cat(out)


# ---- the tile skyline and the host envelope: host numpy copies of
# voxtracer/kernels/skyline.py (build_sky_mips :91, build_skyline :139,
# tile_sky :281, build_skyline_env :316, rays_sky :855). Per pose they
# take milliseconds on the host and feed hf_frame_cast(sky=) a tile mask;
# the device build above does not equal build_skyline_env by bits (float32
# against float64), so the host one is kept for callers and tests that
# want the reference's table.


def build_sky_mips(heights):
    """Max pyramid over CEILED column heights, coarse enough for the
    skyline ladder. Returns a tuple of (n/2^L, n/2^L) f32 arrays,
    level 0 first (= ceil(heights)). Built once per world (host numpy;
    ~0.4 s at 8192^2) and reused by every per-pose build_skyline."""
    h = np.ceil(np.asarray(heights, np.float32))
    n = h.shape[0]
    assert h.shape == (n, n) and (n & (n - 1)) == 0
    levels = [h]
    while levels[-1].shape[0] > 1:
        m = levels[-1].shape[0] // 2
        levels.append(
            levels[-1].reshape(m, 2, m, 2).max(axis=(1, 3)))
    return tuple(levels)


def _cell_az_spread(ox, oz, x0, x1, z0, z1):
    """Center azimuth and half-spread (radians) of the xz boxes
    [x0,x1]x[z0,z1] seen from (ox, oz); boxes containing the origin
    get half-spread pi (callers treat >= pi as all-bins)."""
    cx = 0.5 * (x0 + x1) - ox
    cz = 0.5 * (z0 + z1) - oz
    ac = np.arctan2(cz, cx)
    hw = np.zeros_like(ac)
    for gx, gz in ((x0, z0), (x0, z1), (x1, z0), (x1, z1)):
        d = np.arctan2(gz - oz, gx - ox) - ac
        d = (d + np.pi) % (2.0 * np.pi) - np.pi
        hw = np.maximum(hw, np.abs(d))
    inside = (x0 <= ox) & (ox <= x1) & (z0 <= oz) & (oz <= z1)
    return ac, np.where(inside, np.pi, hw)


def _dilate_max_host(b, w):
    """Wraparound sliding max of half-width w over the last axis, by
    log-doubling shifts (max is idempotent: overlap is harmless)."""
    out = b
    s = 1
    done = 0
    while done < w:
        step = min(s, w - done)
        out = np.maximum(out,
                         np.maximum(np.roll(out, step, -1),
                                    np.roll(out, -step, -1)))
        done += step
        s = min(2 * s, w - done) if w - done > 0 else s
    return out


def build_skyline(sky_mips, origin, bins: int = 4096, ratio: int = 16,
                  dil: int = 16):
    """Conservative per-azimuth max terrain slope from ``origin``.

    sky_mips: build_sky_mips output. Returns a dict:
      ``B``     (bins,) f32 — upper bound on (h_top - o_y)/d over every
                terrain column whose azimuth falls in the bin (each
                cell padded one bin); a ray with tan strictly above
                ``B[bin(az)]`` (plus REL/ABS_MARGIN) misses all terrain.
      ``B_dil`` (bins,) f32 — ``B`` max-dilated by ``dil`` bins for
                interval consumers (tile_sky gathers one center bin
                for any interval of half-width <= dil).
      ``B_max`` f32 scalar — global max (fallback for wide intervals).
    Host f64 math throughout; ~10 ms per pose at flagship scale."""
    o = np.asarray(origin, np.float64)
    ox, oy, oz = float(o[0]), float(o[1]), float(o[2])
    n = sky_mips[0].shape[0]
    top = len(sky_mips) - 1
    bin_w = 2.0 * np.pi / bins
    # per-width-class center-bin scatter targets (class c covers cells
    # with ceil(half-spread in bins) + 1 <= 2^c); widest class = all bins
    n_cls = max(1, int(math.ceil(math.log2(max(bins, 2)))))
    cls_b = np.full((n_cls, bins), -np.inf)
    b_all = -np.inf  # bounds that cover every bin

    for L in range(top + 1):
        c = float(1 << L)
        a_lo = ratio * c if L > 0 else 0.0
        a_hi = ratio * c * 2.0
        dim = n >> L
        # window: cells whose PARENT could be nearer than a_hi; the top
        # level has no parent gate, so it must never clip (soundness
        # for origins far outside the grid)
        ext = int(math.ceil(a_hi / c)) + 4
        if L == top:
            ext = max(ext, dim + abs(int(ox / c)) + abs(int(oz / c)))
        ci0 = max(int(ox / c) - ext, 0)
        ci1 = min(int(ox / c) + ext + 1, dim)
        cj0 = max(int(oz / c) - ext, 0)
        cj1 = min(int(oz / c) + ext + 1, dim)
        if ci0 >= ci1 or cj0 >= cj1:
            continue
        ii = np.arange(ci0, ci1, dtype=np.float64)
        jj = np.arange(cj0, cj1, dtype=np.float64)
        x0 = (ii * c)[:, None] + np.zeros((1, jj.size))
        z0 = (jj * c)[None, :] + np.zeros((ii.size, 1))
        x1, z1 = x0 + c, z0 + c

        def box_d(bx0, bx1, bz0, bz1):
            dx = np.maximum(np.maximum(bx0 - ox, ox - bx1), 0.0)
            dz = np.maximum(np.maximum(bz0 - oz, oz - bz1), 0.0)
            dmin = np.hypot(dx, dz)
            fx = np.maximum(np.abs(bx0 - ox), np.abs(bx1 - ox))
            fz = np.maximum(np.abs(bz0 - oz), np.abs(bz1 - oz))
            return dmin, np.hypot(fx, fz)

        d_min, d_max = box_d(x0, x1, z0, z1)
        # ladder membership: this level serves the annulus, the parent
        # is too near for the next (gapless by chain maximality)
        if L < top:
            pc = 2.0 * c
            px0 = np.floor(x0 / pc) * pc
            pz0 = np.floor(z0 / pc) * pc
            pd_min, _ = box_d(px0, px0 + pc, pz0, pz0 + pc)
            sel = (d_min >= a_lo) & (pd_min < a_hi)
        else:
            sel = d_min >= a_lo
        if not np.any(sel):
            continue

        hm = sky_mips[L][ci0:ci1, cj0:cj1].astype(np.float64)
        num = hm + NUM_MARGIN - oy
        # positive numerators divide by the TRUE d_min: a touching or
        # origin-containing cell above the origin must block its bins
        # outright (num/0 -> +inf; inf never certifies — the tan test
        # is strict). Negative numerators divide by d_max (>= diag/2).
        with np.errstate(divide="ignore", invalid="ignore"):
            bound = np.where(
                num >= 0.0,
                num / d_min,
                num / np.maximum(d_max, 1e-12),
            )
        bound = np.where(np.isnan(bound), np.inf, bound)
        ac, hw = _cell_az_spread(ox, oz, x0, x1, z0, z1)
        bound, ac, hw = bound[sel], ac[sel], hw[sel]

        wide = hw >= np.pi * (1.0 - 1e-12)
        if np.any(wide):
            b_all = max(b_all, float(bound[wide].max()))
        rest = ~wide
        if np.any(rest):
            wb = np.ceil(hw[rest] / bin_w).astype(np.int64) + 1
            cls = np.ceil(np.log2(np.maximum(wb, 1))).astype(np.int64)
            cls = np.minimum(cls, n_cls - 1)
            cb = np.floor((ac[rest] % (2.0 * np.pi)) / bin_w)
            cb = cb.astype(np.int64) % bins
            np.maximum.at(cls_b, (cls, cb), bound[rest])

    B = np.full((bins,), b_all)
    for cidx in range(n_cls):
        if np.all(np.isneginf(cls_b[cidx])):
            continue
        B = np.maximum(B, _dilate_max_host(cls_b[cidx],
                                           min(1 << cidx, bins // 2)))
    # bins no cell subtends (off-grid azimuths) certify every ray; +inf
    # bins (terrain touching/above the origin) certify none
    B = np.where(np.isneginf(B), np.float64(-3e38), B)
    return dict(
        B=B.astype(np.float32),
        B_dil=_dilate_max_host(B, dil).astype(np.float32),
        B_max=np.float32(B.max()),
        bins=bins,
        dil=dil,
    )


def _dir_boxes(cam_basis, width_px: int, height_px: int, tile: int):
    """Per-tile component boxes (lo, hi) of the UNNORMALIZED jitter-
    padded directions, host f64 (the f32 device dirs are 1-ulp
    roundings of points inside these boxes; REL_MARGIN covers it)."""
    W, H = width_px, height_px
    tx = -(-W // tile)
    ty = -(-H // tile)
    x0 = (np.arange(tx) * tile).astype(np.float64)
    x1 = np.minimum(x0 + tile - 1, W - 1)
    y0 = (np.arange(ty) * tile).astype(np.float64)
    y1 = np.minimum(y0 + tile - 1, H - 1)
    pad = 0.5 + 1e-4
    lx0 = (2.0 * (x0 - pad + 0.5) - W) / H
    lx1 = (2.0 * (x1 + pad + 0.5) - W) / H
    ly0 = (2.0 * (y0 - pad + 0.5) - H) / H
    ly1 = (2.0 * (y1 + pad + 0.5) - H) / H
    cx = np.stack([np.broadcast_to(a[None, :], (ty, tx))
                   for a in (lx0, lx1, lx0, lx1)], -1)
    cy = np.stack([np.broadcast_to(a[:, None], (ty, tx))
                   for a in (ly0, ly0, ly1, ly1)], -1)
    d_cam = np.stack([cx, -cy, np.ones_like(cx)], -1)
    basis = np.asarray(cam_basis, np.float64)
    dirs = d_cam.reshape(-1, 4, 3) @ basis.T
    return dirs.min(axis=1), dirs.max(axis=1)


def tile_sky(sky, cam_basis, width_px: int, height_px: int,
             tile: int = 8):
    """(T,) bool host mask: tiles whose EVERY ray (any sub-pixel
    jitter) provably misses all terrain. Row-major 8x8 tile order
    matching conemarch.frame_tile_bundles / the frame casts."""
    lo, hi = _dir_boxes(cam_basis, width_px, height_px, tile)
    # bundle tan lower bound: min dy over the box, against the worst
    # |dxz| for the numerator's sign
    dy_lo = lo[:, 1]
    xz_hi = np.hypot(np.maximum(np.abs(lo[:, 0]), np.abs(hi[:, 0])),
                     np.maximum(np.abs(lo[:, 2]), np.abs(hi[:, 2])))
    nx = np.maximum(np.maximum(lo[:, 0], -hi[:, 0]), 0.0)
    nz = np.maximum(np.maximum(lo[:, 2], -hi[:, 2]), 0.0)
    xz_lo = np.hypot(nx, nz)
    with np.errstate(divide="ignore", invalid="ignore"):
        tan_min = np.where(
            dy_lo >= 0.0,
            dy_lo / np.maximum(xz_hi, 1e-300),
            dy_lo / np.maximum(xz_lo, 1e-300),
        )
    tan_adj = tan_min - (REL_MARGIN * np.abs(tan_min) + ABS_MARGIN)

    bins = int(sky["bins"])
    bin_w = 2.0 * np.pi / bins
    ac, hw = _cell_az_spread(
        0.0, 0.0, lo[:, 0], hi[:, 0], lo[:, 2], hi[:, 2])
    wb = np.ceil(hw / bin_w).astype(np.int64) + 2
    cb = (np.floor((ac % (2.0 * np.pi)) / bin_w).astype(np.int64)
          % bins)
    B = np.where((hw < np.pi) & (wb <= int(sky["dil"])),
                 sky["B_dil"][cb].astype(np.float64),
                 np.float64(sky["B_max"]))
    return tan_adj > B


def build_skyline_env(sky_mips, origin, bins: int = 4096,
                      ratio: int = 16, K: int = 64, d0: float = 4.0):
    """Per-azimuth, per-DISTANCE horizon envelope — the per-RAY
    generalization of ``build_skyline`` (round 4).

    The max-slope table certifies only all-terrain misses; the frame's
    measured cost is the near-horizon band — rays (sky AND ground)
    whose slope sits just above the terrain ahead of them, which graze
    coarse mip maxima for thousands of voxels (docs/PERF_TPU.md round
    3, TPU v5e: a perfect per-pixel t_min floors the flagship frame at
    594 of 1031 ms; killing fully-sky TILES was neutral because the expensive
    lanes live in mixed horizon tiles). This structure gives every ray
    its own certified resume: ``E[az, k]`` bounds the max slope
    ``(h_top + NUM_MARGIN - o_y) / d`` over every terrain column whose
    azimuth is in bin ``az`` (padded as build_skyline) AND whose
    horizontal distance is <= ``d_k`` of a log ladder
    ``d_k = d0 * g^k`` (g set so d_{K-1} = 4n covers any in-grid
    distance). ``E`` is monotone in k (cummax), so a ray with adjusted
    slope ``tan`` is provably in air for horizontal distance
    ``d_{k*-1}`` where ``k* = #{k : E[az,k] < tan}`` — and ``k* == K``
    is the all-terrain miss (the old skyline test as the last rung).

    Soundness inherits build_skyline's cell bounds (d_min for positive
    numerators covers every point of the cell at ANY distance, azimuth
    scatter pads >= 1 bin each side, NUM_MARGIN over cell tops);
    the rung index uses an exact f64 searchsorted (smallest k with
    d_k >= cell d_min), so every cell reachable within d_k is folded
    into E[.., k]. Device consumers reconstruct d_{k*-1} with f32
    exp2 (relative error ~1e-7, buried by ENV_SLACK).

    Returns dict(E (bins, K) f32, d0, g, bins, K). Host f64; same
    per-pose cost class as build_skyline (one cell sweep). Test-only in
    the port: the Renderer builds its envelope on the card
    (``build_skyline_env_device``).
    """
    o = np.asarray(origin, np.float64)
    ox, oy, oz = float(o[0]), float(o[1]), float(o[2])
    n = sky_mips[0].shape[0]
    top = len(sky_mips) - 1
    bin_w = 2.0 * np.pi / bins
    ladder = d0 * ((4.0 * n / d0) ** (np.arange(K) / (K - 1.0)))
    n_cls = max(1, int(math.ceil(math.log2(max(bins, 2)))))
    cls_b = np.full((n_cls, K, bins), -np.inf)
    all_k = np.full((K,), -np.inf)  # bounds covering every bin

    for L in range(top + 1):
        c = float(1 << L)
        a_lo = ratio * c if L > 0 else 0.0
        a_hi = ratio * c * 2.0
        dim = n >> L
        ext = int(math.ceil(a_hi / c)) + 4
        if L == top:
            ext = max(ext, dim + abs(int(ox / c)) + abs(int(oz / c)))
        ci0 = max(int(ox / c) - ext, 0)
        ci1 = min(int(ox / c) + ext + 1, dim)
        cj0 = max(int(oz / c) - ext, 0)
        cj1 = min(int(oz / c) + ext + 1, dim)
        if ci0 >= ci1 or cj0 >= cj1:
            continue
        ii = np.arange(ci0, ci1, dtype=np.float64)
        jj = np.arange(cj0, cj1, dtype=np.float64)
        x0 = (ii * c)[:, None] + np.zeros((1, jj.size))
        z0 = (jj * c)[None, :] + np.zeros((ii.size, 1))
        x1, z1 = x0 + c, z0 + c

        def box_d(bx0, bx1, bz0, bz1):
            dx = np.maximum(np.maximum(bx0 - ox, ox - bx1), 0.0)
            dz = np.maximum(np.maximum(bz0 - oz, oz - bz1), 0.0)
            dmin = np.hypot(dx, dz)
            fx = np.maximum(np.abs(bx0 - ox), np.abs(bx1 - ox))
            fz = np.maximum(np.abs(bz0 - oz), np.abs(bz1 - oz))
            return dmin, np.hypot(fx, fz)

        d_min, d_max = box_d(x0, x1, z0, z1)
        if L < top:
            pc = 2.0 * c
            px0 = np.floor(x0 / pc) * pc
            pz0 = np.floor(z0 / pc) * pc
            pd_min, _ = box_d(px0, px0 + pc, pz0, pz0 + pc)
            sel = (d_min >= a_lo) & (pd_min < a_hi)
        else:
            sel = d_min >= a_lo
        if not np.any(sel):
            continue

        hm = sky_mips[L][ci0:ci1, cj0:cj1].astype(np.float64)
        num = hm + NUM_MARGIN - oy
        with np.errstate(divide="ignore", invalid="ignore"):
            bound = np.where(
                num >= 0.0,
                num / d_min,
                num / np.maximum(d_max, 1e-12),
            )
        bound = np.where(np.isnan(bound), np.inf, bound)
        ac, hw = _cell_az_spread(ox, oz, x0, x1, z0, z1)
        bound, ac, hw = bound[sel], ac[sel], hw[sel]
        # smallest rung whose ladder distance reaches the cell (exact
        # f64 compare — no log rounding); beyond-ladder cells clip to
        # the last rung, which only over-includes (conservative)
        rung = np.minimum(
            np.searchsorted(ladder, d_min[sel], side="left"), K - 1)

        wide = hw >= np.pi * (1.0 - 1e-12)
        if np.any(wide):
            np.maximum.at(all_k, rung[wide], bound[wide])
        rest = ~wide
        if np.any(rest):
            wb = np.ceil(hw[rest] / bin_w).astype(np.int64) + 1
            cls = np.ceil(np.log2(np.maximum(wb, 1))).astype(np.int64)
            cls = np.minimum(cls, n_cls - 1)
            cb = np.floor((ac[rest] % (2.0 * np.pi)) / bin_w)
            cb = cb.astype(np.int64) % bins
            np.maximum.at(cls_b, (cls, rung[rest], cb), bound[rest])

    E = np.broadcast_to(all_k[:, None], (K, bins)).copy()
    for cidx in range(n_cls):
        if np.all(np.isneginf(cls_b[cidx])):
            continue
        E = np.maximum(E, _dilate_max_host(cls_b[cidx],
                                           min(1 << cidx, bins // 2)))
    E = np.maximum.accumulate(E, axis=0)  # monotone in distance
    E = np.where(np.isneginf(E), np.float64(-3e38), E)
    g = (4.0 * n / d0) ** (1.0 / (K - 1.0))
    return dict(E=np.ascontiguousarray(E.T.astype(np.float32)),
                d0=float(d0), g=float(g), bins=bins, K=K)


def rays_sky(sky, dirs):
    """(B,) bool host mask for individual NORMALIZED (or any-scale)
    directions from the skyline's origin: ray provably misses all
    terrain. Exact-azimuth variant of tile_sky (tests; per-ray
    consumers pay one B gather per lane on device instead). Test-only in
    the port: nothing in ``voxtracer_torch`` calls it."""
    d = np.asarray(dirs, np.float64).reshape(-1, 3)
    bins = int(sky["bins"])
    az = np.arctan2(d[:, 2], d[:, 0]) % (2.0 * np.pi)
    cb = np.floor(az / (2.0 * np.pi / bins)).astype(np.int64) % bins
    xz = np.hypot(d[:, 0], d[:, 2])
    with np.errstate(divide="ignore", invalid="ignore"):
        tan = np.where(xz > 0.0, d[:, 1] / np.maximum(xz, 1e-300),
                       np.where(d[:, 1] >= 0, np.inf, -np.inf))
        tan_adj = np.where(
            np.isinf(tan), tan,
            tan - (REL_MARGIN * np.abs(tan) + ABS_MARGIN))
    return tan_adj > sky["B"][cb].astype(np.float64)
