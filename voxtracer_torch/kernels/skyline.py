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
All in float32 with the reference's margins: ``NUM_MARGIN`` over every
cell top, ``REL_MARGIN``/``ABS_MARGIN`` on the ray's slope, one bin of
azimuth padding, the rung rounded down by 1e-3 (a boundary cell lands a
rung early, never late), the class rounded up by 1e-4, and ``ENV_SLACK``
voxels shaved off every resume. The table need not equal the JAX
package's bit for bit: any sound table resumes a walk to the same result
as the walk from the start (``heightfield.hf_raycast``'s t_min contract).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from voxtracer_torch.kernels import build

NUM_MARGIN = 0.5    # voxels added over every cell max (walk f32 wobble)
REL_MARGIN = 1e-5   # relative tan slack (f32 direction/test rounding)
ABS_MARGIN = 1e-6   # absolute tan slack
ENV_SLACK = 2.0     # voxels shaved off per-ray envelope resumes (f32)
FAR = 3e38          # t_min of a ray that provably misses all terrain
PATCH_COLS = 16     # patch_sky_levels rebuilds above this many columns
PLAIN_CHUNK = 1 << 20  # lanes a chunk of the plain lookup gathers rows for
SUMMARY_BLOCK = 16  # rungs of E that one entry of the summary stands for

launches = 0  # kernel launches since the last reset (chip_smoke reads it)

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


def _env_device(flat, coarse, origin, offsets: tuple, bins: int, ratio: int,
                K: int, d0: float, height: int, cls_step: float):
    """The envelope table (bins, K) for one origin (``voxtracer/kernels/
    skyline.py:648`` ``_env_device``, op for op in float32)."""
    dev = flat.device
    f32, i64 = torch.float32, torch.int64
    o = np.asarray(origin, np.float32)
    ox, oy, oz = float(o[0]), float(o[1]), float(o[2])
    tl = offsets[0]
    TS = 1 << tl
    n = 1 << height
    dp = max(n >> tl, 1)
    top = height
    bin_w = float(np.float32(2.0 * np.pi / bins))
    log2_g = float(np.float32(math.log2((4.0 * n / d0) ** (1.0 / (K - 1.0)))))
    log2_d0 = float(np.float32(math.log2(d0)))
    # width class c dilates by ceil(2^(c * cls_step)) bins
    n_cls = max(1, int(math.ceil(math.log2(max(bins, 2)) / cls_step)))
    cls_w = [min(int(math.ceil(2.0 ** (c * cls_step))), bins // 2)
             for c in range(n_cls)]
    inv_step = float(np.float32(1.0 / cls_step))
    cls_b = torch.full((n_cls * K * bins,), -math.inf, dtype=f32, device=dev)
    all_k = torch.full((K,), -math.inf, dtype=f32, device=dev)
    ninf = torch.tensor(-math.inf, dtype=f32, device=dev)

    ext = 2 * ratio + 4  # ceil(a_hi / c) + 4 at every level
    WSZ = 2 * ext + 1

    def box_d(bx0, bx1, bz0, bz1):
        dx = torch.clamp_min(torch.maximum(bx0 - ox, ox - bx1), 0.0)
        dz = torch.clamp_min(torch.maximum(bz0 - oz, oz - bz1), 0.0)
        fx = torch.maximum(torch.abs(bx0 - ox), torch.abs(bx1 - ox))
        fz = torch.maximum(torch.abs(bz0 - oz), torch.abs(bz1 - oz))
        return torch.hypot(dx, dz), torch.hypot(fx, fz)

    def fold(hm, ii, jj, c: float, is_top: bool):
        """Scatter one level's cells (maxima hm, integer coords ii, jj in
        cells of c) into the accumulators."""
        x0 = ii.to(f32) * c
        z0 = jj.to(f32) * c
        x1, z1 = x0 + c, z0 + c
        d_min, d_max = box_d(x0, x1, z0, z1)
        a_lo = ratio * c if c > 1.0 else 0.0
        a_hi = ratio * c * 2.0
        if is_top:
            sel = d_min >= a_lo
        else:
            pc = 2.0 * c
            px0 = torch.floor(x0 / pc) * pc
            pz0 = torch.floor(z0 / pc) * pc
            pd_min, _ = box_d(px0, px0 + pc, pz0, pz0 + pc)
            sel = (d_min >= a_lo) & (pd_min < a_hi)
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
        wide = hw >= float(np.float32(np.pi * (1.0 - 1e-6)))
        wb = torch.ceil(hw / bin_w) + 1.0
        cls = torch.ceil(torch.log2(torch.clamp_min(wb, 1.0)) * inv_step
                         + 1e-4).to(i64)
        cls = torch.clamp(cls, 0, n_cls - 1)
        cb = torch.floor(_jmod(ac, _TWO_PI) / bin_w).to(i64)
        cb = torch.clamp(cb, 0, bins - 1)
        all_k.scatter_reduce_(0, rung, torch.where(wide, bound, ninf), "amax")
        cls_b.scatter_reduce_(0, (cls * K + rung) * bins + cb,
                              torch.where(wide, ninf, bound), "amax")

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
    ar = torch.arange(WG, dtype=i64, device=dev)
    ridx = offsets[1] + (tx0 + ar)[:, None] * dp + (tz0 + ar)[None, :]
    rows = flat[ridx.reshape(-1)]
    lv = torch.ceil(rows).reshape(WG, WG, TS, TS).permute(0, 2, 1, 3) \
        .reshape(WG * TS, WG * TS)
    for lf in range(min(tl, top)):
        dim = (WG * TS) >> lf
        ci = ((tx0 * TS) >> lf) + torch.arange(dim, dtype=i64, device=dev)
        cj = ((tz0 * TS) >> lf) + torch.arange(dim, dtype=i64, device=dev)
        iig, jjg = torch.meshgrid(ci, cj, indexing="ij")
        fold(lv.reshape(-1), iig.reshape(-1), jjg.reshape(-1),
             float(1 << lf), is_top=False)
        if lf + 1 < tl:
            lv = _strided_max2(lv)

    # coarse levels tl..top from the pyramid, windowed like the host build
    for idx, hm_l in enumerate(coarse):
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
        hm = hm_l[ci0:ci0 + size, cj0:cj0 + size]
        iig, jjg = torch.meshgrid(
            ci0 + torch.arange(size, dtype=i64, device=dev),
            cj0 + torch.arange(size, dtype=i64, device=dev), indexing="ij")
        fold(hm.reshape(-1), iig.reshape(-1), jjg.reshape(-1), c,
             is_top=L == top)

    # per-class dilation, the all-bins floor, the cumulative max over rungs
    E = all_k[:, None].expand(K, bins)
    cb3 = cls_b.reshape(n_cls, K, bins)
    for cidx in range(n_cls):
        E = torch.maximum(E, _dilate_max(cb3[cidx], cls_w[cidx]))
    E = torch.cummax(E, dim=0).values
    E = torch.where(torch.isneginf(E), -3e38, E)
    return E.t().contiguous()


def build_skyline_env_device(pack, origin, bins: int = 4096, ratio: int = 16,
                             K: int = 64, d0: float = 4.0,
                             cls_step: float = 1.0):
    """The envelope for rays from ``origin`` (host (3,)), built on the
    pack's device from ``sky_levels_from_hf``'s pack: ``dict(E (bins, K)
    float32, d0, g, bins, K)``, the JAX package's layout."""
    height = pack["height"]
    if pack["offsets"][0] > height:
        raise ValueError("build_skyline_env_device: world smaller than a tile")
    E = _env_device(pack["flat"], pack["coarse"], origin, pack["offsets"],
                    bins, ratio, K, float(d0), height, float(cls_step))
    g = (4.0 * (1 << height) / d0) ** (1.0 / (K - 1.0))
    return dict(E=E, S=env_summary(E), d0=float(d0), g=float(g), bins=bins,
                K=K)


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
    global launches
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
    launches += 1
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
