"""Conservative sun-visibility bounds for NEE on heightfield terrain: the
port of ``voxtracer/kernels/sunshadow.py``. ``build`` is its host numpy
copy (no kernel: it runs once per world and sun); ``sun_clear`` is the
per-lane query in PyTorch. What follows is the reference's own account.

The integrator's NEE shadow rays (integrator.py nee_occluded) pay a
full heightfield walk per lane, and the expensive lanes are the LIT
ones: proving "no hit" walks coarse tiles across the world (~7 row
gathers/lane, docs/PERF_TPU.md) while blocked lanes retire early. For an
UNEDITED heightfield world and the one sun the reference ever samples
(a ~0.535-degree cone around a fixed direction, raytrace.wgsl:237-252),
sun visibility is a function of position only — so this module
precomputes, per (world, sun), height threshold maps T such that

    origin.y > T[origin column]  =>  hf_raycast reports NO hit from
    this origin for ANY direction in the sun cone.

Lanes above the threshold skip the walk entirely (two row gathers);
the rest take the exact cast, so the combined occlusion boolean is
BIT-IDENTICAL to casting every lane (tests/test_sunshadow.py fuzzes
this equality against hf_raycast itself, including f32-perturbed
origins a path tracer actually produces).

Soundness chain (every step errs toward "not provably lit"):

* cone bounds: every cone member has elevation in [elev-cone,
  elev+cone], so its rise per unit of horizontal distance m is
  >= q_min = tan(elev - cone) (positive above the gate). Its
  horizontal unit direction u deviates from the central bearing b by
  angle phi with sin(phi) <= dev = cone/sxz_min (the lateral
  component of d-s against a horizontal normal is <= 2 sin(cone/2),
  and |d_xz| >= sxz_min = sxz cos(cone) - sy sin(cone)), so each
  axis rate u_ax lies in [b_ax - dev_ax, b_ax + dev_ax] with
  dev_ax = dev + 0.7 dev^2 (covers the 1-cos(phi) along-shrink);
* own column: with d_y > 0 (gate) the exact walk can only hit the
  origin's own column by starting INSIDE it (f32 hit points land up
  to an ulp inside faces) and crossing up into a still-solid cell,
  which requires ceil(y) < h_own, i.e. y <= h_own - 1. The own term
  of t_near is therefore h_own - 1: claimed-lit origins satisfy
  y > h_own - 1 + margin, where every upward crossing exits to air
  and every lateral crossing enters a NEIGHBOR column (covered
  below). No facing/normal assumption is needed — the bound holds
  for surface hits, side-face hits, and fog-scatter origins alike;
* near field (m < L_NEAR): per column offset (a, b) and origin
  sub-column phase, the EXACT smallest reachable distance m_min —
  offset a is reachable at m iff [f0 + m r_lo, f1 + m r_hi) meets
  [a, a+1) for the phase's fraction range [f0, f1) — charges that
  offset's height with m_min q_min. Continuous (no segment
  quantization), directional (sun-opposite offsets are unreachable),
  and phase-resolved (subres sub-columns per axis: the voxel
  staircase lights the sun-side fraction of each top face, which a
  whole-column map cannot see). The (0,0) offset is excluded from
  every window (own term above);
* far field (m >= 0.9 L_NEAR): per-pool-cell map over a max-mip
  pyramid, geometric segments [m_k, 1.5 m_k]. Each segment picks the
  mip level with cells ~ETA m_k wide and fetches the cell block
  covering the segment's per-axis offset interval. Because the fetch
  index is affine in the origin cell index with unit slope, every
  fetch is a STATIC shift of the s-upsampled mip (no gathers), and
  the cover/offset algebra is exact: fetched cells c(dx) =
  (i+f0)//s + dx with f0 = floor((pool/2 + lo)/pool) start at or
  below center+lo and D = ceil((hi-lo)/cs) extra cells reach past
  center+hi. Each fetch is charged its OWN distance lower bound
  max(m_k, d_min(dx, dz)) q_min, where d_min comes from per-axis
  interval arithmetic over the fetched cell span, the origin cell,
  and the column footprint — so large cells far from the origin are
  not penalized with the segment-start distance;
* heights are integers stored exactly in f32, build arithmetic is
  f64, and all bounds subtract only nonnegative rises, so the +0.25
  margin on the thresholds buries every f32 rounding (the walk's
  crossing t's are exact integer-times-power-of-two products —
  heightfield.py module doc — so no cast-side wobble needs covering).

The map degrades (never breaks) as the sun drops: q_min -> 0 makes
far hills clear the threshold and more lanes fall back to the cast.
Below ELEV_GATE of elevation or SXZ_MIN_GATE of horizontal component
(near-vertical sun: dev = cone/sxz_min blows up), build() returns
None and the integrator casts everything.

Build is host-side numpy per (world, sun): the headless day cycle
steps the sun once per 1000-sample frame (main.rs:112-145), so the
build amortizes to nothing; the maps upload once and the per-lane
query (sun_clear) joins the fused PT program.
"""

from __future__ import annotations

import math

import numpy as np

import torch

from voxtracer_torch.core.sampling import SUN_ANGULAR_RADIUS

L_NEAR = 8  # near-field horizontal reach (columns)
FAR_GROWTH = 1.5  # geometric far-segment growth
ETA_SMALL = 0.05  # far cell size / segment distance (n <= 1024)
ETA_BIG = 0.08  # coarser at flagship scale (build-cost bound)
ELEV_GATE = SUN_ANGULAR_RADIUS + 0.02  # min elevation the algebra allows
SXZ_MIN_GATE = 0.05  # min horizontal component (near-vertical sun gate)
MARGIN = 0.25  # conservative slack added to every threshold



def _max_shift_into(dst: np.ndarray, src: np.ndarray, di: int, dj: int,
                    sub: float) -> None:
    """dst[i, j] = max(dst[i, j], src[i+di, j+dj] - sub) over the
    in-bounds overlap, in place — no temporaries. Out-of-bounds source
    cells have no terrain: their contribution (0 - sub <= 0) can never
    raise a threshold, so skipping them is exact."""
    n0, n1 = src.shape
    si = slice(max(di, 0), max(n0 + min(di, 0), 0))
    ti = slice(max(-di, 0), max(n0 + min(-di, 0), 0))
    sj = slice(max(dj, 0), max(n1 + min(dj, 0), 0))
    tj = slice(max(-dj, 0), max(n1 + min(-dj, 0), 0))
    np.maximum(dst[ti, tj], src[si, sj] - np.float32(sub),
               out=dst[ti, tj])


def _max_mips(h: np.ndarray, pool: int):
    """Pooled max pyramid: level 0 = pool-block max, then 2x maxes."""
    n = h.shape[0]
    k = n // pool
    m0 = h.reshape(k, pool, k, pool).max(axis=(1, 3)).astype(np.float32)
    mips = [m0]
    while mips[-1].shape[0] > 1:
        c = mips[-1]
        d = c.shape[0] // 2
        if d * 2 != c.shape[0]:
            break
        mips.append(
            np.maximum.reduce([c[0::2, 0::2], c[0::2, 1::2],
                               c[1::2, 0::2], c[1::2, 1::2]])
        )
    return mips


def _rate_interval(b_ax: float, dev: float):
    """Per-axis horizontal rate interval [b_ax - dev_ax, b_ax + dev_ax]
    of any cone member's unit horizontal direction (module doc)."""
    dev_ax = dev * (1.0 + 0.7 * dev)
    return b_ax - dev_ax, b_ax + dev_ax


def _offset_interval(m0: float, m1: float, r_lo: float, r_hi: float):
    """Interval of m * u_ax over m in [m0, m1] (m0 >= 0), u_ax in
    [r_lo, r_hi]."""
    lo = m0 * r_lo if r_lo >= 0.0 else m1 * r_lo
    hi = m1 * r_hi if r_hi >= 0.0 else m0 * r_hi
    return lo, hi


def build(heights, sun, pool: int | None = None,
          subres: int | None = None):
    """Threshold maps for the sun direction, or None when gated.

    heights: (n, n) integer heightmap indexed [x, z]
    (world/worldgen); sun: unit direction (3,). Returns
    dict(t_near (n, n) f32, t_far (k, k) f32, pool) — query: lit iff
    y > t_near[x, z] and y > t_far[x//pool, z//pool] (sun_clear wires
    it for device lanes; t_near is indexed by sub-column
    floor(x*subres), maps["subres"] carries the factor). pool defaults
    world-scaled: small worlds take 2 (the per-cell origin slop costs
    pool/sqrt(2) * q of threshold, material against small-world
    relief). subres (power of two) defaults by world size: 4 up to
    1024 (64 MB map), 2 at 2048, 1 beyond.
    """
    if pool is None:
        pool = 2 if np.asarray(heights).shape[0] <= 1024 else 4
    eta = ETA_SMALL if np.asarray(heights).shape[0] <= 1024 else ETA_BIG
    sun = np.asarray(sun, np.float64)
    sun = sun / np.linalg.norm(sun)
    sy = float(sun[1])
    sxz = float(math.hypot(sun[0], sun[2]))
    cone = float(SUN_ANGULAR_RADIUS)
    elev = math.atan2(sy, sxz)
    sxz_min = sxz * math.cos(cone) - sy * math.sin(cone)
    if elev <= ELEV_GATE or sxz_min < SXZ_MIN_GATE:
        return None
    q_min = math.tan(elev - cone)  # min rise per horizontal unit
    dev = cone / sxz_min  # max lateral drift per horizontal unit

    h = np.asarray(heights, np.float32)
    n = h.shape[0]
    assert h.shape == (n, n) and n % pool == 0
    bx, bz = sun[0] / sxz, sun[2] / sxz  # signed central bearing
    rx_lo, rx_hi = _rate_interval(bx, dev)
    rz_lo, rz_hi = _rate_interval(bz, dev)

    # ---- near field: exact per-offset, per-phase reachability ---------
    # Column offset a (per axis) is reachable at horizontal distance m
    # from an origin fraction f in [f0, f1) iff [f0 + m r_lo,
    # f1 + m r_hi) meets [a, a+1); the smallest such m is m_min — the
    # exact continuous rise charge (no segment quantization), and
    # offsets the rates can never reach (sun-opposite side) drop out.
    # The map is built per SUB-COLUMN phase (subres a power of two, so
    # floor(x * subres) is f32-exact in the device query): finer
    # origin fractions mean larger m_min for the dominant adjacent
    # blockers — on unit-rough terrain this is worth ~2-4x in lit
    # coverage (the voxel staircase lights the sun-side fraction of
    # each top face).
    def m_min_ax(a: int, f0: float, f1: float,
                 r_lo: float, r_hi: float) -> float:
        if a == 0:
            return 0.0
        if a >= 1:
            return (a - f1) / r_hi if r_hi > 0.0 else math.inf
        return (a + 1.0 - f0) / r_lo if r_lo < 0.0 else math.inf

    sr = subres if subres is not None else (
        4 if n <= 1024 else 2 if n <= 2048 else 1)
    t_near = np.repeat(np.repeat((h - 1.0).astype(np.float32), sr, 0),
                       sr, 1)  # own term, every phase
    a_lo = min(0, int(math.floor(L_NEAR * rx_lo))) - 1
    a_hi = max(0, int(math.ceil(L_NEAR * rx_hi))) + 1
    b_lo = min(0, int(math.floor(L_NEAR * rz_lo))) - 1
    b_hi = max(0, int(math.ceil(L_NEAR * rz_hi))) + 1
    for a in range(a_lo, a_hi + 1):
        for b in range(b_lo, b_hi + 1):
            if a == 0 and b == 0:
                continue  # own column: the h-1 term (module doc)
            for px in range(sr):
                mx = m_min_ax(a, px / sr, (px + 1) / sr, rx_lo, rx_hi)
                if mx >= L_NEAR:
                    continue
                for pz in range(sr):
                    m_min = max(mx, m_min_ax(b, pz / sr, (pz + 1) / sr,
                                             rz_lo, rz_hi))
                    if m_min >= L_NEAR:
                        continue  # far field covers m >= 0.9 L_NEAR
                    _max_shift_into(t_near[px::sr, pz::sr], h, a, b,
                                    m_min * q_min)

    # ---- far field: per-pool-cell charged mip fetches ----------------
    mips = _max_mips(h, pool)
    k = n // pool
    t_far = np.full((k, k), -np.inf, np.float32)
    m_lo = 0.9 * L_NEAR
    world_reach = n * 1.45  # beyond the long diagonal: outside = 0
    while m_lo <= world_reach:
        m_hi = m_lo * FAR_GROWTH
        lvl = 0
        while (pool * (1 << (lvl + 1)) <= eta * m_lo
               and lvl + 1 < len(mips)):
            lvl += 1
        s = 1 << lvl
        cs = pool * s
        a2 = mips[lvl]
        if s > 1:
            a2 = np.repeat(np.repeat(a2, s, 0), s, 1)
        # per-axis offset intervals of blocker columns (origin cell
        # slop +- pool/2, column footprint +- 0.5)
        xlo, xhi = _offset_interval(m_lo, m_hi, rx_lo, rx_hi)
        zlo, zhi = _offset_interval(m_lo, m_hi, rz_lo, rz_hi)
        xlo -= 0.5 * pool + 0.5
        xhi += 0.5 * pool + 0.5
        zlo -= 0.5 * pool + 0.5
        zhi += 0.5 * pool + 0.5
        f0x = int(math.floor((0.5 * pool + xlo) / pool))
        f0z = int(math.floor((0.5 * pool + zlo) / pool))
        dx_n = int(math.ceil((xhi - xlo) / cs)) + 1
        dz_n = int(math.ceil((zhi - zlo) / cs)) + 1
        # swath bands for the skip test: along/lateral coordinates of
        # any blocker offset this segment can reach (the bounding box
        # above is fat on diagonal bearings — off-swath corner fetches
        # would flatten the map with irrelevant tall terrain)
        fslop = (0.5 * pool + 0.5) * 1.4143  # origin cell + footprint
        dev_ax = dev * (1.0 + 0.7 * dev)
        s_blo = m_lo * (1.0 - dev * dev) - fslop
        s_bhi = m_hi + fslop
        l_bhi = m_hi * dev_ax + fslop
        for dx in range(dx_n):
            # fetched-cell x-span relative to the origin-cell center,
            # widened by origin slop and footprint (for d_min)
            sp_lo = (f0x + (dx - 1) * s + 1) * pool - pool - 0.5
            sp_hi = (f0x + dx * s) * pool + cs + 0.5
            mnx = 0.0 if sp_lo <= 0.0 <= sp_hi else min(abs(sp_lo),
                                                        abs(sp_hi))
            for dz in range(dz_n):
                tp_lo = (f0z + (dz - 1) * s + 1) * pool - pool - 0.5
                tp_hi = (f0z + dz * s) * pool + cs + 0.5
                mnz = 0.0 if tp_lo <= 0.0 <= tp_hi else min(abs(tp_lo),
                                                            abs(tp_hi))
                # along (s = off . b) / lateral (l = off . n) intervals
                # of the fetch rectangle: linear -> extremes at corners
                cx = (sp_lo, sp_hi)
                cz = (tp_lo, tp_hi)
                ss = [px * bx + pz * bz for px in cx for pz in cz]
                ll = [px * (-bz) + pz * bx for px in cx for pz in cz]
                if max(ss) < s_blo or min(ss) > s_bhi:
                    continue  # rectangle misses the swath along-band
                if min(ll) > l_bhi or max(ll) < -l_bhi:
                    continue  # rectangle entirely off-swath laterally
                d_min = math.hypot(mnx, mnz)
                charge = max(m_lo, d_min) * q_min
                _max_shift_into(t_far, a2, f0x + dx * s, f0z + dz * s,
                                charge)
        m_lo = m_hi

    return dict(
        t_near=(t_near + MARGIN).astype(np.float32),
        t_far=(t_far + MARGIN).astype(np.float32),
        pool=pool,
        subres=sr,
        n=n,
    )


def upload(maps, device):
    """``build``'s maps with both tables as float32 tensors on ``device``
    (the query's form), or None for gated maps."""
    if maps is None:
        return None
    return dict(maps, t_near=torch.as_tensor(maps["t_near"], device=device),
                t_far=torch.as_tensor(maps["t_far"], device=device))


def sun_clear(maps, pos):
    """True where ``build``'s maps PROVE no terrain blocks any sun-cone
    ray from ``pos`` (``voxtracer/kernels/sunshadow.py:305``). maps: as
    ``upload`` gives them; pos: (..., 3) float32 on the maps' device. Two
    row gathers a lane. subres is a power of two, so ``x * subres`` and
    its floor are exact in float32: a lane lands in exactly the
    sub-column whose phase bound covers it."""
    t_near = maps["t_near"]
    t_far = maps["t_far"]
    pool = int(maps["pool"])
    sr = int(maps["subres"])
    rn = t_near.shape[0]
    k = t_far.shape[0]
    sx = torch.floor(pos[..., 0] * float(sr)).to(torch.int64)
    sz = torch.floor(pos[..., 2] * float(sr)).to(torch.int64)
    y = pos[..., 1]
    inb = (sx >= 0) & (sx < rn) & (sz >= 0) & (sz < rn)  # rn = n * subres
    sxc = sx.clamp(0, rn - 1)
    szc = sz.clamp(0, rn - 1)
    tn = t_near.reshape(-1)[sxc * rn + szc]
    tf = t_far.reshape(-1)[(sxc // (sr * pool)) * k + szc // (sr * pool)]
    return inb & (y > tn) & (y > tf)
