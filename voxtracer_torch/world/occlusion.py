"""Conservative heightfield horizon culling for the per-pose box view.

The port of ``voxtracer/world/occlusion.py`` in plain PyTorch on the
soup's device. A terrain world's box soup is mostly ground hidden behind
nearer hills. For a heightfield that is provable: a box is invisible if
every camera ray toward it passes below terrain somewhere in front of
it. This module builds polar horizon tables around the camera and tests
boxes against them, erring only toward keeping.

Soundness chain (every step weakens occluders or strengthens boxes):

* pooled heights (``min_pool_heights``): the 3x3-neighbourhood min of
  POOL-block minima, so one sample UNDERestimates terrain anywhere
  within +-POOL of the sample point, covering both the angular spread
  of a bin's rays and the radial gap between samples;
* slope lower bound per sample: (h - (cam_y + slack)) / (r + slack) for
  occluders at or above camera, dividing by (r - slack) below: valid
  for ANY camera within ``slack`` of the build pose (ActiveSoup's
  translation budget);
* box slope upper bound: (top - (cam_y - slack)) / (r0 - slack) above
  camera, / (r_far + slack) below;
* theta windows: per radial sample, the horizon is min-pooled over
  power-of-two theta windows at half-window offsets; each box picks the
  SMALLEST ladder window its (exact-arcsin, slack-widened) angular
  range fits inside, and a window min over a SUPERSET of the range only
  under-reports the horizon;
* lateral coverage: an occluder sample at radius r' blocks every ray of
  the box's (slack-widened) range only when the range's lateral reach
  at r' plus the pooled +-POOL neighbourhood covers the rays' paths;
  algebra (slack s, box half-diagonal hd <= s): satisfied for
  r' >= r0 * (s - POOL) / (2 s). The radial test therefore takes the
  MAXIMUM of the per-sample horizon over [r0/4, r0 - slack] only
  (exact range-max via two overlapping power-of-two windows), never
  accumulating near-camera samples that might not cover the range;
* hidden requires min_theta(range) max_r(range) slope > box slope: per
  ray theta*, the witness radius r' has slope(theta*, r') >= the
  theta-window min > s_box >= that ray's slope, so every ray is blocked
  strictly in front of the box.

Boxes nearer than ``r_min`` or with an empty radial range are kept
unconditionally. The float32 ``atan2`` and ``arcsin`` round on torch's
libraries, not XLA's, so a box on a bin edge may pick the neighbouring
bin: the tables are not the JAX package's by bits, and what holds is the
chain above (fuzzed in tests/test_torch_active.py) and its contract, a
culled raster frame equal to the full soup's.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from voxtracer_torch.core.vecmath import div, sqrt

POOL = 32  # default heightmap min-pool factor and radial step (voxels)
NTH = 4096  # angular bins
_J = 9  # radial range-max levels (2^8 = 256 >= any [a, b] length)
# theta-window sizes (bins) the tables carry; half(level) = 8 << level
WINDOW_LADDER = (16, 32, 64, 128, 256, 512)


def r_min(pool: int = POOL) -> float:
    """Never occlusion-cull boxes nearer than this (32 pools)."""
    return 32.0 * pool


def window_levels(slack: float, pool: int = POOL):
    """Theta-window sizes (bins) the tables carry. Each box picks the
    SMALLEST window whose HALF covers its own angular range
    2*ceil(1.001 asin((hd + slack) / (r0 - slack)) / dtheta) + 1 bins;
    boxes needing more than the widest half are kept."""
    return WINDOW_LADDER


def min_pool_heights(heights: np.ndarray, pool: int = POOL) -> np.ndarray:
    """(n, n) heights -> (n/pool, n/pool) conservative pooled heights:
    the 3x3-neighbourhood min of the pool-block min (module doc)."""
    n = heights.shape[0]
    if heights.shape != (n, n) or n % pool:
        raise ValueError(f"min_pool_heights: {heights.shape} is not a "
                         f"square of a multiple of {pool}")
    k = n // pool
    hp = heights.reshape(k, pool, k, pool).min(axis=(1, 3))
    pad = np.pad(hp, 1, mode="edge")
    out = hp.copy()
    for di in (0, 1, 2):
        for dj in (0, 1, 2):
            out = np.minimum(out, pad[di:di + k, dj:dj + k])
    return out.astype(np.float32)


def build_horizon(hmin2, cam_pos, slack: float, nd: int, pool: int = POOL):
    """Polar horizon tables around ``cam_pos`` (module doc).

    hmin2: (k, k) float32 pooled heights (``min_pool_heights``) as a
    tensor, world edge k*pool; the tables land on its device. Returns
    {w: (NTH / (w/2), nd, _J) float32} radial range-max tables over
    theta-window-minned slope samples, one per ``window_levels`` entry.
    """
    dev = hmin2.device
    f32 = torch.float32
    k = hmin2.shape[0]
    cam = torch.as_tensor(np.asarray(cam_pos, np.float32), device=dev)
    th = (torch.arange(NTH, dtype=f32, device=dev) + 0.5) \
        * float(np.float32(2 * np.pi / NTH))
    r = (torch.arange(nd, dtype=f32, device=dev) + 1.0) * float(pool)
    qx = cam[0] + torch.cos(th)[:, None] * r[None, :]
    qz = cam[2] + torch.sin(th)[:, None] * r[None, :]
    ix = torch.floor(div(qx, float(pool))).to(torch.int64)
    iz = torch.floor(div(qz, float(pool))).to(torch.int64)
    inside = (ix >= 0) & (ix < k) & (iz >= 0) & (iz < k)
    flat = hmin2.reshape(-1)
    h = torch.where(inside,
                    flat[torch.clamp(ix, 0, k - 1) * k
                         + torch.clamp(iz, 0, k - 1)],
                    -1e9)  # outside the world: nothing occludes
    # slope LOWER bound for any slack-translated camera: the highest
    # camera, and the pessimal distance for the numerator's sign
    num = h - (cam[1] + slack)
    slope = num / torch.where(num >= 0, r[None, :] + slack,
                              torch.clamp_min(r[None, :] - slack, 1.0))
    out = {}
    for w in window_levels(slack, pool):
        half = w // 2
        rows = NTH // half
        pooled = slope.reshape(rows, half, nd).amin(dim=1)
        # window i covers theta bins [i*half, i*half + w), circular
        b = torch.minimum(pooled, torch.roll(pooled, -1, dims=0))
        # radial range-max doubling table: R[.., i, j] = max over
        # samples [i - 2^j + 1, i]
        levels = [b]
        cur = b
        for j in range(1, _J):
            shift = min(1 << (j - 1), nd)
            prev = torch.cat([torch.full((rows, shift), -math.inf,
                                         dtype=f32, device=dev),
                              cur[:, :nd - shift]], dim=1)
            cur = torch.maximum(cur, prev)
            levels.append(cur)
        out[w] = torch.stack(levels, dim=-1)
    return out


def hidden_mask(tables, box_c, box_half, cam_pos, slack, nd: int,
                pool: int = POOL):
    """True for boxes PROVABLY hidden behind terrain (module doc).

    tables: ``build_horizon``'s output for the same cam_pos, slack and
    pool. box_c / box_half: (M, 3) float32 centres and half-extents on
    the tables' device. Sound for any box size: the lateral coverage
    bound only loosens as hd grows, and oversized angular ranges are
    kept by the window-fit guard."""
    dev = box_c.device
    i64 = torch.int64
    cam = np.asarray(cam_pos, np.float32)
    slack = float(slack)
    dx = box_c[:, 0] - float(cam[0])
    dz = box_c[:, 2] - float(cam[2])
    rxz = sqrt(dx * dx + dz * dz)
    half_diag = sqrt(box_half[:, 0] ** 2 + box_half[:, 2] ** 2)
    r0 = rxz - half_diag  # nearest horizontal distance
    r_far = rxz + half_diag
    top = box_c[:, 1] + box_half[:, 1]
    # box slope UPPER bound over the slack ball (the lowest camera; the
    # pessimal distance by the numerator's sign)
    num = top - (float(cam[1]) - slack)
    s_box = num / torch.where(num >= 0, torch.clamp_min(r0 - slack, 1.0),
                              r_far + slack)

    theta = torch.atan2(dz, dx)
    bins_per_rad = float(np.float32(NTH / (2 * np.pi)))
    tbin = torch.remainder(torch.floor(theta * bins_per_rad).to(i64), NTH)

    # radial sample range [a, b]: strictly nearer than the box for any
    # slack camera (b), and laterally covering (a >= ~r0/4, module doc)
    b_idx = torch.floor(div(r0 - slack, float(pool))).to(i64) - 1
    a_idx = torch.clamp_min(torch.floor(div(
        r0 * max(slack - pool, 0.0),
        2.0 * max(slack, 1.0) * pool)).to(i64), 0)
    ok = (b_idx >= a_idx) & (b_idx < nd) & (r0 >= r_min(pool))
    a_c = torch.clamp(a_idx, 0, nd - 1)
    b_c = torch.clamp(b_idx, 0, nd - 1)
    # doubling level jq = floor(log2(len)): the two 2^jq windows at the
    # range's ends cover [a, b] exactly (2*2^jq >= len)
    ln = b_c - a_c + 1
    jq = sum((ln >= (1 << t)).to(i64) for t in range(1, _J))

    # bearing half-range of any box point seen from any slack camera,
    # asin((hd + slack)/(r0 - slack)), computed exactly (arcsin; the
    # 1.001 covers float rounding)
    ladder = window_levels(slack, pool)
    range_x = torch.clamp_max(
        (half_diag + slack) / torch.clamp_min(r0 - slack, 1.0), 0.999)
    rb = torch.ceil(1.001 * torch.asin(range_x) * bins_per_rad).to(i64)
    lo_bin = torch.remainder(tbin - rb, NTH)
    range_bins = 2 * rb + 1

    # smallest ladder window whose HALF covers the range (the low theta
    # edge picks the containing window: windows sit at half-window
    # offsets, so [lo_bin, lo_bin + half) always fits one)
    halves = [w // 2 for w in ladder]
    lvl = sum((range_bins > h).to(i64) for h in halves)
    fits = lvl < len(ladder)
    lvl_c = torch.clamp_max(lvl, len(ladder) - 1)
    wi = lo_bin >> (3 + lvl_c)
    sizes = [(NTH // h) * nd * _J for h in halves]
    starts = torch.tensor(np.concatenate([[0], np.cumsum(sizes)[:-1]]),
                          dtype=i64, device=dev)
    base = starts[lvl_c] + wi * (nd * _J)
    allflat = torch.cat([tables[w].reshape(-1) for w in ladder])
    hi = allflat[base + b_c * _J + jq]
    lo_end = torch.clamp_max(a_c + (torch.ones_like(jq) << jq) - 1, nd - 1)
    lo_v = allflat[base + lo_end * _J + jq]
    hmax = torch.maximum(hi, lo_v)
    return fits & ok & (hmax > s_box + 1e-4)
