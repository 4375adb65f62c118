"""Conservative cone-march prefix for coherent primary bundles: the port
of ``voxtracer/kernels/conemarch.py``. ``build_cone_mips`` is host numpy
(uploaded to the device); ``frame_tile_bundles`` and ``cone_prefix`` run
in PyTorch on the device. No kernel: nothing in the JAX package's
Renderer takes the cone (its envelope subsumes it, driver.py:894-897), so
``cone_prefix`` stays plain PyTorch until a measurement says a kernel
pays; it reads the host once every ``CHECK_EVERY`` march steps, not once
a step. What follows is the reference's own account.


The full-frame heightfield cast (heightfield.hf_frame_cast) walks every
pixel's ray independently; at flagship scale the walk is gather-bound
and most of each lane's iterations re-prove air the 63 other rays of
its 8x8 pixel tile already proved (measured: a PERFECT per-pixel
t_min-resume floors the 8192^3 1080p frame at 594 of 1031 ms, and sky
lanes — 21% of the frame — cost ~45% of it because nothing ever
retires them early; docs/PERF_TPU.md round 3, TPU v5e).

This module certifies, per pixel TILE, a parameter T such that EVERY
ray of the tile is strictly in air on [0, T] of its own
parameterization. Per-pixel casts then resume at t_min = T via
hf_raycast's t_min contract (kernels/heightfield.py): ground lanes
skip the long coherent prefix, and fully-sky tiles certify past the
world so their pixels barely walk at all.

Soundness argument (the only property that matters — any
under-certification merely costs speed):

* bundle parameterization: the march runs in UNNORMALIZED camera-dir
  space, where a pixel's direction is affine in its ndc coords
  ``[lx, -ly, 1] @ basis.T`` — so the component-wise box of a tile's
  four (jitter-padded) corner directions bounds every interior pixel
  and sub-pixel jitter direction exactly (camera.pixel_ndc /
  ray_directions; rotation is linear, the ndc patch is a rectangle).
  The cast dirs are the NORMALIZED versions: a point ``o + t*d_n``
  with ``t <= S * |d_un|`` equals ``o + s*d_un`` with ``s <= S``, and
  ``|d_un| = sqrt(1 + lx^2 + ly^2) >= nmin(tile)``, so a certificate
  for unnormalized parameter S yields per-ray t_min = S * nmin.
* bundle geometry: all rays share the camera origin ``o``; a tile's
  unnormalized directions lie in the box ``dc +- sig`` (half-width of
  the corner box, inflated by f32-epsilon slop). At parameter s a
  bundle ray's position differs from the central ray's by at most
  ``s * sig`` per component.
* march invariant: the walk advances the CENTRAL ray through cells of
  a 3x3-DILATED max pyramid (``build_cone_mips``): level-L cell
  (cx, cz) stores the max terrain height over that cell and its 8
  level-L neighbors, so one fetch bounds the height over cell +- 2^L.
* step certificate: over a step [s, s_exit] the central xz stays
  inside the current cell (s_exit is the cell's exit crossing), so
  bundle xz stays within cell +- s_exit * sig_xz; the step requires
  ``s_exit * max(sig_x, sig_z) <= 2^L`` (else it stops), so the
  dilated fetch covers every bundle position over the step. Bundle y
  over the step is at least ``o_y + min over endpoints of
  s' * (dc_y - sig_y)`` (linear in s'). If that clears the dilated
  max, every bundle ray is in air across the whole step.
* level policy is monotone per step (certified -> advance and coarsen
  one level; uncertified -> descend one level; at the spread floor or
  ``min_level`` -> stop), so the loop cannot ping-pong; the iteration
  budget truncates T early, which is conservative.
* output slack: T is returned minus ``SLACK`` (2.0 voxels, the margin
  raster.apply_fallback_hf uses for its resume) so f32 rounding in
  pos/crossing arithmetic — bounded far below a voxel per step —
  can never push T past a true surface crossing, and the resumed
  lane re-enters the walk strictly in air as _hf_init requires.

The reference has no analogue (its per-pixel GPU traversal never
amortizes across rays; raytrace.wgsl:68-180); this is a TPU-first
design: the march is ~32k lanes x 1 gather/iteration, amortizing the
serialized-gather ceiling across 64-pixel bundles.

Exactness: prefixed casts are BIT-IDENTICAL to unprefixed ones
(hf_raycast's t_min resume re-enters the walk's own arithmetic;
tests/test_conemarch.py asserts frame equality, and a brute-force
sampling fuzz attacks the certificate itself).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from voxtracer_torch.core.vecmath import rdiv

SLACK = 2.0  # voxels shaved off the certified prefix (f32 wobble)
CHECK_EVERY = 16  # march steps between two host reads of "any alive"


def build_cone_mips(heights, min_level: int = 3, device="cuda"):
    """3x3-dilated max pyramid over the heightmap, one flat float32 tensor
    on ``device`` (``conemarch.py:81``). Level L (cell = 2^L voxels)
    stores, per cell, the max height over the cell and its 8 level-L
    neighbours; levels below ``min_level`` are omitted. np.roll wraps at
    the grid edge, which can only raise a bound. Returns (flat, offsets
    indexed by L - min_level, min_level)."""
    h = np.asarray(heights, np.float32)
    n = h.shape[0]
    assert h.shape == (n, n) and (n & (n - 1)) == 0
    top = int(math.log2(n))
    levels = []
    cur = h
    for L in range(top + 1):
        if L >= min_level:
            d = np.maximum(cur, np.roll(cur, 1, 0))
            d = np.maximum(d, np.roll(cur, -1, 0))
            d = np.maximum(d, np.roll(d, 1, 1))
            d = np.maximum(d, np.roll(d, -1, 1))
            levels.append(d.astype(np.float32))
        if cur.shape[0] > 1:
            m = cur.shape[0] // 2
            cur = cur.reshape(m, 2, m, 2).max(axis=(1, 3))
    offsets = []
    off = 0
    for lv in levels:
        offsets.append(off)
        off += lv.size
    flat = np.concatenate([lv.ravel() for lv in levels])
    return torch.from_numpy(flat).to(device), tuple(offsets), min_level


def cone_prefix(cone_flat, cone_offsets: tuple, min_level: int, height: int,
                origin, dc, sig, max_iters: int = 192, walk=None):
    """Per-bundle certified-air prefix S in the unnormalized-direction
    parameter (``conemarch.py:120``). origin (3,); dc/sig (B, 3) bundle
    central directions and component half-spreads on the device. Returns
    (B,) float32 S >= 0, SLACK already shaved: every bundle ray (direction
    within dc +- sig) is strictly in air on [0, S]. Each bundle steps
    until it stops or ``max_iters`` steps pass; the loop reads the host
    every ``CHECK_EVERY`` steps to end early when no bundle walks.
    ``walk``: a dict to receive ``bundle_steps``, the march steps taken
    summed over the bundles (one host read at the end)."""
    f32 = torch.float32
    dev = cone_flat.device
    ox, oy, oz = (float(v) for v in np.asarray(
        origin.cpu() if torch.is_tensor(origin) else origin, np.float32))
    dc = dc.to(dev, f32)
    sig = sig.to(dev, f32)
    B = dc.shape[0]
    top = height
    offs = torch.tensor(cone_offsets, dtype=torch.int64, device=dev)
    n_lv = len(cone_offsets)
    sig_xz = torch.maximum(sig[:, 0], sig[:, 2])
    ylo_rate = dc[:, 1] - sig[:, 1]
    # past any in-world parameter: unnormalized directions have camera-z
    # exactly 1, so s = 4 * bound is outside the grid for every bundle ray
    s_end = 4.0 * float(1 << height)

    def inv(x):
        ax = torch.clamp_min(torch.abs(x), 1e-12)
        return torch.where(x < 0, -rdiv(1.0, ax), rdiv(1.0, ax))

    inv_x, inv_z = inv(dc[:, 0]), inv(dc[:, 2])
    pos_x = (dc[:, 0] >= 0).to(f32)
    pos_z = (dc[:, 2] >= 0).to(f32)
    s = torch.zeros((B,), dtype=f32, device=dev)
    L = torch.full((B,), top - 1, dtype=torch.int64, device=dev)
    alive = torch.ones((B,), dtype=torch.bool, device=dev)
    steps = torch.zeros((), dtype=torch.int64, device=dev)
    for it in range(max_iters):
        if it % CHECK_EVERY == 0 and not bool(alive.any()):
            break
        if walk is not None:
            steps += alive.sum()
        cell = torch.exp2(L.to(f32))
        px = ox + s * dc[:, 0]
        pz = oz + s * dc[:, 2]
        cx = torch.floor(px / cell)
        cz = torch.floor(pz / cell)
        # next crossing of this cell's planes along the central ray
        sx = ((cx + pos_x) * cell - ox) * inv_x
        sz = ((cz + pos_z) * cell - oz) * inv_z
        s_exit = torch.clamp_max(torch.minimum(sx, sz), s_end)
        s_exit = torch.maximum(s_exit, s)  # never march back
        # the bundle's xz spread at s_exit must fit the dilation
        fits = s_exit * sig_xz * 1.00001 + 0.0625 <= cell
        dim = torch.ones_like(L) << (top - L)
        dimf = dim.to(f32)
        li = torch.clamp(L - min_level, 0, n_lv - 1)
        ci = torch.minimum(torch.clamp_min(cx.to(torch.int64), 0), dim - 1)
        cj = torch.minimum(torch.clamp_min(cz.to(torch.int64), 0), dim - 1)
        maxh = cone_flat[offs[li] + ci * dim + cj]
        outside = (cx < -1.0) | (cx > dimf) | (cz < -1.0) | (cz > dimf)
        y_min = oy + torch.minimum(s * ylo_rate, s_exit * ylo_rate)
        clear = y_min > maxh + 0.25
        ok = fits & (clear | outside)
        # monotone level policy: certified -> advance and coarsen;
        # uncertified but descendable -> refine; else stop
        can_desc = ~ok & fits & (L > min_level) & (s * sig_xz <= cell * 0.5)
        s_n = torch.where(ok, s_exit, s)
        L_n = torch.where(ok, torch.clamp_max(L + 1, top - 1),
                          torch.where(can_desc, L - 1, L))
        done = (~ok & ~can_desc) | (s_n >= s_end)
        s = torch.where(alive, s_n, s)
        L = torch.where(alive, L_n, L)
        alive = alive & ~done
    if walk is not None:
        walk["bundle_steps"] = int(steps)
    return torch.clamp_min(s - SLACK, 0.0)


def frame_tile_bundles(cam_basis, width_px: int, height_px: int,
                       tile: int = 8, jitter_pad: bool = True,
                       device="cuda"):
    """Per-pixel-tile direction bundles of a camera frame
    (``conemarch.py:218``): (T, 3) central UNNORMALIZED directions, (T, 3)
    component half-spreads and (T,) each tile's least unnormalized norm
    (``t_min = S * nmin`` turns cone_prefix's S into the normalized ray
    parameter), in row-major tile order, on ``device``. The corners are
    the tile's outer pixel centres +- half a pixel when ``jitter_pad``, so
    they bound every interior pixel and jitter draw."""
    W, H = width_px, height_px
    tx = -(-W // tile)
    ty = -(-H // tile)
    x0 = (np.arange(tx) * tile).astype(np.float32)
    x1 = np.minimum(x0 + tile - 1, W - 1).astype(np.float32)
    y0 = (np.arange(ty) * tile).astype(np.float32)
    y1 = np.minimum(y0 + tile - 1, H - 1).astype(np.float32)
    pad = 0.5 if jitter_pad else 0.0
    w = np.float32(W)
    h = np.float32(H)
    lx0 = (2.0 * (x0 - pad + 0.5) - w) / h
    lx1 = (2.0 * (x1 + pad + 0.5) - w) / h
    ly0 = (2.0 * (y0 - pad + 0.5) - h) / h
    ly1 = (2.0 * (y1 + pad + 0.5) - h) / h
    # corner grids (ty, tx, 4), corners x0y0, x1y0, x0y1, x1y1
    cx = np.stack([np.broadcast_to(a[None, :], (ty, tx))
                   for a in (lx0, lx1, lx0, lx1)], -1)
    cy = np.stack([np.broadcast_to(a[:, None], (ty, tx))
                   for a in (ly0, ly0, ly1, ly1)], -1)
    d_cam = torch.from_numpy(np.stack([cx, -cy, np.ones_like(cx)], -1)
                             .reshape(-1, 4, 3).astype(np.float32)).to(device)
    b = torch.as_tensor(np.asarray(cam_basis, np.float32)).to(device)
    # d_cam @ basis.T, summed left to right
    dirs = (d_cam[..., 0:1] * b[:, 0] + d_cam[..., 1:2] * b[:, 1]
            + d_cam[..., 2:3] * b[:, 2])
    lo = torch.amin(dirs, 1)
    hi = torch.amax(dirs, 1)
    dc = 0.5 * (lo + hi)
    # float32 slop: interior directions are exact affine combinations;
    # the relative and absolute inflation buries the rotation's rounding
    sig = (hi - lo) * 0.5 * 1.000004 + 1e-6
    mx = np.where((lx0 <= 0) & (0 <= lx1), 0.0,
                  np.minimum(np.abs(lx0), np.abs(lx1)))
    my = np.where((ly0 <= 0) & (0 <= ly1), 0.0,
                  np.minimum(np.abs(ly0), np.abs(ly1)))
    nmin = np.sqrt(1.0 + (mx[None, :] ** 2) + (my[:, None] ** 2))
    return dc, sig, torch.from_numpy(
        nmin.reshape(-1).astype(np.float32)).to(device)
