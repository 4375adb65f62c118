"""Tile-binned box rasterization: primary visibility from the box soup.

The port of ``voxtracer/kernels/raster.py``. The winner's albedo rides
the resolve carry; with ``want_voxel`` (the default, as in the JAX
package) the frame also carries each pixel's leaf id (``node``) and hit
voxel, gathered from the winning box, for picking and editing.
Shading-only callers (the integrator, previews) pass
``want_voxel=False``. Pipeline:

1. ``raster_bins`` (pose only): project every box's corners, conservative
   pixel bbox, frustum cull; pick each box's emission tier by the
   product of its tile spans; emit (tile, box) pairs in the JAX package's
   order; pack (tile, quantized camera distance) into one int32 key; ONE
   stable sort carries the pair records; ``searchsorted`` finds each
   tile's segment; the nearest distance bound beyond each tile's K
   nearest records and the near list (boxes behind the camera or over
   1024 tiles, resolved against every tile) complete the bins.
2. ``raster_cast``: rays tiled 8x8 (k jitter samples of one pose stack
   in the tile's ray axis, r = sample * 64 + intile); the near pre-pass,
   the main fold of K candidates and three widen rounds (the next 104 /
   256 / 1024 records of every tile not provably complete) all run on
   the resolve fold, kernel K3 (``kernels/resolve.py``). The main fold
   and the widen rounds read the sorted pair array where it lies and
   update the frame's carry in place (``resolve_fold_seg``): a round
   hands the kernel its tile list and each tile's next record, and gets
   back each tile's farthest resolved t and the distance bound of the
   first record it has not folded; a tile is open while that bound is
   nearer than that t. Tiles still open after the last round are listed
   with the rays that need a re-cast.
   A band of TILE-aligned rows (``band_row0``/``band_rows``, the tile
   sharded step's) resolves only its run of tiles against the full-frame
   bins: K3 folds the band's run of the sorted records, their tile ids
   made band-local (``_band_records``), into a carry sized to the band.
3. ``apply_fallback`` re-casts those rays with the SVO cast (kernel K2),
   so ``raster_cast_exact`` gives the traversal's first hit; on unedited
   terrain ``apply_fallback_hf`` re-casts them with the heightfield walk
   (kernel K4) instead, resumed just before each tile's nearest unfolded
   record.

The JAX package needs fixed shapes, so it gives every tier, the near
list, the widen rounds and the fallback a static capacity and reports
overflow. PyTorch does not: the port sizes every tier exactly from one
host read of the tier counts per pose, widens every incomplete tile and
re-casts every still-incomplete one, so nothing can overflow and nothing
is dropped. That costs host reads: one per pose (the tier counts), and
per cast one per widen round entered (the list of open tiles) plus one
for the fallback list when the last round ran, and for a band one more
(its run of records). ``host_reads`` counts them.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.core.vecmath import dot, rdiv, sqrt
from voxtracer_torch.kernels.heightfield import hf_raycast
from voxtracer_torch.kernels.resolve import (dequant, resolve_fold,
                                             resolve_fold_seg)
from voxtracer_torch.kernels.traverse import EPS, FAR, leaf_rgb, svo_raycast

NEAR_EPS = 1.0e-4  # camera-space z below which corners are unprojectable
TILE = 8  # screen tile edge (pixels)
# emission tier arities: tier t holds boxes whose tile-span product lies
# in (arity[t-1], arity[t]] and emits arity[t] pairs per box
PAIR_ARITIES = (2, 4, 8, 16, 32, 64, 128, 256, 512, 1024)
_NTIERS = len(PAIR_ARITIES)
# records each widen round folds for every tile still open (the JAX
# package's widen_k / widen2_k / widen3_k)
WIDEN_K = (104, 256, 1024)
# sort codes of the tier pass: 0 near, 1.._NTIERS tiers, then 1x1 boxes
# and culled boxes
_ONE = _NTIERS + 1
_CULLED = _NTIERS + 2

host_reads = 0  # device-to-host reads since the last reset (module doc)


def soup_to_device(lo, size, leaf, rgb, device):
    """The box soup as the rasterizer takes it: (box_lo int32 (M, 3),
    box_size int32 (M, 3), box_attr float32 (M, 4) = [leaf bits, r, g,
    b], the JAX package's ``pack_box_attr``) tensors on ``device``, from
    numpy arrays (a ``BoxSoup``'s fields, or the JAX package's)."""
    attr = np.concatenate([np.asarray(leaf, np.int32).view(np.float32)[:, None],
                           np.asarray(rgb, np.float32)], axis=1)
    return (torch.as_tensor(np.asarray(lo, np.int32), device=device),
            torch.as_tensor(np.asarray(size, np.int32), device=device),
            torch.as_tensor(attr, device=device))


def _host_vec(x):
    """Three float32 values on the host from a tuple, array or tensor."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32).reshape(3)


def _ray_dirs_for_pixels(px, py, basis, width, height):
    """World-space unit directions through pixel centers, by the exact ops
    of ``camera.generate_rays``."""
    ld = vcam.pixel_ndc(px, py, width, height)
    return vcam.ray_directions(basis, ld)


def tile_rays(basis, W: int, H: int, ray_dirs=None, band_row0: int = 0,
              band_rows: int | None = None):
    """Rays in raster tile layout: ``d_t`` (NT, KS*64, 3) with r = sample
    * 64 + intile, ``ok_t`` (NT, KS*64) marking real pixels, and the
    padded frame ``d_pad`` (KS, HP, WP, 3), whose padding pixels repeat
    the edge. ``ray_dirs``: None (pixel centers of the camera ``basis``,
    KS = 1), (H, W, 3) or (KS, H, W, 3) directions. ``band_row0`` /
    ``band_rows`` (TILE-aligned): the tiles of the frame rows [band_row0,
    band_row0 + band_rows) only; ``ray_dirs`` is then band-shaped, and a
    band row past the frame's edge takes its own ray but is no real
    pixel."""
    TW = -(-W // TILE)
    TH = -(-H // TILE) if band_rows is None else band_rows // TILE
    NT = TW * TH
    WP, HP = TW * TILE, TH * TILE
    dev = basis.device
    ys = band_row0 + torch.arange(HP, dtype=torch.int32, device=dev)
    xs = torch.arange(WP, dtype=torch.int32, device=dev)
    if ray_dirs is None:
        pyp, pxp = torch.meshgrid(ys, xs, indexing="ij")
        d_pad = _ray_dirs_for_pixels(torch.clamp_max(pxp, W - 1),
                                     torch.clamp_max(pyp, H - 1), basis, W,
                                     H)[None]
    else:
        rd = ray_dirs.to(torch.float32)
        if rd.dim() == 3:
            rd = rd[None]
        rows = (torch.clamp_max(ys, H - 1) if band_rows is None
                else ys - band_row0)
        d_pad = rd[:, rows.long()][:, :, torch.clamp_max(xs, W - 1).long()]
    KS = d_pad.shape[0]
    R = KS * TILE * TILE
    d_t = d_pad.reshape(KS, TH, TILE, TW, TILE, 3).permute(
        1, 3, 0, 2, 4, 5).reshape(NT, R, 3).contiguous()
    ok = (ys[:, None] < H) & (xs[None, :] < W)
    ok_t = ok.reshape(TH, TILE, TW, TILE).permute(0, 2, 1, 3).reshape(
        NT, TILE * TILE).repeat(1, KS)
    return d_t, ok_t, d_pad


def raster_bins(box_lo, box_size, box_attr, cam_pos, cam_basis,
                tree_height: int, W: int, H: int, cand_k: int = 16,
                jittered: bool = False):
    """The pose-only half of the rasterizer (project, tier, emit, sort,
    bin); compute it once per camera pose and pass it to every sample's
    ``raster_cast(..., bins=...)``. ``jittered`` must be True when the
    samples supply sub-pixel-jittered ``ray_dirs``.

    Returns a dict: ``skey`` (PAIRS,) the sorted int32 keys (tile in the
    high bits, the quantized distance in the low ``dmin_bits``),
    ``spairs`` (PAIRS, 8) the sorted records [key, owner, q0, q1, q2, r,
    g, b] ending in sentinel rows (tile NT; at least one), ``seg_start``
    (NT,), ``cand_k`` the main fold's K (its candidates are the K records
    from ``seg_start`` on), ``drop_dmin`` (NT,) the bound of each tile's
    nearest record beyond them (inf: nothing dropped; the main fold
    returns the same),
    ``near_idx`` (n_near,) and ``near_rows`` (n_near, 8) the near list,
    ``center_rays`` the pose's pixel-center rays as ``tile_rays`` returns
    them (None when ``jittered``: the samples bring their own rays),
    ``n_tier`` the host counts [near, tier 1..10], ``n_near`` and
    ``n_pair`` (real pairs, a device scalar).
    """
    global host_reads
    dev = box_lo.device
    TW = -(-W // TILE)
    TH = -(-H // TILE)
    NT = TW * TH
    M = box_lo.shape[0]
    i32 = torch.int32
    cam_np = _host_vec(cam_pos)
    cam = torch.as_tensor(cam_np, device=dev)
    basis = torch.as_tensor(cam_basis, dtype=torch.float32).to(dev)

    lo_f = box_lo.to(torch.float32)
    hi_f = lo_f + box_size.to(torch.float32)

    # ---- project the 8 corners, one corner at a time, every product
    # written out (no matmul): v = basis^T (corner - pos); pixel-center
    # coords px = (vx/vz*h + w)/2 - 0.5. Jittered rays roam +-0.5 px, so
    # the frustum test widens by one pixel footprint.
    jit_pad = (1.0 / H) if jittered else 0.0
    fx = float(np.float32((W - 1) / H + 1e-3 + jit_pad))
    fy = float(np.float32(1.0 + 1e-3 + jit_pad))
    b = basis
    rel_lo = [lo_f[:, i] - cam[i] for i in range(3)]
    rel_hi = [hi_f[:, i] - cam[i] for i in range(3)]
    for corner in range(8):
        c = [rel_hi[a] if (corner >> a) & 1 else rel_lo[a] for a in range(3)]
        vx = c[0] * b[0, 0] + c[1] * b[1, 0] + c[2] * b[2, 0]
        vy = c[0] * b[0, 1] + c[1] * b[1, 1] + c[2] * b[2, 1]
        vz = c[0] * b[0, 2] + c[1] * b[1, 2] + c[2] * b[2, 2]
        behind = vz < NEAR_EPS
        o_px = vx > vz * fx
        o_nx = -vx > vz * fx
        o_py = vy > vz * fy
        o_ny = -vy > vz * fy
        vz_safe = torch.clamp_min(vz, NEAR_EPS)
        pxc = (vx / vz_safe * H + W) * 0.5 - 0.5
        pyc = (-vy / vz_safe * H + H) * 0.5 - 0.5
        if corner == 0:
            any_behind, all_behind = behind, behind
            out_px, out_nx, out_py, out_ny = o_px, o_nx, o_py, o_ny
            px_min = px_max = pxc
            py_min = py_max = pyc
        else:
            any_behind = any_behind | behind
            all_behind = all_behind & behind
            out_px, out_nx = out_px & o_px, out_nx & o_nx
            out_py, out_ny = out_py & o_py, out_ny & o_ny
            px_min = torch.minimum(px_min, pxc)
            px_max = torch.maximum(px_max, pxc)
            py_min = torch.minimum(py_min, pyc)
            py_max = torch.maximum(py_max, pyc)
    outside = out_px | out_nx | out_py | out_ny

    # float32 rounding grows with world scale; jitter adds half a pixel
    pad = 0.01 + (1 << tree_height) * 2.0e-5
    if jittered:
        pad += 0.5
    pad = float(np.float32(pad))

    def to_px(x):  # saturating float -> int32 pixel coordinate
        return torch.clamp(x, -2.0 ** 30, 2.0 ** 30).to(i32)

    x0 = torch.clamp(to_px(torch.ceil(px_min - pad)), 0, W - 1)
    x1 = torch.clamp(to_px(torch.floor(px_max + pad)), -1, W - 1)
    y0 = torch.clamp(to_px(torch.ceil(py_min - pad)), 0, H - 1)
    y1 = torch.clamp(to_px(torch.floor(py_max + pad)), -1, H - 1)
    empty = (x1 < x0) | (y1 < y0) | all_behind | outside

    fdiv = lambda a: torch.div(a, TILE, rounding_mode="floor")  # noqa: E731
    tx0, tx1, ty0, ty1 = fdiv(x0), fdiv(x1), fdiv(y0), fdiv(y1)
    prod = (tx1 - tx0 + 1) * (ty1 - ty0 + 1)
    near = ~empty & (any_behind | (prod > PAIR_ARITIES[-1]))
    usable = ~empty & ~near

    # camera-to-box distance: a lower bound on any unit ray's entry t
    clamped = torch.minimum(torch.maximum(cam, lo_f), hi_f)
    rel = clamped - cam
    dmin_b = sqrt(dot(rel, rel))

    # ---- tiers: one stable sort of a per-box code, one host read of the
    # counts; each tier's boxes come out in box-index order
    code = torch.full((M,), 1, dtype=i32, device=dev)
    for thr in PAIR_ARITIES[:-1]:
        code = code + (prod > thr).to(i32)
    code = torch.where(usable & (prod > 1), code, _ONE)
    code = torch.where(near, 0, torch.where(empty, _CULLED, code))
    order = torch.argsort(code, stable=True).to(i32)
    counts = torch.bincount(code, minlength=_CULLED + 1).tolist()
    host_reads += 1
    offs = np.concatenate([[0], np.cumsum(counts)]).tolist()
    members = [order[offs[k]:offs[k + 1]].long() for k in range(_CULLED + 1)]
    n_tier = counts[:_NTIERS + 1]

    # ---- (tile, box) pairs in the JAX package's emission order: the 1x1
    # boxes, then tiers 1..10; arity <= 8 kk-major, larger slot-major.
    # A pair outside its box's span rectangle is a sentinel (tile NT).
    q0 = box_lo[:, 0] | (box_lo[:, 1] << 16)
    q1 = box_lo[:, 2] | (box_size[:, 0] << 16)
    q2 = box_size[:, 1] | (box_size[:, 2] << 16)
    rgb_bits = box_attr[:, 1:4].contiguous().view(i32)
    geom = torch.cat([torch.stack([q0, q1, q2], dim=1), rgb_bits], dim=1)

    ptile, powner, pdmin = [], [], []
    ones = members[_ONE]
    ptile.append(ty0[ones] * TW + tx0[ones])
    powner.append(ones)
    pdmin.append(dmin_b[ones])
    for k, arity in enumerate(PAIR_ARITIES, 1):
        ik = members[k]
        if ik.numel() == 0:
            continue
        etx0, ety0, edmin = tx0[ik], ty0[ik], dmin_b[ik]
        tw_e = tx1[ik] - etx0 + 1
        th_e = ty1[ik] - ety0 + 1
        inv_tw = rdiv(1.0, tw_e.to(torch.float32))
        if arity <= 8:
            for kk in range(arity):
                iy = torch.floor((kk + 0.5) * inv_tw).to(i32)
                ix = kk - iy * tw_e
                pv = iy < th_e
                ptile.append(torch.where(pv, (ety0 + iy) * TW + etx0 + ix, NT))
                powner.append(ik)
                pdmin.append(torch.where(pv, edmin, torch.inf))
            continue
        kk = torch.arange(arity, dtype=i32, device=dev)
        iy = torch.floor((kk[None, :].to(torch.float32) + 0.5)
                         * inv_tw[:, None]).to(i32)
        ix = kk[None, :] - iy * tw_e[:, None]
        pv = iy < th_e[:, None]
        ptile.append(torch.where(pv, (ety0[:, None] + iy) * TW
                                 + etx0[:, None] + ix, NT).reshape(-1))
        powner.append(ik[:, None].expand(-1, arity).reshape(-1))
        pdmin.append(torch.where(pv, edmin[:, None], torch.inf).reshape(-1))
    ptile = torch.cat(ptile).to(i32)
    powner = torch.cat(powner)
    pdmin = torch.cat(pdmin)

    # ---- one packed key: tile in the high bits (plus a zero sign bit),
    # the distance quantized into the low DB bits
    NTB = int(NT + 1).bit_length() + 1
    DB = 32 - NTB
    diag = float(3.0 ** 0.5) * float(1 << tree_height)
    quantum = np.float32(diag / ((1 << DB) - 2))
    inv_q = float(np.float32(1.0) / quantum)
    qmax = (1 << DB) - 2
    qd = torch.clamp(pdmin * inv_q, max=float(qmax)).to(i32)
    qd = torch.where(torch.isfinite(pdmin), qd, qmax + 1)
    key = (ptile << DB) | qd
    records = torch.cat([key[:, None], powner.to(i32)[:, None],
                         geom[powner]], dim=1)

    # ONE stable sort: equal keys keep emission order; then one row
    # gather of the records, and the sentinel row closes every segment
    skey, perm = torch.sort(key, stable=True)
    sentinel = torch.zeros((1, 8), dtype=i32, device=dev)
    sentinel[0, 0] = (NT << DB) | (qmax + 1)
    spairs = torch.cat([records[perm], sentinel])
    skey = spairs[:, 0].contiguous()
    PAIRS = spairs.shape[0]
    tix = torch.arange(NT, dtype=i32, device=dev)
    seg_start = torch.searchsorted(skey, tix << DB, out_int32=True)
    posk = torch.clamp_max(seg_start + cand_k, PAIRS - 1).long()
    drop_dmin = torch.where((skey[posk] >> DB) == tix,
                            dequant(skey[posk], DB, float(quantum)),
                            torch.inf)
    near_idx = members[0]
    near_rows = torch.cat([torch.zeros_like(near_idx, dtype=i32)[:, None],
                           near_idx.to(i32)[:, None], geom[near_idx]], dim=1)
    return dict(
        skey=skey, spairs=spairs, seg_start=seg_start, dmin_bits=DB,
        quantum=float(quantum), cand_k=cand_k, drop_dmin=drop_dmin,
        near_idx=near_idx.to(i32), near_rows=near_rows, n_tier=n_tier,
        n_near=n_tier[0], n_pair=(ptile < NT).sum(),
        center_rays=None if jittered else tile_rays(basis, W, H),
    )


def _band_records(bins, t0: int, n: int):
    """The sorted records of the tiles [t0, t0 + n) for a band's fold:
    the run of ``spairs`` from the band's first record through the first
    record past it (a later tile's, or the sentinel row), copied with
    every key's tile made band-local (minus ``t0 << dmin_bits``; the
    distance bits stay), and each band tile's first record in that run.
    K3 indexes its carry by the tile a record names, so a carry sized to
    the band needs band-local ids. One host read (the run's ends)."""
    global host_reads
    DB, skey = bins["dmin_bits"], bins["skey"]
    edges = torch.tensor([t0 << DB, (t0 + n) << DB], dtype=torch.int32,
                         device=skey.device)
    s0, s1 = torch.searchsorted(skey, edges, out_int32=True).tolist()
    host_reads += 1
    recs = bins["spairs"][s0:s1 + 1].clone()
    recs[:, 0] -= t0 << DB
    return recs, (bins["seg_start"][t0:t0 + n] - s0).contiguous()


def raster_cast(box_lo, box_size, box_attr, cam_pos, cam_basis,
                tree_height: int, W: int, H: int, distance=FAR,
                ray_dirs=None, bins=None, want_voxel: bool = True,
                band_row0: int = 0, band_rows: int | None = None):
    """Rasterize the box soup for one camera: per-pixel nearest hit.

    box_lo/box_size int32 (M, 3), box_attr float32 (M, 4) (``soup_to_device``);
    cam_pos (3,) and cam_basis (3, 3); distance: scalar far cap (strict,
    unlike the traversal's advisory one). ``ray_dirs``: optional (H, W, 3)
    jittered unit directions replacing the pixel-center rays, or (k, H, W,
    3) for k jitter samples of the same pose resolved in one pass (bit
    for bit k separate casts); outputs then carry the leading k axis when
    k > 1. ``bins``: the pose's ``raster_bins`` (jittered when
    ``ray_dirs`` is given). ``band_row0``/``band_rows`` (both multiples
    of TILE): resolve only the frame rows [band_row0, band_row0 +
    band_rows), a contiguous run of the row-major tiles, against the
    full-frame ``bins`` (the voxtracer/kernels/raster.py band selection);
    ``ray_dirs`` and the outputs are then band-shaped (band_rows rows,
    rows past the frame's edge included), and ``fb_tiles`` keep the
    frame's tile ids.

    Returns a dict: hit (..., H, W) bool, t (0 on a miss), normal (...,
    3), rgb (..., 3); with ``want_voxel`` also node (..., H, W) int32, the
    winner's leaf slot (-1 on a miss), and voxel (..., 3) int32, the hit
    voxel (the entry point floored in mirrored space and clamped to the
    box, the entry axis on the hit plane; 0 on a miss); the counters
    n_pair, n_near, n_tier, n_widen (tiles entering each widen round) and
    n_fallback; fb_tiles (F,) the tiles
    still not provably complete, fb_need (F, k*64) the rays among them
    that need a re-cast (``apply_fallback``) and fb_tmin (F,) each such
    tile's nearest unfolded distance bound: a needy ray's hit is provably
    no nearer (``apply_fallback_hf`` resumes its walk there).
    """
    dev = box_lo.device
    TW = -(-W // TILE)
    TH = -(-H // TILE)
    NT = TW * TH
    i32 = torch.int32
    cam_np = _host_vec(cam_pos)
    basis = torch.as_tensor(cam_basis, dtype=torch.float32).to(dev)
    if bins is None:
        bins = raster_bins(box_lo, box_size, box_attr, cam_np, basis,
                           tree_height, W, H, jittered=ray_dirs is not None)
    DB = bins["dmin_bits"]
    spairs, seg_start, K = bins["spairs"], bins["seg_start"], bins["cand_k"]
    if band_rows is None:
        t0, TB, HB = 0, TH, H
    else:
        if band_row0 % TILE or band_rows % TILE or not 0 < band_rows \
                or not 0 <= band_row0 <= TH * TILE - band_rows:
            raise ValueError(f"raster_cast: band rows [{band_row0}, "
                             f"{band_row0 + band_rows}) are not whole tiles "
                             f"of the {TH * TILE}-row tiled frame")
        t0, TB, HB = band_row0 // TILE * TW, band_rows // TILE, band_rows
        spairs, seg_start = _band_records(bins, t0, TW * TB)
    NTA = TW * TB  # the tiles this call resolves

    if ray_dirs is None and band_rows is None \
            and bins["center_rays"] is not None:
        d_t, ok_t, d_pad = bins["center_rays"]
    else:
        d_t, ok_t, d_pad = tile_rays(basis, W, H, ray_dirs, band_row0,
                                     band_rows)
    KS = d_pad.shape[0]
    R = KS * TILE * TILE

    tb = torch.full((NTA, R), torch.inf, device=dev)
    plb = torch.full((NTA, R), -1, dtype=i32, device=dev)
    rgbb = torch.zeros((NTA, R, 3), device=dev)
    # near pre-pass: one shared list against every tile
    n_near = bins["near_rows"].shape[0]
    if n_near:
        tb, plb, rgbb = resolve_fold(
            tb, plb, rgbb, bins["near_rows"],
            torch.ones(n_near, dtype=torch.bool, device=dev), d_t, cam_np,
            tree_height, distance)

    def fold(tiles, start, k):
        """Fold the next k records of the listed tiles (None: all) into
        the carry, in place. Returns per listed tile its farthest resolved
        t and the distance bound of its first record not folded."""
        return resolve_fold_seg(tb, plb, rgbb, spairs, tiles, start, k, DB,
                                bins["quantum"], d_t, ok_t, cam_np,
                                tree_height, distance)

    def still_open(wl):
        """The tiles of the list ``wl`` (None: all) with an unfolded
        record nearer than their farthest resolved t, and those tiles'
        bounds."""
        global host_reads
        host_reads += 1
        sub = torch.nonzero(drop < tile_max).squeeze(1)
        return (sub if wl is None else wl[sub]), drop[sub]

    tile_max, drop = fold(None, seg_start, K)

    # ---- widen rounds: every open tile folds the next records of its
    # segment. A tile that is complete stays so, so the open list only
    # shrinks and every listed tile has consumed the same count.
    consumed = K
    n_widen = []
    wl = None
    for k_extra in WIDEN_K:
        wl, _ = still_open(wl)
        n_widen.append(int(wl.numel()))
        if not n_widen[-1]:
            break
        tile_max, drop = fold(wl.to(i32), seg_start[wl] + consumed, k_extra)
        consumed += k_extra
    n_widen += [0] * (3 - len(n_widen))

    # ---- what is still open goes to the exact per-ray fallback; a ray
    # nearer than its tile's nearest dropped bound is complete already
    fb, fb_drop = still_open(wl) if n_widen[-1] else (wl[:0], drop[:0])
    fb_need = tb[fb] >= fb_drop[:, None]

    # ---- untile
    HP, WP = TB * TILE, TW * TILE

    def untile(a):
        rest = a.shape[2:]
        return a.reshape((TB, TW, KS, TILE, TILE) + rest).permute(
            (2, 0, 3, 1, 4) + tuple(range(5, 5 + len(rest)))).reshape(
            (KS, HP, WP) + rest)[:, :HB, :W]

    t_px, pl_px, rgb_px = untile(tb), untile(plb), untile(rgbb)
    hit = torch.isfinite(t_px) & (pl_px >= 0)
    axis = torch.where(hit, pl_px & 3, 3)
    rgb = torch.where(hit[..., None], rgb_px, 0.0)
    d_flat = d_pad[:, :HB, :W]
    axes = torch.arange(3, dtype=i32, device=dev)
    normal = torch.where((axis[..., None] == axes) & hit[..., None],
                         -torch.sign(d_flat), 0.0)
    t_out = torch.where(hit, t_px, 0.0)
    squeeze = (lambda a: a[0]) if KS == 1 else (lambda a: a)
    out = dict(
        hit=squeeze(hit), t=squeeze(t_out), normal=squeeze(normal),
        rgb=squeeze(rgb), n_pair=bins["n_pair"], n_near=n_near,
        n_tier=bins["n_tier"], n_widen=n_widen, n_fallback=int(fb.numel()),
        fb_tiles=(fb + t0).to(i32), fb_need=fb_need, fb_tmin=fb_drop,
    )
    if want_voxel:
        node, voxel = _winner_voxel(box_lo, box_size, box_attr, cam_np,
                                    tree_height, hit, pl_px, t_px, axis,
                                    d_flat)
        out.update(node=squeeze(node), voxel=squeeze(voxel))
    return out


def _winner_voxel(box_lo, box_size, box_attr, cam_np, tree_height: int, hit,
                  pl_px, t_px, axis, d):
    """Each pixel's winning box (``pl_px >> 2``) as its leaf id and its
    hit voxel: the entry point floored in mirrored space and clamped to
    the box, the entry axis on the hit plane, then un-mirrored."""
    owner = torch.where(hit, pl_px >> 2, 0).long()
    node = torch.where(
        hit, box_attr[:, 0].contiguous().view(torch.int32)[owner], -1)
    wlo = box_lo[owner].to(torch.float32)
    whi = wlo + box_size[owner].to(torch.float32)
    bound = float(1 << tree_height)
    cam = torch.as_tensor(cam_np, device=d.device)
    flip = d < 0.0
    dd = torch.clamp_min(torch.abs(d), EPS)
    s0 = torch.where(flip, bound - cam, cam)
    mlo = torch.where(flip, bound - whi, wlo)
    mhi = torch.where(flip, bound - wlo, whi)
    pm = s0 + dd * t_px[..., None]
    vox = torch.minimum(torch.maximum(torch.floor(pm), mlo), mhi - 1.0)
    axes = torch.arange(3, dtype=torch.int32, device=d.device)
    vox = torch.where(axis[..., None] == axes, mlo, vox).to(torch.int32)
    voxel = torch.where(flip, (1 << tree_height) - vox - 1, vox)
    return node, torch.where(hit[..., None], voxel, 0)


def _fb_expand(res, basis, W: int, H: int, ray_dirs, band_row0: int = 0):
    """raster_cast's fallback tiles as rays: ``(fd, need, put)`` with
    ``fd`` (F, k*64, 3) the directions in raster_cast's tile layout,
    ``need`` the re-cast mask and ``put(dst, src)`` scattering re-cast
    lanes into the frame arrays. A banded ``res`` (``band_row0``) keeps
    the frame's tile ids while its arrays and ``ray_dirs`` hold the band's
    rows; lanes of rows past the frame's edge are cast, never put."""
    KS = res["hit"].shape[0] if res["hit"].dim() == 3 else 1
    HB = res["hit"].shape[-2]  # the band's rows (H for the whole frame)
    P = W * HB
    PF = KS * P
    TW = -(-W // TILE)
    fb = res["fb_tiles"]
    F = fb.shape[0]
    dev = fb.device
    fty = torch.div(fb, TW, rounding_mode="floor")
    ftx = fb - fty * TW
    lane = torch.arange(TILE * TILE, dtype=torch.int32, device=dev)[None, :]
    fpx = ftx[:, None] * TILE + lane % TILE
    fpy = fty[:, None] * TILE + torch.div(lane, TILE, rounding_mode="floor")
    if ray_dirs is None:
        fd = _ray_dirs_for_pixels(torch.clamp_max(fpx, W - 1),
                                  torch.clamp_max(fpy, H - 1), basis, W,
                                  H)[:, None]
    else:
        rd = ray_dirs.to(torch.float32)
        if rd.dim() == 3:
            rd = rd[None]
        fd = rd[:, torch.clamp(fpy - band_row0, 0, HB - 1).long(),
                torch.clamp_max(fpx, W - 1).long()].permute(1, 0, 2, 3)
    fd = fd.reshape(F, -1, 3)
    need = res["fb_need"]
    fpy_l = fpy - band_row0  # the band's rows
    pid_tile = torch.where((fpx < W) & (fpy < H) & (fpy_l >= 0)
                           & (fpy_l < HB), fpy_l * W + fpx, -1)
    kk = torch.arange(KS, dtype=torch.int32, device=dev)[None, :, None]
    need3 = need.reshape(F, KS, TILE * TILE)
    fpid = torch.where(need3 & (pid_tile[:, None, :] >= 0),
                       kk * P + pid_tile[:, None, :], PF).reshape(-1).long()

    def put(dst, src):
        trailing = tuple(dst.shape[3:] if KS > 1 else dst.shape[2:])
        flat = dst.reshape((PF,) + trailing)
        padded = torch.cat([flat, flat.new_zeros((1,) + trailing)])
        padded[fpid] = src.reshape((F * KS * TILE * TILE,) + trailing)
        return padded[:PF].reshape(dst.shape)

    return fd, need, put


def apply_fallback(res, table, root: int, tree_height: int, cam_pos,
                   cam_basis, W: int, H: int, distance=FAR, ray_dirs=None,
                   band_row0: int = 0):
    """Exact per-ray re-resolve of the rays ``raster_cast`` could not
    prove complete, with the SVO cast (K2), merged into its result. A
    banded ``res`` passes its ``band_row0``."""
    basis = torch.as_tensor(cam_basis, dtype=torch.float32).to(table.device)
    fd, need, put = _fb_expand(res, basis, W, H, ray_dirs, band_row0)
    cam = torch.as_tensor(_host_vec(cam_pos), device=table.device)
    fr = svo_raycast(table, root, tree_height, cam, fd, distance=distance,
                     active=need)
    # the traversal's cap is advisory: enforce it strictly here
    fb_hit = fr["hit"] & (fr["t"] <= distance) & need
    keep = fb_hit[..., None].to(torch.float32)
    out = dict(res)
    out["hit"] = put(res["hit"], fb_hit)
    out["t"] = put(res["t"], torch.where(fb_hit, fr["t"], 0.0))
    out["normal"] = put(res["normal"], fr["normal"] * keep)
    out["rgb"] = put(res["rgb"], leaf_rgb(table, fr["node"]) * keep)
    if "node" in res:
        out["node"] = put(res["node"], torch.where(fb_hit, fr["node"], -1))
        out["voxel"] = put(res["voxel"], fr["voxel"] * fb_hit[..., None])
    return out


def apply_fallback_hf(res, hf_mips, hf_offsets: tuple, tree_height: int,
                      cam_pos, cam_basis, W: int, H: int, terrain_rgb,
                      terrain_node: int = -1, distance=FAR, ray_dirs=None,
                      band_row0: int = 0):
    """``apply_fallback`` on the heightfield walk (K4) instead of the SVO
    cast: exact on UNEDITED terrain, where the two agree lane for lane and
    every hit has the one terrain colour. Each tile's walk resumes two
    voxels before its nearest unfolded distance bound (``fb_tmin``): a
    needy ray's hit is provably no nearer, and the slack keeps the
    resume strictly in air. With ``want_voxel`` outputs, a re-cast hit's
    ``node`` is ``terrain_node`` (the JAX package's default -1; parity
    callers pass the world's terrain leaf). A banded ``res`` passes its
    ``band_row0``."""
    dev = hf_mips.device
    basis = torch.as_tensor(cam_basis, dtype=torch.float32).to(dev)
    fd, need, put = _fb_expand(res, basis, W, H, ray_dirs, band_row0)
    cam = torch.as_tensor(_host_vec(cam_pos), device=dev)
    t_min = torch.clamp_min(res["fb_tmin"][:, None] - 2.0, 0.0)
    fr = hf_raycast(hf_mips, hf_offsets, tree_height, cam, fd,
                    distance=distance, active=need, t_min=t_min)
    fb_hit = fr["hit"] & (fr["t"] <= distance) & need
    keep = fb_hit[..., None].to(torch.float32)
    trgb = torch.as_tensor(terrain_rgb, dtype=torch.float32).to(dev)
    out = dict(res)
    out["hit"] = put(res["hit"], fb_hit)
    out["t"] = put(res["t"], torch.where(fb_hit, fr["t"], 0.0))
    out["normal"] = put(res["normal"], fr["normal"] * keep)
    out["rgb"] = put(res["rgb"], trgb * keep)
    if "node" in res:
        out["node"] = put(res["node"], torch.where(fb_hit, terrain_node, -1)
                          .to(torch.int32))
        out["voxel"] = put(res["voxel"], fr["voxel"] * fb_hit[..., None])
    return out


def raster_cast_exact(box_lo, box_size, box_attr, cam_pos, cam_basis,
                      tree_height: int, W: int, H: int, table=None,
                      root=None, distance=FAR, ray_dirs=None, bins=None,
                      hf=None, want_voxel: bool = True,
                      terrain_node: int = -1, band_row0: int = 0,
                      band_rows: int | None = None):
    """``raster_cast`` plus the exact per-ray fallback: on the SVO cast
    when the node table is given, on the heightfield walk when ``hf`` =
    (hf_mips, hf_offsets, terrain_rgb) of an UNEDITED terrain world is.
    Then every pixel is the SVO traversal's first hit. ``band_row0``/
    ``band_rows``: one band of the frame (``raster_cast``)."""
    res = raster_cast(box_lo, box_size, box_attr, cam_pos, cam_basis,
                      tree_height, W, H, distance=distance,
                      ray_dirs=ray_dirs, bins=bins, want_voxel=want_voxel,
                      band_row0=band_row0, band_rows=band_rows)
    if not res["n_fallback"]:
        return res
    if hf is not None:
        return apply_fallback_hf(res, hf[0], hf[1], tree_height, cam_pos,
                                 cam_basis, W, H, hf[2],
                                 terrain_node=terrain_node, distance=distance,
                                 ray_dirs=ray_dirs, band_row0=band_row0)
    if table is not None and root is not None:
        res = apply_fallback(res, table, root, tree_height, cam_pos,
                             cam_basis, W, H, distance=distance,
                             ray_dirs=ray_dirs, band_row0=band_row0)
    return res


def raster_primary_frame(box_lo, box_size, box_attr, tree_height: int,
                         cam_pos, cam_basis, sun, W: int, H: int, table=None,
                         root=None, **kw):
    """Shaded primary-visibility frame (software.rs:260-276 shading) on
    the rasterizer: the same image as ``shade.svo_primary_frame``. Pass
    table/root to resolve incomplete tiles exactly."""
    r = raster_cast_exact(box_lo, box_size, box_attr, cam_pos, cam_basis,
                          tree_height, W, H, table=table, root=root,
                          want_voxel=False, **kw)
    sun = torch.as_tensor(sun, dtype=torch.float32).to(box_lo.device)
    lighting = dot(sun, r["normal"]) / 2.0 + 1.0
    return r["rgb"] * lighting[..., None] * r["hit"][..., None]
