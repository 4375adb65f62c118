"""The rasterizer's resolve fold: CUDA kernel K3 (csrc/resolve_fold.cu) and
its plain PyTorch versions.

Counterpart of ``voxtracer/kernels/pallas/resolve.py:resolve_fold`` and
of the XLA fold it stands in for (``voxtracer/kernels/raster.py``
``resolve_scan`` and the near pre-pass): every ray of a raster tile folds
K candidate boxes into its best-hit carry ``(t, pl = owner << 2 | entry
axis, rgb)`` by the traversal's mirrored slab test, strict ``<``, so the
first candidate seen wins a tie.

Candidates are sorted-pair records ``[key, owner, q0, q1, q2, r, g, b]``
(int32 x 8, as ``kernels/raster.py`` packs them). Two entry points:

- ``resolve_fold``: explicit lists beside a validity mask: ``rows`` (N,
  K, 8) with ``valid`` (N, K) gives each tile its own list, ``rows`` (K,
  8) with ``valid`` (K,) one list shared by every tile (the near
  pre-pass). Returns the folded carry as new tensors.
- ``resolve_fold_seg``: the sorted pair array itself, a list of tiles and
  each tile's first record; every listed tile folds the next ``k``
  records of its segment (reads clamp at the last record; a record is
  valid when its key ``>> db`` is the tile) into the full-frame carry, in
  place; per listed tile the max of t over real pixels and the distance
  bound of its next record come back. Nothing is gathered: this is the
  form ``raster_cast`` runs.

Each wrapper takes the kernel for CUDA tensors and its plain version for
CPU tensors; there is no fallback between them.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtracer_torch.kernels import build
from voxtracer_torch.utils import profiling

EPS = 1.0e-6  # raytrace.wgsl:53
# the plain version evaluates this many (tile, candidate, ray) slab tests
# per vectorised step
PLAIN_BLOCK = 1 << 22


def decode(rows):
    """Sorted-pair records (..., 8) -> (lo, hi, rgb) (..., 3) float32 and
    pl (...,) int32 = owner << 2. Coordinates and extents are whole
    numbers below 2^16 in 16-bit fields, so they decode exactly."""
    q0, q1, q2 = rows[..., 2], rows[..., 3], rows[..., 4]
    low = lambda a: a & 0xFFFF  # noqa: E731
    high = lambda a: (a >> 16) & 0xFFFF  # noqa: E731
    lo = torch.stack([low(q0), high(q0), low(q1)], dim=-1).to(torch.float32)
    size = torch.stack([high(q1), low(q2), high(q2)], dim=-1).to(torch.float32)
    rgb = rows[..., 5:8].contiguous().view(torch.float32)
    return lo, lo + size, rgb, rows[..., 1] << 2


def mirrored_slab(lo, hi, cam_pos, d, tree_height: int, distance):
    """Exact ray/AABB test in the traversal's mirrored arithmetic
    (``voxtracer/kernels/raster.py:_mirrored_slab``).

    lo/hi: (..., 3) box corners (float32 whole numbers); cam_pos (3,);
    d: (..., 3). Returns (t, axis, hit): entry t (inf on a miss), entry
    axis (0/1/2, x > y > z on ties, raytrace.wgsl:84-91) and the hit mask
    with the t == 0 inside-a-solid skip applied (raytrace.wgsl:124-127).
    """
    bound = float(1 << tree_height)
    flip = d < 0.0
    dd = torch.clamp_min(torch.abs(d), EPS)
    inv_d = torch.div(torch.ones_like(dd), dd)
    s0 = torch.where(flip, bound - cam_pos, cam_pos)
    mlo = torch.where(flip, bound - hi, lo)
    mhi = torch.where(flip, bound - lo, hi)
    t_in_ax = (mlo - s0) * inv_d
    t_out_ax = (mhi - s0) * inv_d
    t_in = torch.clamp_min(torch.amax(t_in_ax, dim=-1), 0.0)
    t_out = torch.clamp_max(torch.amin(t_out_ax, dim=-1), distance)
    hit = (t_in < t_out) & (t_in > 0.0)
    ax_x = t_in_ax[..., 0] == t_in
    ax_y = ~ax_x & (t_in_ax[..., 1] == t_in)
    axis = torch.where(ax_x, 0, torch.where(ax_y, 1, 2)).to(torch.int32)
    t = torch.where(hit, t_in, torch.inf)
    return t, axis, hit


def _check(t, pl, rgb, rows, valid, d):
    """Shapes of one fold: (N tiles, R rays, K candidates, shared)."""
    if t.dim() != 2:
        raise ValueError("resolve_fold: t must be (N, R)")
    N, R = t.shape
    shared = rows.dim() == 2
    K = rows.shape[-2]
    want = {
        "t": (t, torch.float32, (N, R)),
        "pl": (pl, torch.int32, (N, R)),
        "rgb": (rgb, torch.float32, (N, R, 3)),
        "rows": (rows, torch.int32, (K, 8) if shared else (N, K, 8)),
        "valid": (valid, torch.bool, (K,) if shared else (N, K)),
        "d": (d, torch.float32, (N, R, 3)),
    }
    for name, (x, dtype, shape) in want.items():
        if x.device != t.device or x.dtype != dtype or tuple(x.shape) != shape:
            raise ValueError(f"resolve_fold: {name} must be {dtype} {shape} on "
                             f"{t.device}, got {x.dtype} {tuple(x.shape)} on "
                             f"{x.device}")
    return N, R, K, shared


def resolve_fold(t, pl, rgb, rows, valid, d, cam_pos, tree_height: int,
                 distance: float):
    """Fold candidate records into the best-hit carry.

    t (N, R) float32, pl (N, R) int32, rgb (N, R, 3) float32: the carry
    (inf / -1 / 0 where nothing was hit yet); rows/valid: the candidates
    (module doc); d (N, R, 3) float32 ray directions; cam_pos: the ray
    origin, three float32 values; distance: scalar far cap (strict).
    Returns the folded carry (t, pl, rgb) as new tensors.
    """
    N, R, K, shared = _check(t, pl, rgb, rows, valid, d)
    if t.device.type == "cpu":
        return resolve_fold_plain(t, pl, rgb, rows, valid, d, cam_pos,
                                  tree_height, distance)
    if t.device.type != "cuda":
        raise ValueError(f"resolve_fold: unsupported device {t.device}")
    if N == 0 or R == 0 or K == 0:
        return t.clone(), pl.clone(), rgb.clone()
    t, pl, rgb, rows, valid, d = (x.contiguous()
                                  for x in (t, pl, rgb, rows, valid, d))
    if rows.data_ptr() % 16:  # the kernel reads whole records
        rows = rows.clone()
    t_out, pl_out, rgb_out = (torch.empty_like(x) for x in (t, pl, rgb))
    cam = np.asarray(cam_pos, np.float32).reshape(3)
    lib = build.library()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.voxt_resolve_fold(
            t.data_ptr(), pl.data_ptr(), rgb.data_ptr(), rows.data_ptr(),
            valid.data_ptr(), 0 if shared else K, d.data_ptr(),
            float(cam[0]), float(cam[1]), float(cam[2]),
            float(1 << tree_height), float(np.float32(distance)),
            t_out.data_ptr(), pl_out.data_ptr(), rgb_out.data_ptr(), N, R, K,
            0, 0, stream)  # the launcher picks its grid
    build.check(err, "resolve_fold")
    profiling.count("launches.resolve_fold")
    return t_out, pl_out, rgb_out


def resolve_fold_plain(t, pl, rgb, rows, valid, d, cam_pos, tree_height: int,
                       distance: float):
    """Plain PyTorch version of K3, on any device, same arithmetic.

    A sequential strict-< fold keeps the carry unless some candidate's t
    is below it, and then takes the first candidate with the least t;
    so a block of candidates folds as one ``argmin`` (first index on
    ties) against the carry, and blocks fold in order.
    """
    N, R, K, shared = _check(t, pl, rgb, rows, valid, d)
    dev = t.device
    cam = torch.as_tensor(np.asarray(cam_pos, np.float32).reshape(3),
                          device=dev)
    if shared:
        rows = rows.expand(N, K, 8)
        valid = valid.expand(N, K)
    step = max(1, min(K, PLAIN_BLOCK // max(1, N * R)))
    for c0 in range(0, K, step):
        lo, hi, crgb, cpl = decode(rows[:, c0:c0 + step])  # (N, C, ...)
        cpl = torch.where(valid[:, c0:c0 + step], cpl, -4)
        tc, axis, hit = mirrored_slab(lo[:, :, None], hi[:, :, None], cam,
                                      d[:, None], tree_height,
                                      float(np.float32(distance)))
        hit = hit & (cpl >= 0)[:, :, None]
        tc = torch.where(hit, tc, torch.inf)  # (N, C, R)
        best = torch.argmin(tc, dim=1)  # (N, R), first index on ties
        t_k = torch.gather(tc, 1, best[:, None]).squeeze(1)
        ax_k = torch.gather(axis, 1, best[:, None]).squeeze(1)
        pl_k = torch.gather(cpl, 1, best) + ax_k
        rgb_k = torch.gather(crgb, 1, best[..., None].expand(N, R, 3))
        better = t_k < t
        t = torch.where(better, t_k, t)
        pl = torch.where(better, pl_k, pl)
        rgb = torch.where(better[..., None], rgb_k, rgb)
    return t, pl, rgb


def seg_rows(spairs, starts, size: int):
    """``size`` consecutive records from each start, clamped to the last
    record: (S, size, 8)."""
    pos = starts[:, None] + torch.arange(size, dtype=starts.dtype,
                                         device=starts.device)
    return spairs[torch.clamp_max(pos, spairs.shape[0] - 1).long()]


def dequant(key, db: int, quantum):
    """Conservative lower bound of a packed key's distance: the quantized
    floor minus one quantum."""
    q = torch.clamp_min((key & ((1 << db) - 1)) - 1, 0)
    return q.to(torch.float32) * quantum


def _check_seg(t, pl, rgb, spairs, tiles, start, k, d, ok):
    """Shapes of one segment fold: (NT tiles, R rays, S listed tiles)."""
    if t.dim() != 2:
        raise ValueError("resolve_fold_seg: t must be (NT, R)")
    if int(k) < 1:
        raise ValueError("resolve_fold_seg: k must be at least 1")
    NT, R = t.shape
    S = NT if tiles is None else tiles.shape[0]
    want = {
        "t": (t, torch.float32, (NT, R)),
        "pl": (pl, torch.int32, (NT, R)),
        "rgb": (rgb, torch.float32, (NT, R, 3)),
        "spairs": (spairs, torch.int32, (spairs.shape[0], 8)),
        "start": (start, torch.int32, (S,)),
        "d": (d, torch.float32, (NT, R, 3)),
        "ok": (ok, torch.bool, (NT, R)),
    }
    if tiles is not None:
        want["tiles"] = (tiles, torch.int32, (S,))
    for name, (x, dtype, shape) in want.items():
        if x.device != t.device or x.dtype != dtype or tuple(x.shape) != shape \
                or not x.is_contiguous():
            raise ValueError(f"resolve_fold_seg: {name} must be contiguous "
                             f"{dtype} {shape} on {t.device}, got {x.dtype} "
                             f"{tuple(x.shape)} on {x.device}")
    if spairs.shape[0] == 0:
        raise ValueError("resolve_fold_seg: spairs holds no record")
    return NT, R, S


def resolve_fold_seg(t, pl, rgb, spairs, tiles, start, k: int, db: int,
                     quantum: float, d, ok, cam_pos, tree_height: int,
                     distance: float):
    """Fold the next ``k`` records of each listed tile's segment into the
    full-frame carry, IN PLACE.

    t (NT, R) float32, pl (NT, R) int32, rgb (NT, R, 3) float32: the
    carry of every tile, updated for the listed ones; spairs (PAIRS, 8)
    int32 the sorted pair array; tiles (S,) int32 the listed tiles, each
    at most once, or None for every tile in order; start (S,) int32 each
    listed tile's first record; a record counts when its key ``>> db``
    equals the tile, and reads clamp at the last record; quantum: the
    length one step of a key's low ``db`` bits stands for; d (NT, R, 3)
    directions; ok (NT, R) bool the real pixels. Returns two (S,) float32
    tensors: per listed tile the max of the folded t over its real pixels
    (-inf when it has none), and the lower bound of the distance of
    record ``start + k``, the first not folded (``dequant`` of its key;
    inf when it is not the tile's). A tile whose bound is not below its
    max is complete.
    """
    NT, R, S = _check_seg(t, pl, rgb, spairs, tiles, start, k, d, ok)
    if t.device.type == "cpu":
        return resolve_fold_seg_plain(t, pl, rgb, spairs, tiles, start, k, db,
                                      quantum, d, ok, cam_pos, tree_height,
                                      distance)
    if t.device.type != "cuda":
        raise ValueError(f"resolve_fold_seg: unsupported device {t.device}")
    tile_max = torch.full((S,), -torch.inf, device=t.device)
    next_dmin = torch.empty((S,), device=t.device)
    if S == 0 or R == 0:
        return tile_max, next_dmin.fill_(torch.inf)
    if spairs.data_ptr() % 16:
        raise ValueError("resolve_fold_seg: spairs must be 16-byte aligned")
    cam = np.asarray(cam_pos, np.float32).reshape(3)
    lib = build.library()
    with torch.cuda.device(t.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.voxt_resolve_fold_seg(
            t.data_ptr(), pl.data_ptr(), rgb.data_ptr(), spairs.data_ptr(),
            spairs.shape[0], None if tiles is None else tiles.data_ptr(),
            start.data_ptr(), S, int(k), int(db), float(np.float32(quantum)),
            d.data_ptr(), ok.data_ptr(), tile_max.data_ptr(),
            next_dmin.data_ptr(), float(cam[0]), float(cam[1]), float(cam[2]),
            float(1 << tree_height), float(np.float32(distance)), R,
            0, 0, stream)  # the launcher picks its grid
    build.check(err, "resolve_fold_seg")
    profiling.count("launches.resolve_fold")
    return tile_max, next_dmin


def resolve_fold_seg_plain(t, pl, rgb, spairs, tiles, start, k: int, db: int,
                           quantum: float, d, ok, cam_pos, tree_height: int,
                           distance: float):
    """Plain PyTorch version of ``resolve_fold_seg``, on any device: it
    gathers each listed tile's records and carry, folds them with
    ``resolve_fold_plain`` and scatters the carry back."""
    NT, R, S = _check_seg(t, pl, rgb, spairs, tiles, start, k, d, ok)
    if S == 0:
        none = torch.full((S,), torch.inf, device=t.device)
        return -none, none
    idx = (torch.arange(NT, device=t.device) if tiles is None
           else tiles.long())
    rows = seg_rows(spairs, start, int(k))
    valid = (rows[..., 0] >> db) == idx[:, None]
    ft, fpl, frgb = resolve_fold_plain(t[idx], pl[idx], rgb[idx], rows, valid,
                                       d[idx], cam_pos, tree_height, distance)
    t[idx], pl[idx], rgb[idx] = ft, fpl, frgb
    key = spairs[torch.clamp_max(start.long() + int(k), spairs.shape[0] - 1),
                 0]
    next_dmin = torch.where((key >> db) == idx,
                            dequant(key, db, float(np.float32(quantum))),
                            torch.inf)
    return (torch.amax(torch.where(ok[idx], ft, -torch.inf), dim=1),
            next_dmin)
