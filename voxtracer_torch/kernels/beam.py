"""Beam-amortized primary visibility and sun shadows: the port of
``voxtracer/kernels/beam.py``, with CUDA kernels K6 (the walk,
``csrc/beam_walk.cu``) and K7 (the resolve, ``csrc/beam_resolve.cu``)
and their plain PyTorch versions.

1. Augmented node rows (``build_aug_table``, host numpy): (N, 40) int32,
   ``[children(8) | child_solid_leaf(8) | child_rgb(8x3)]``.
2. The walk (``beam_walk``): one conservative interval-arithmetic octree
   walk per pixel tile (a beam). Each step expands one interior node: all
   8 children are slab-tested against the beam's origin and direction
   bounds; solid children (solid subtrees included, via ``solid_leaf``)
   become candidate boxes in near-to-far order, interior ones pending
   stack entries. A solid child that provably covers the whole beam caps
   further collection. The walk is resumable: a beam with fewer than 8
   free candidate slots pauses with its pending stack intact, and the
   returned state resumes it for the next K boxes.
3. The resolve (``resolve_candidates``): every ray slab-tests its beam's
   K candidates in the traversal's mirrored space (same EPS clamp, same
   ``(plane - origin) * inv`` expressions as the SVO walk, so t's are the
   walk's crossing t's by bits) and keeps the first nearest; a ray that
   starts inside a solid candidate takes its next unit-grid plane (the
   walk's t == 0 skip). With ``best=``, the round's result goes into a
   running best in place, only where strictly nearer (``_merge``).
4. The frame (``beam_primary_frame_cast``): rounds of walk and resolve
   (the beams' bounds and state made once, each round after the first
   resolved into the first one's result), then the exact per-ray cast
   (K2, ``traverse.svo_raycast``) for the pixels no round confirmed:
   tiles that overflow, run out of steps or straddle a direction-sign
   change.

The reference's one-hot stacks, ``lax.map`` bands and static fallback
capacity (``fb_tiles``) are TPU mechanism and not ported. On the card
eight lanes walk a beam, one an octant, with the pending stack in shared
memory for the call (K6); the resolve tests only the used candidate
slots, staged once a block with their mirrored planes, and a beam without
one touches no candidate (K7); the fallback casts exactly the lanes that
need it.
"""

from __future__ import annotations

import numpy as np
import torch

from voxtracer_torch.core.vecmath import dot, rdiv, to_bits
from voxtracer_torch.kernels import build
from voxtracer_torch.kernels.traverse import EPS, FAR, leaf_rgb, svo_raycast
from voxtracer_torch.utils import profiling

AUG_WIDTH = 40
# near-to-far octant priority (by popcount) in mirrored space
ORDER = (0, 1, 2, 4, 3, 5, 6, 7)
# the walk's pending stacks hold height + 1 levels; the kernel's bit-words
# address levels up to 15
MAX_HEIGHT = 15

# beam steps summed over beams by the plain walk since the last reset
plain_beam_steps = 0
# a list, or None: the plain walk appends the aug row ids it expands
plain_rows = None


def build_aug_table(table_u32: np.ndarray, solid_leaf: np.ndarray) -> np.ndarray:
    """(N, 40) int32 augmented rows from the flat table and solid_leaf
    (``voxtracer/kernels/beam.py:53``): [0:8] child ids (-1 empty); [8:16]
    solid_leaf per child (-1 = interior or mixed); [16:40] each child's
    leaf RGB as float bits."""
    tbl = np.asarray(table_u32).view(np.int32).reshape(-1, 8)
    n = tbl.shape[0]
    aug = np.full((n, AUG_WIDTH), -1, np.int32)
    aug[:, 0:8] = tbl
    # leaf rows carry float bits in their child slots; they are never
    # expanded, but clamp indices so the build stays in bounds
    child = np.clip(tbl, 0, n - 1)
    valid = (tbl >= 0) & (tbl < n)
    sl = np.where(valid, np.asarray(solid_leaf)[child], -1)
    aug[:, 8:16] = sl
    has = sl >= 0
    rgb_bits = tbl[np.clip(sl, 0, n - 1)][..., :3]  # (N, 8, 3)
    rgb_bits = np.where(has[..., None], rgb_bits, 0)
    aug[:, 16:40] = rgb_bits.reshape(n, 24)
    return aug


def _beam_bounds(height: int, o_lo, o_hi, d_lo, d_hi):
    """The walk's per-beam constants, in the mirrored space where every
    direction interval is positive: origin bounds, padded inverse
    direction bounds, the mirror bits and the sign-change flag."""
    bound = float(1 << height)
    flip = d_hi < 0.0
    incoherent = torch.any((d_lo < 0.0) & (d_hi >= 0.0), dim=-1)
    dlo = torch.where(flip, -d_hi, d_lo)
    dhi = torch.where(flip, -d_lo, d_hi)
    dlo = torch.clamp_min(dlo, EPS)  # the per-ray clamp (raytrace.wgsl:78)
    dhi = torch.maximum(dhi, dlo)
    # pad the inverse bounds by a few ulps so the interval brackets every
    # ray's correctly rounded 1/d (collection must stay a superset)
    ilo = rdiv(1.0, dhi) * (1.0 - 4e-7)
    ihi = rdiv(1.0, dlo) * (1.0 + 4e-7)
    olo = torch.where(flip, bound - o_hi, o_lo)
    ohi = torch.where(flip, bound - o_lo, o_hi)
    mirror = to_bits(flip)
    return dict(ilo=ilo.contiguous(), ihi=ihi.contiguous(),
                olo=olo.contiguous(), ohi=ohi.contiguous(),
                mirror=mirror.to(torch.int32).contiguous(),
                incoherent=incoherent.contiguous())


def _initial_state(root: int, height: int, incoherent):
    Bb = incoherent.shape[0]
    dev = incoherent.device
    S = height + 1
    ids_stk = torch.full((Bb, S, 8), -1, dtype=torch.int32, device=dev)
    ids_stk[:, height, 0] = int(root)
    mask_stk = torch.zeros((Bb, S), dtype=torch.int32, device=dev)
    mask_stk[:, height] = 1
    entry_stk = torch.full((Bb, S, 8), FAR, dtype=torch.float32, device=dev)
    entry_stk[:, height, 0] = 0.0
    return dict(
        h=torch.full((Bb,), height, dtype=torch.int32, device=dev),
        ids_stk=ids_stk, mask_stk=mask_stk, entry_stk=entry_stk,
        words=torch.zeros((Bb, 3), dtype=torch.int32, device=dev),
        cap=torch.full((Bb,), FAR, dtype=torch.float32, device=dev),
        alive=(torch.full((Bb,), int(root), device=dev) >= 0) & ~incoherent)


def beam_walk(aug, root: int, height: int, o_lo, o_hi, d_lo, d_hi,
              K: int = 64, max_steps: int = 2048, skip_t0: bool = True,
              state=None):
    """Collect up to K candidate solid boxes per beam
    (``voxtracer/kernels/beam.py:94``).

    aug: (N, 40) int32 rows (``build_aug_table``) on the beams' device;
    o_lo/o_hi, d_lo/d_hi: (Bb, 3) float32 bounds over each beam's origins
    and directions. ``state``: the state a previous call returned, to
    resume its paused beams (it is updated in place and returned).

    Returns (cands, state): cands holds lvl (Bb, K) int32 (-1 unused),
    off (Bb, K, 3) int32 world cell corners, rgb (Bb, K, 3) float32, ok
    (Bb,) the beam was walked to its end, t_safe (Bb,) the nearest entry
    of anything not collected (resolve hits strictly nearer are final).
    """
    f32 = torch.float32
    o_lo, o_hi, d_lo, d_hi = (a.to(f32).reshape(-1, 3)
                              for a in (o_lo, o_hi, d_lo, d_hi))
    pre, state = _walk_setup(root, height, o_lo, o_hi, d_lo, d_hi, K, state)
    return _walk(aug, height, pre, state, K, max_steps, skip_t0), state


def _walk(aug, height, pre, state, K, max_steps, skip_t0):
    """One call of the walk on the beams' bounds ``pre``: K6 for CUDA
    tensors, the plain version for CPU ones."""
    dev = pre["ilo"].device
    if dev.type == "cpu":
        return beam_walk_plain(aug, height, pre, state, K, max_steps,
                               skip_t0)
    if dev.type == "cuda":
        return _beam_walk_cuda(aug, height, pre, state, K, max_steps,
                               skip_t0)
    raise ValueError(f"beam_walk: unsupported device {dev}")


def _beam_walk_cuda(aug, height, pre, state, K, max_steps, skip_t0):
    dev = pre["ilo"].device
    if aug.device != dev or aug.dtype != torch.int32 or aug.dim() != 2 \
            or aug.shape[1] != AUG_WIDTH or not aug.is_contiguous():
        raise ValueError("beam_walk: aug must be a contiguous int32 (N, 40) "
                         f"tensor on {dev}")
    Bb = pre["ilo"].shape[0]
    S = height + 1
    shapes = dict(h=((Bb,), torch.int32), ids_stk=((Bb, S, 8), torch.int32),
                  mask_stk=((Bb, S), torch.int32),
                  entry_stk=((Bb, S, 8), torch.float32),
                  words=((Bb, 3), torch.int32), cap=((Bb,), torch.float32),
                  alive=((Bb,), torch.bool))
    for k, (shape, dtype) in shapes.items():
        a = state[k]
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"beam_walk: state[{k!r}] must be a contiguous "
                             f"{dtype} {shape} tensor on {dev}")
    cands = dict(
        lvl=torch.empty((Bb, K), dtype=torch.int32, device=dev),
        off=torch.empty((Bb, K, 3), dtype=torch.int32, device=dev),
        rgb=torch.empty((Bb, K, 3), dtype=torch.float32, device=dev),
        ok=torch.empty((Bb,), dtype=torch.bool, device=dev),
        t_safe=torch.empty((Bb,), dtype=torch.float32, device=dev))
    if Bb == 0:
        return cands
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.voxt_beam_walk(
            aug.data_ptr(), int(height), pre["olo"].data_ptr(),
            pre["ohi"].data_ptr(), pre["ilo"].data_ptr(),
            pre["ihi"].data_ptr(), pre["mirror"].data_ptr(),
            pre["incoherent"].data_ptr(), int(K), int(max_steps),
            int(bool(skip_t0)), state["h"].data_ptr(),
            state["ids_stk"].data_ptr(), state["mask_stk"].data_ptr(),
            state["entry_stk"].data_ptr(), state["words"].data_ptr(),
            state["cap"].data_ptr(), state["alive"].data_ptr(),
            cands["lvl"].data_ptr(), cands["off"].data_ptr(),
            cands["rgb"].data_ptr(), cands["ok"].data_ptr(),
            cands["t_safe"].data_ptr(), Bb, stream)
    build.check(err, "beam_walk")
    profiling.count("launches.beam_walk")
    return cands


def beam_walk_plain(aug, height: int, pre, state, K: int, max_steps: int,
                    skip_t0: bool = True):
    """Plain PyTorch version of K6: the live beams step in lockstep, one
    node expansion (or pop) a step, and leave the live set when they end
    or pause. A beam's steps are its own, so each beam takes the same
    steps as the kernel's thread that walks it alone. Updates ``state`` in
    place and returns the candidates."""
    global plain_beam_steps
    dev = pre["ilo"].device
    Bb = pre["ilo"].shape[0]
    H = height
    i32, f32 = torch.int32, torch.float32
    order = torch.tensor(ORDER, device=dev)
    oct8 = torch.arange(8, device=dev)
    obits8 = torch.stack([oct8 & 1, (oct8 >> 1) & 1, (oct8 >> 2) & 1],
                         -1).to(f32)  # (8, 3)
    flip = ((pre["mirror"][:, None].long() >> torch.arange(3, device=dev))
            & 1) == 1
    h_all, ids_stk, mask_stk = state["h"], state["ids_stk"], state["mask_stk"]
    entry_stk, words_all, cap_all = (state["entry_stk"], state["words"],
                                     state["cap"])
    ncand = torch.zeros((Bb,), dtype=torch.int64, device=dev)
    cand_lvl = torch.full((Bb, K), -1, dtype=i32, device=dev)
    cand_off = torch.zeros((Bb, K, 3), dtype=i32, device=dev)
    cand_rgb = torch.zeros((Bb, K, 3), dtype=f32, device=dev)

    live = torch.nonzero(state["alive"]).squeeze(1)
    for _ in range(max_steps):
        # a beam pauses before an expansion that might not fit its 8
        # emits; its pending bit stays set, so a resumed walk re-picks it
        live = live[ncand[live] <= K - 8]
        if live.numel() == 0:
            break
        plain_beam_steps += live.numel()
        h = h_all[live].long()
        mask = mask_stk[live, h]
        pop = mask == 0
        if pop.any():
            bp = live[pop]
            h_all[bp] = h_all[bp] + 1
            state["alive"][bp[h_all[bp] > H]] = False
        b, h, mask = live[~pop], h[~pop], mask[~pop]
        live = live[state["alive"][live]]
        if b.numel() == 0:
            continue
        # the pending child first in ORDER (mirrored octant)
        j = torch.full_like(mask, 8)
        for o in reversed(ORDER):
            j = torch.where((mask >> o) & 1 == 1, o, j)
        mask_stk[b, h] = mask & ~(1 << j)
        child = ids_stk[b, h, j.long()]
        hc = h.clamp(1, H)
        # enter the child's cell: word bits at level h
        jb = torch.stack([j & 1, (j >> 1) & 1, (j >> 2) & 1], -1)
        bit = (1 << hc).to(i32)[:, None]
        w = words_all[b]
        w = torch.where((h < H)[:, None], (w & ~bit) | (jb * bit).to(i32), w)
        words_all[b] = w

        # expand: one augmented row, the 8 children in mirrored order
        if plain_rows is not None:
            plain_rows.append(child.clamp_min(0))
        row = aug[child.clamp_min(0).long()]  # (E, 40)
        gm = (oct8[None, :] ^ pre["mirror"][b, None].long())  # world slot
        gchild_m = torch.gather(row[:, 0:8], 1, gm)
        gsl_m = torch.gather(row[:, 8:16], 1, gm)
        grgb = row[:, 16:40].reshape(-1, 8, 3)
        grgb_m = torch.gather(grgb, 1, gm[..., None].expand(-1, 8, 3)) \
            .contiguous().view(f32)
        s_g = (1 << (hc - 1)).to(f32)  # grandchild size
        low = ((1 << hc) - 1).to(i32)[:, None]
        cell_off = (w & ~low).to(f32)
        g_off = cell_off[:, None, :] + obits8[None] * s_g[:, None, None]

        ilo, ihi = pre["ilo"][b][:, None, :], pre["ihi"][b][:, None, :]
        olo, ohi = pre["olo"][b][:, None, :], pre["ohi"][b][:, None, :]
        ne_lo = g_off - ohi
        ne_hi = g_off - olo
        e_lo = torch.minimum(ne_lo * ilo, ne_lo * ihi)
        e_hi = torch.maximum(ne_hi * ilo, ne_hi * ihi)
        gx = g_off + s_g[:, None, None]
        nx_lo = gx - ohi
        nx_hi = gx - olo
        x_lo = torch.minimum(nx_lo * ilo, nx_lo * ihi)
        x_hi = torch.maximum(nx_hi * ilo, nx_hi * ihi)
        entry_lo = torch.clamp_min(torch.amax(e_lo, -1), 0.0)  # (E, 8)
        entry_hi = torch.clamp_min(torch.amax(e_hi, -1), 0.0)
        exit_lo = torch.amin(x_lo, -1)
        exit_hi = torch.amin(x_hi, -1)
        cap = cap_all[b]
        overlap = (entry_lo <= exit_hi) & (exit_hi > 0.0) \
            & (entry_lo <= cap[:, None])
        hit_cell = overlap & (gchild_m >= 0)
        emit = hit_cell & (gsl_m >= 0)
        desc = hit_cell & (gsl_m < 0)

        # emit solid children in near-to-far rank order
        emit_r = emit[:, order]
        slot = ncand[b][:, None] + torch.cumsum(emit_r.long(), -1) - 1
        rows_e, ranks = torch.nonzero(emit_r, as_tuple=True)
        if rows_e.numel():
            bs, sl = b[rows_e], slot[rows_e, ranks]
            octs = order[ranks]
            size = (1 << (hc[rows_e] - 1)).to(i32)[:, None]
            off_m = g_off[rows_e, octs].to(i32)
            cand_lvl[bs, sl] = (hc[rows_e] - 1).to(i32)
            cand_off[bs, sl] = torch.where(flip[bs], (1 << H) - off_m - size,
                                           off_m)
            cand_rgb[bs, sl] = grgb_m[rows_e, octs]
        ncand[b] += emit_r.sum(-1)

        # full-beam cover: the nearest solid box every ray passes through
        cover = emit & (entry_hi < exit_lo)
        if skip_t0:
            cover = cover & (entry_lo > 0.0)
        cover_t = torch.amin(torch.where(cover, entry_hi, FAR), -1)
        cap_all[b] = torch.minimum(cap, cover_t)

        # pending interior children one level down
        dmask = torch.sum(torch.where(desc, 1 << oct8, 0), -1).to(i32)
        has = dmask != 0
        if has.any():
            bd, lv = b[has], (hc[has] - 1)
            ids_stk[bd, lv] = gchild_m[has]
            entry_stk[bd, lv] = torch.where(desc[has], entry_lo[has], FAR)
            mask_stk[bd, lv] = dmask[has]
            h_all[bd] = h_all[bd] - 1

    alive = state["alive"]
    ok = ~alive & ~pre["incoherent"]
    bits = 1 << torch.arange(8, device=dev, dtype=i32)
    pend = (mask_stk[..., None] & bits) != 0  # (Bb, S, 8)
    pend_min = torch.amin(torch.where(pend, entry_stk, FAR).reshape(Bb, -1),
                          -1) if Bb else torch.zeros(0, device=dev)
    t_safe = torch.where(pre["incoherent"], 0.0,
                         torch.where(ok, FAR, pend_min))
    return dict(lvl=cand_lvl, off=cand_off, rgb=cand_rgb, ok=ok,
                t_safe=t_safe)


def resolve_candidates(cand_lvl, cand_off, cand_rgb, origin, dirs,
                       height: int, skip_t0: bool = True, best=None):
    """Nearest-candidate slab resolve (``voxtracer/kernels/beam.py:369``).

    cand_*: (Bb, K[, 3]) from ``beam_walk``; origin: (3,) shared by every
    ray, or (Bb, P, 3) a ray; dirs: (Bb, P, 3) unit directions grouped by
    beam. Returns a dict of (Bb, P[, 3]): hit, t, normal, rgb, voxel.
    ``best``: such a dict of an earlier round, updated in place where this
    round's hit is strictly nearer (``_merge``) and returned.
    """
    f32 = torch.float32
    dirs = dirs.to(f32).contiguous()
    origin = torch.as_tensor(origin, dtype=f32, device=dirs.device)
    if origin.dim() != 1:
        origin = origin.expand(dirs.shape).contiguous()
    if dirs.device.type == "cpu":
        return resolve_candidates_plain(cand_lvl, cand_off, cand_rgb, origin,
                                        dirs, height, skip_t0, best)
    if dirs.device.type == "cuda":
        return _resolve_cuda(cand_lvl, cand_off, cand_rgb, origin, dirs,
                             height, skip_t0, best)
    raise ValueError(f"resolve_candidates: unsupported device {dirs.device}")


RESOLVE_KEYS = dict(hit=((), torch.bool), t=((), torch.float32),
                    normal=((3,), torch.float32), rgb=((3,), torch.float32),
                    voxel=((3,), torch.int32))


def _resolve_cuda(cand_lvl, cand_off, cand_rgb, origin, dirs, height,
                  skip_t0, best=None):
    dev = dirs.device
    Bb, P, _ = dirs.shape
    K = cand_lvl.shape[1]
    for name, a, dtype, shape in (("lvl", cand_lvl, torch.int32, (Bb, K)),
                                  ("off", cand_off, torch.int32, (Bb, K, 3)),
                                  ("rgb", cand_rgb, torch.float32,
                                   (Bb, K, 3))):
        if a.device != dev or a.dtype != dtype or tuple(a.shape) != shape \
                or not a.is_contiguous():
            raise ValueError(f"resolve_candidates: cand {name} must be a "
                             f"contiguous {dtype} {shape} tensor on {dev}")
    if P > 1024:
        raise ValueError("resolve_candidates: at most 1024 rays a beam")
    if best is None:
        out = {k: torch.empty((Bb, P, *tail), dtype=dtype, device=dev)
               for k, (tail, dtype) in RESOLVE_KEYS.items()}
    else:
        for k, (tail, dtype) in RESOLVE_KEYS.items():
            a = best[k]
            if a.device != dev or a.dtype != dtype \
                    or tuple(a.shape) != (Bb, P, *tail) \
                    or not a.is_contiguous():
                raise ValueError(f"resolve_candidates: best[{k!r}] must be "
                                 f"a contiguous {dtype} {(Bb, P, *tail)} "
                                 f"tensor on {dev}")
        out = best
    if Bb == 0 or P == 0:
        return out
    lib = build.library()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.voxt_beam_resolve(
            cand_lvl.data_ptr(), cand_off.data_ptr(), cand_rgb.data_ptr(),
            origin.data_ptr(), int(origin.dim() != 1), dirs.data_ptr(),
            int(height), int(bool(skip_t0)), int(best is not None),
            out["hit"].data_ptr(),
            out["t"].data_ptr(), out["normal"].data_ptr(),
            out["rgb"].data_ptr(), out["voxel"].data_ptr(), Bb, P, K, stream)
    build.check(err, "resolve_candidates")
    profiling.count("launches.beam_resolve")
    return out


def resolve_candidates_plain(cand_lvl, cand_off, cand_rgb, origin, dirs,
                             height: int, skip_t0: bool = True, best=None):
    """Plain PyTorch version of K7: a running minimum over the K
    candidates with a strict ``<`` (the first nearest wins, as JAX's
    argmin), then the winner's attributes; with ``best``, merged into it
    in place (``_merge``)."""
    f32 = torch.float32
    d = dirs
    Bb, P, _ = d.shape
    K = cand_lvl.shape[1]
    bound = float(1 << height)
    o_w = origin.expand(d.shape)
    flip = d < 0.0
    d_sign = torch.sign(d)
    dm = torch.clamp_min(torch.abs(d), EPS)
    inv = rdiv(1.0, dm)
    o = torch.where(flip, bound - o_w, o_w)  # mirrored origin

    # unit-grid crossing from the origin (the inside-a-solid skip rule)
    plane = torch.floor(o) + 1.0
    tu_k = (plane - o) * inv
    tu = torch.amin(tu_k, -1)
    ua = tu_k[..., 0] == tu
    ub = ~ua & (tu_k[..., 1] == tu)
    uc = ~ua & ~ub & (tu_k[..., 2] == tu)
    uaxis = torch.stack([ua, ub, uc], -1)
    plane_a = torch.sum(torch.where(uaxis, plane, 0.0), -1)

    present = cand_lvl >= 0
    size = torch.where(present, (1 << cand_lvl.clamp_min(0)).to(f32),
                       0.5)[..., None]  # 2^lvl, as exp2(-1) for unused
    lo = cand_off.to(f32)
    hi = lo + size

    def slab(k_lo, k_hi, k_present):
        """(Bb, P) scores of one candidate per ray, and its planes."""
        near = torch.where(flip, bound - k_hi, k_lo)
        far = torch.where(flip, bound - k_lo, k_hi)
        e = (near - o) * inv
        x = (far - o) * inv
        entry = torch.amax(e, -1)
        exit_ = torch.amin(x, -1)
        entry_eff = torch.clamp_min(entry, 0.0)
        valid = k_present & (entry <= exit_) & (exit_ > 0)
        if skip_t0:
            valid = valid & (entry_eff > 0.0)
        score = torch.where(valid, entry_eff, FAR)
        if skip_t0:
            far_a = torch.sum(torch.where(uaxis, far, 0.0), -1)
            special = (k_present & (entry <= 0.0) & (exit_ > 0.0)
                       & (entry < exit_) & (plane_a + 1.0 <= far_a))
            score2 = torch.where(special, tu, FAR)
        else:
            score2 = torch.full_like(score, FAR)
        return score, score2, e, near, far

    best_t = torch.full((Bb, P), FAR, dtype=f32, device=d.device)
    arg = torch.zeros((Bb, P), dtype=torch.int64, device=d.device)
    for k in range(K):
        score, score2, _, _, _ = slab(lo[:, None, k], hi[:, None, k],
                                      present[:, None, k])
        sc = torch.minimum(score, score2)
        take = sc < best_t
        best_t = torch.where(take, sc, best_t)
        arg = torch.where(take, k, arg)
    t = best_t
    hit = t < FAR

    pick = lambda a: torch.gather(a, 1, arg[..., None].expand(-1, -1, 3)) \
        if a.dim() == 3 else torch.gather(a, 1, arg)
    score_b, score2_b, e_b, near_b, far_b = slab(pick(lo), pick(hi),
                                                 pick(present))
    rgb = pick(cand_rgb)
    was_special = score2_b < score_b
    ax = e_b[..., 0] == t
    ay = ~ax & (e_b[..., 1] == t)
    az = ~ax & ~ay & (e_b[..., 2] == t)
    axis3 = torch.stack([ax, ay, az], -1)
    axis3 = torch.where(was_special[..., None], uaxis, axis3)
    hitf = hit[..., None].to(f32)
    normal = torch.where(axis3, -d_sign, 0.0) * hitf
    rgb = rgb * hitf

    # the hit's integer voxel: mirrored face plane -> world voxel
    p_hit = o + dm * t[..., None]
    vox_m = torch.minimum(torch.maximum(torch.floor(p_hit), near_b),
                          far_b - 1.0)
    face = torch.where(was_special[..., None], plane, near_b)
    vox_m = torch.where(axis3, face, vox_m)
    vox = torch.where(flip, bound - vox_m - 1.0, vox_m).to(torch.int32)
    vox = torch.where(hit[..., None], vox, 0)
    res = dict(hit=hit, t=torch.where(hit, t, 0.0), normal=normal, rgb=rgb,
               voxel=vox)
    if best is None:
        return res
    for k, v in _merge(best, res).items():
        best[k].copy_(v)
    return best


def _walk_setup(root, height, o_lo, o_hi, d_lo, d_hi, K, state=None):
    """The beams' bounds and, without a ``state`` to resume, the walk's
    initial state; the round loops make both once a frame."""
    if not 1 <= height <= MAX_HEIGHT:
        raise ValueError(f"beam_walk: height {height} outside [1, "
                         f"{MAX_HEIGHT}]")
    if K < 8:
        raise ValueError("beam_walk: K must be at least 8")
    pre = _beam_bounds(height, o_lo, o_hi, d_lo, d_hi)
    if state is None:
        state = _initial_state(root, height, pre["incoherent"])
    return pre, state


def _group(a, tile: int):
    """(H, W, ...) -> (tiles, tile * tile, ...) in row-major tile order."""
    Hp, Wp = a.shape[:2]
    ty, tx = Hp // tile, Wp // tile
    extra = a.shape[2:]
    return a.reshape(ty, tile, tx, tile, *extra).transpose(1, 2).reshape(
        ty * tx, tile * tile, *extra)


def _ungroup(a, ty: int, tx: int, tile: int):
    extra = a.shape[2:]
    return a.reshape(ty, tx, tile, tile, *extra).transpose(1, 2).reshape(
        ty * tile, tx * tile, *extra)


def _merge(best, res):
    """Round results in order: a later round takes a pixel only with a
    strictly nearer hit."""
    bk = torch.where(best["hit"], best["t"], FAR)
    rk = torch.where(res["hit"], res["t"], FAR)
    take = rk < bk
    out = dict(hit=best["hit"] | res["hit"],
               t=torch.where(take, res["t"], best["t"]))
    for k in ("normal", "voxel", "rgb"):
        out[k] = torch.where(take[..., None], res[k], best[k])
    return out


# the last frame's fallback work, for the smoke's report: rounds walked,
# tiles and pixels that took the per-ray cast
last_frame_stats = {}


def beam_primary_frame_cast(table, aug, root: int, height: int, origin,
                            dirs, tile: int = 8, K: int = 64,
                            max_steps: int = 2048, skip_t0: bool = True,
                            rounds: int = 4):
    """Full-frame primary cast: ``rounds`` of walk and resolve, each
    resuming the paused beams for K more candidates, then the exact
    per-ray cast (K2) for the pixels no round confirmed
    (``voxtracer/kernels/beam.py:478``). dirs: (H, W, 3) unit directions
    from the shared ``origin`` (3,), H and W multiples of ``tile``.
    Returns hit/t/normal/voxel/rgb shaped (H, W[, 3])."""
    Hp, Wp, _ = dirs.shape
    if Hp % tile or Wp % tile:
        raise ValueError(f"beam_primary_frame_cast: {Wp}x{Hp} is not a "
                         f"multiple of the {tile}-pixel tile")
    ty, tx = Hp // tile, Wp // tile
    dev = dirs.device
    o = torch.as_tensor(np.asarray(origin, np.float32), device=dev) \
        if not torch.is_tensor(origin) else origin.to(dev, torch.float32)
    dt = _group(dirs.to(torch.float32), tile).contiguous()
    ob = o.expand(dt.shape[0], 3)
    pre, state = _walk_setup(root, height, ob, ob, torch.amin(dt, 1),
                             torch.amax(dt, 1), K)
    res = None
    for _ in range(max(rounds, 1)):
        cands = _walk(aug, height, pre, state, K, max_steps, skip_t0)
        res = resolve_candidates(cands["lvl"], cands["off"], cands["rgb"], o,
                                 dt, height, skip_t0=skip_t0, best=res)
    # a pixel is final if its tile was walked to its end, or its hit is
    # strictly nearer than anything the walk left uncollected
    confirmed = cands["ok"][:, None] | (
        res["hit"] & (res["t"] < cands["t_safe"][:, None]))
    need = ~confirmed
    # the per-ray cast only has to search up to the tentative hit (real
    # geometry, possibly not the nearest)
    cap = torch.where(res["hit"], res["t"] * 1.000001 + 1e-4, FAR)
    n_need = int(need.sum())
    last_frame_stats.update(rounds=max(rounds, 1), fallback_pixels=n_need,
                            fallback_tiles=int(need.any(1).sum()),
                            tiles=int(need.shape[0]))
    if n_need:
        fb = svo_raycast(table, root, height, o, dt[need], distance=cap[need],
                         skip_t0=skip_t0)
        take = fb["hit"]
        res["hit"][need] = fb["hit"] | res["hit"][need]
        for k in ("t", "normal", "voxel"):
            cur = res[k][need]
            sel = take if cur.dim() == 1 else take[:, None]
            res[k][need] = torch.where(sel, fb[k], cur)
        cur = res["rgb"][need]
        res["rgb"][need] = torch.where(take[:, None],
                                       leaf_rgb(table, fb["node"]), cur)
    return {k: _ungroup(v, ty, tx, tile) for k, v in res.items()}


def beam_shadow_mask(table, aug, root: int, height: int, origins, active,
                     sun, K: int = 64, max_steps: int = 2048,
                     rounds: int = 2):
    """Beam-amortized any-hit shadow test toward the sun
    (``voxtracer/kernels/beam.py:620``). origins: (Bb, P, 3) shadow
    origins grouped by tile; active: (Bb, P) rays to test; sun: (3,) unit
    direction. One walk a tile with an origin interval (the box of its
    active origins) and a point direction: any candidate hit certifies
    shadowed, a tile walked to its end certifies lit, the rest take the
    per-ray cast (K2). Returns shadowed (Bb, P), False where inactive."""
    f32 = torch.float32
    big = float(1 << height) * 4.0
    act3 = active[..., None]
    o_lo = torch.amin(torch.where(act3, origins, big), 1)
    o_hi = torch.amax(torch.where(act3, origins, -big), 1)
    none = ~torch.any(active, 1)[:, None]
    o_lo = torch.where(none, 0.0, o_lo)
    o_hi = torch.where(none, 0.0, o_hi)
    sun = torch.as_tensor(sun, dtype=f32, device=origins.device)
    sun_b = sun.expand(o_lo.shape)
    sun_p = sun.expand(origins.shape).contiguous()
    shadowed = torch.zeros(active.shape, dtype=torch.bool,
                           device=origins.device)
    pre, state = _walk_setup(root, height, o_lo, o_hi, sun_b, sun_b, K)
    for _ in range(rounds):
        cands = _walk(aug, height, pre, state, K, max_steps, True)
        res = resolve_candidates(cands["lvl"], cands["off"], cands["rgb"],
                                 origins, sun_p, height)
        shadowed = shadowed | (active & res["hit"])
    need = active & ~shadowed & ~cands["ok"][:, None]
    if bool(need.any()):
        fb = svo_raycast(table, root, height, origins[need], sun_p[need],
                         skip_t0=True)
        shadowed[need] = fb["hit"]
    return shadowed


def _lighting(sun, normal):
    return dot(sun, normal) / 2.0 + 1.0


def beam_shadow_frame(table, aug, root: int, height: int, origin, dirs, sun,
                      tile: int = 8, K: int = 64, max_steps: int = 2048,
                      rounds: int = 4, shadow_eps: float = 1.0e-3):
    """Primary hit, hard sun shadow and sky (``kernels.shade``'s shadow
    shading), beam-amortized end to end (``beam.py:676``)."""
    from voxtracer_torch.kernels.shade import sky_color

    Hp, Wp, _ = dirs.shape
    ty, tx = Hp // tile, Wp // tile
    r = beam_primary_frame_cast(table, aug, root, height, origin, dirs,
                                tile=tile, K=K, max_steps=max_steps,
                                rounds=rounds)
    sun = torch.as_tensor(sun, dtype=torch.float32, device=dirs.device)
    o = torch.as_tensor(np.asarray(origin, np.float32), device=dirs.device)
    p = o + dirs * r["t"][..., None] - dirs * shadow_eps
    shadowed = beam_shadow_mask(table, aug, root, height, _group(p, tile),
                                _group(r["hit"], tile), sun, K=K,
                                max_steps=max_steps)
    shadowed = _ungroup(shadowed, ty, tx, tile)
    lighting = _lighting(sun, r["normal"]) * torch.where(shadowed, 0.5, 1.0)
    surface = r["rgb"] * lighting[..., None]
    return torch.where(r["hit"][..., None], surface, sky_color(dirs, sun))


def beam_primary_frame(table, aug, root: int, height: int, origin, dirs, sun,
                       tile: int = 8, K: int = 64, max_steps: int = 2048,
                       rounds: int = 4):
    """Primary-hit shading (software.rs:260-276) on the beam cast
    (``beam.py:711``)."""
    r = beam_primary_frame_cast(table, aug, root, height, origin, dirs,
                                tile=tile, K=K, max_steps=max_steps,
                                rounds=rounds)
    sun = torch.as_tensor(sun, dtype=torch.float32, device=dirs.device)
    return r["rgb"] * _lighting(sun, r["normal"])[..., None] \
        * r["hit"][..., None]
