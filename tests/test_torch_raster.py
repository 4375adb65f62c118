"""Port vs JAX: the box rasterizer (voxtracer_torch/kernels/raster.py,
plain resolve) against voxtracer/kernels/raster.py and against the port's
own SVO cast.

Parity bar (tests/test_raster.py:32-58): hit, normal and rgb exact, t
within rtol 1e-4 / atol 1e-3, winners flipping only at degenerate
edge-grazes, which get a budget on degenerate cameras. JAX soups are
carried across as numpy arrays (raster.soup_to_device).

Where XLA differs: on the CPU it contracts ``a*b + c`` into fused
multiply-adds inside a jit. That moves the last bit of (1) the
camera-to-box distance (jnp.linalg.norm, a fused chain of squares) and
so a quantized sort key (about one key in eight at the 64^3 reference
pose, by a quantum or two), and (2) the jitted pixel-center
ray directions and so the last bit of a hit's t. The port rounds every
operation on its own, as its kernels do; the bins test bounds (1) to the
pairs whose box distance the fused chain changes, and the frame tests
hold (2) to the t tolerance above.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.kernels import raster as jraster
from voxtracer.world import worldgen as jgen
from voxtracer.world.boxes import extract_boxes as jextract
from voxtracer.world.svo import from_dense
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import raster as traster
from voxtracer_torch.kernels import resolve as tresolve
from voxtracer_torch.kernels import traverse as ttrav
from voxtracer_torch.world import svo as tsvo

torch.set_num_threads(2)
S64 = 64 / 8192
REF_POSE = dict(pos=tuple(np.asarray(jcam.DEFAULT_POSE.pos) * S64),
                yaw=jcam.DEFAULT_POSE.yaw, pitch=jcam.DEFAULT_POSE.pitch)


def _world(space):
    """A JAX world carried across: its soup and node table as tensors."""
    dev = space.serialize()
    soup = jextract(dev)
    return dict(dev=dev, soup=soup,
                args=traster.soup_to_device(soup.lo, soup.size, soup.leaf,
                                            soup.rgb, "cpu"),
                w=tsvo.upload(dev.table, dev.root, dev.height, "cpu"))


@pytest.fixture(scope="module")
def terrain():
    return _world(jgen.generate(log2_size=6, verbose=False, backend="python"))


@pytest.fixture(scope="module")
def clutter():
    rng = np.random.default_rng(5)
    n = 32
    solid = rng.random((n, n, n)) < 0.2
    rgb = rng.random((n, n, n, 3)).astype(np.float32)
    rgb[~solid] = 0
    return _world(from_dense(solid, rgb))


def _check(world, pos, yaw, pitch, W=64, H=40, graze_budget=0):
    w = world["w"]
    cam = tcam.Camera(pos=pos, yaw=yaw, pitch=pitch)
    op = np.asarray(pos, np.float32)
    rb = traster.raster_cast_exact(*world["args"], op, cam.basis(), w.height,
                                   W, H, table=w.table, root=w.root)
    _, d = tcam.generate_rays(cam, W, H)
    rr = ttrav.svo_raycast(w.table, w.root, w.height, torch.from_numpy(op), d)
    hb, hr = rb["hit"].numpy(), rr["hit"].numpy()
    both = hb & hr
    same_t = np.isclose(rb["t"].numpy(), rr["t"].numpy(), rtol=1e-4,
                        atol=1e-3)
    same_n = (rb["normal"].numpy() == rr["normal"].numpy()).all(-1)
    want_rgb = ttrav.leaf_rgb(w.table, rr["node"]).numpy()
    same_c = (rb["rgb"].numpy() == want_rgb).all(-1)
    agree = (hb == hr) & (~both | (same_t & same_n & same_c))
    assert int((~agree).sum()) <= graze_budget
    assert hb.any()
    return rb


def test_raster_clutter_generic(clutter):
    _check(clutter, (16.21, 17.13, -9.37), 0.11, 0.23)


def test_raster_clutter_inside(clutter):
    # camera inside the cloud: the near pre-pass handles straddling boxes
    rb = _check(clutter, (15.8, 16.2, 16.4), 2.3, -0.4)
    assert rb["n_near"] > 0


def test_raster_clutter_degenerate(clutter):
    # integer camera, axis-aligned view: rays through exact lattice corners
    _check(clutter, (16.0, 16.0, -10.0), 0.0, 0.0, graze_budget=80)


def test_raster_terrain_reference_pose(terrain):
    _check(terrain, REF_POSE["pos"], REF_POSE["yaw"], REF_POSE["pitch"],
           W=96, H=56)


def test_raster_terrain_looking_down(terrain):
    _check(terrain, (32.3, 70.7, 31.9), 0.37, 1.2)


def test_raster_behind_and_outside_culls(terrain):
    # camera above the world looking straight up: sky everywhere
    cam = tcam.Camera(pos=(32.0, 80.0, 32.0), yaw=0.0, pitch=-1.5707)
    rb = traster.raster_cast(*terrain["args"], np.asarray(cam.pos, np.float32),
                             cam.basis(), terrain["w"].height, 32, 24)
    assert not rb["hit"].any() and rb["n_tier"] == [0] * 11


def test_raster_distance_cap(clutter):
    """The rasterizer's cap is strict, the traversal's advisory: within the
    cap both agree; every traversal hit the rasterizer lacks leaked past."""
    w = clutter["w"]
    cam = tcam.Camera(pos=(16.21, 17.13, -9.37), yaw=0.11, pitch=0.23)
    op = np.asarray(cam.pos, np.float32)
    cap = 12.0
    rb = traster.raster_cast_exact(*clutter["args"], op, cam.basis(), w.height,
                                   64, 40, distance=cap, table=w.table,
                                   root=w.root)
    _, d = tcam.generate_rays(cam, 64, 40)
    rr = ttrav.svo_raycast(w.table, w.root, w.height, torch.from_numpy(op), d,
                           distance=cap)
    hb, hr, rt = rb["hit"].numpy(), rr["hit"].numpy(), rr["t"].numpy()
    in_cap = hr & (rt <= cap)
    assert (hb == in_cap).all() and hb.any()
    assert (rt[hr & ~hb] > cap).all()
    assert np.allclose(rb["t"].numpy()[hb], rt[hb], rtol=1e-4, atol=1e-3)


def _jitter_dirs(cam, W, H, seeds):
    py, px = tcam.pixel_grid(W, H)
    ld = tcam.pixel_ndc(px, py, W, H)
    out = []
    for s in seeds:
        jit = torch.from_numpy(np.random.default_rng(s).random((H, W, 2),
                                                               np.float32))
        out.append(tcam.ray_directions(cam.basis(), ld, jitter=jit, height=H))
    return torch.stack(out)


@pytest.mark.parametrize("KS", [2, 3])
def test_k_batched_equals_separate_casts(terrain, KS):
    """KS jitter samples of one pose in one resolve (r = sample*64 +
    intile) equal KS separate casts, bit for bit, widen rounds and the
    fallback included."""
    w = terrain["w"]
    cam = tcam.Camera(pos=(30.0, 34.0, 12.0), yaw=0.9, pitch=-0.3)
    op = np.asarray(cam.pos, np.float32)
    W, H = 64, 48
    ds = _jitter_dirs(cam, W, H, range(KS))
    bins = traster.raster_bins(*terrain["args"], op, cam.basis(), w.height, W,
                               H, jittered=True)
    kw = dict(table=w.table, root=w.root, bins=bins)
    batched = traster.raster_cast_exact(*terrain["args"], op, cam.basis(),
                                        w.height, W, H, ray_dirs=ds, **kw)
    for k in range(KS):
        one = traster.raster_cast_exact(*terrain["args"], op, cam.basis(),
                                        w.height, W, H, ray_dirs=ds[k], **kw)
        for f in ("hit", "t", "normal", "rgb"):
            assert torch.equal(batched[f][k], one[f]), (k, f)
    assert batched["hit"].any()


def _jax_bins(world, op, basis, W, H, jittered):
    soup = world["soup"]
    return jraster.raster_bins(
        jnp.asarray(soup.lo), jnp.asarray(soup.size), op,
        np.asarray(basis), world["dev"].height, W, H, near_slots=256,
        pair_slots=(1 << 14,) * 10, jittered=jittered,
        box_attr=jnp.asarray(jraster.pack_box_attr(soup)))


def _fused_dmin(world, op):
    """The camera-to-box distance as XLA evaluates jnp.linalg.norm: a
    fused multiply-add chain, emulated in float64 and rounded once per
    step."""
    lo = world["soup"].lo.astype(np.float32)
    hi = lo + world["soup"].size.astype(np.float32)
    r = np.clip(op, lo, hi) - op
    fma = lambda a, b, c: (a.astype(np.float64) * b + c).astype(np.float32)  # noqa: E731,E501
    return np.sqrt(fma(r[:, 2], r[:, 2], fma(r[:, 1], r[:, 1],
                                             r[:, 0] * r[:, 0])))


@pytest.mark.parametrize("jittered", [False, True])
def test_bins_equal_jax(terrain, jittered):
    """Tier counts, the near list, every tile's segment and candidate
    records equal the JAX package's; a sort key differs by at most one
    quantum and only for a box whose distance XLA's fused chain moves."""
    cam = tcam.Camera(**REF_POSE)
    op = np.asarray(cam.pos, np.float32)
    W, H = 96, 56
    got = traster.raster_bins(*terrain["args"], op, cam.basis(),
                              terrain["w"].height, W, H, jittered=jittered)
    want = _jax_bins(terrain, op, cam.basis(), W, H, jittered)
    assert got["n_tier"] == np.asarray(want["n_tier"]).tolist()
    n_near = got["n_near"]
    assert np.array_equal(got["near_idx"].numpy(),
                          np.asarray(want["near_idx"])[:n_near])
    assert np.array_equal(got["seg_start"].numpy(), np.asarray(want["seg_start"]))
    n_pair = int(got["n_pair"])
    assert n_pair == int(want["n_pair"]) > 0
    a = got["spairs"].numpy()[:n_pair]
    b = np.asarray(want["spairs"])[:n_pair]
    assert np.array_equal(a[:, 1:], b[:, 1:])  # owners, geometry, albedo
    DB = got["dmin_bits"]
    assert np.array_equal(a[:, 0] >> DB, b[:, 0] >> DB)  # tiles
    moved = a[:, 0] != b[:, 0]
    # a moved key is a box whose fused distance quantizes elsewhere: the
    # emulated fused chain gives JAX's key exactly
    fused = _fused_dmin(terrain, op)
    inv_q = np.float32(1) / np.float32(got["quantum"])
    qmax = (1 << DB) - 2
    qf = np.minimum((fused[a[moved, 1]] * inv_q).astype(np.int64), qmax)
    assert np.array_equal(qf, b[moved, 0] & ((1 << DB) - 1))
    # valid candidate rows and the dropped bounds follow the same keys
    NT = got["seg_start"].shape[0]
    gc = tresolve.seg_rows(got["spairs"], got["seg_start"],
                           got["cand_k"]).numpy()
    wc = np.asarray(want["cand_rows"])
    valid = (gc[..., 0] >> DB) == np.arange(NT)[:, None]
    assert np.array_equal(valid, (wc[..., 0] >> DB) == np.arange(NT)[:, None])
    assert np.array_equal(gc[valid][:, 1:], wc[valid][:, 1:])
    gd, wd = got["drop_dmin"].numpy(), np.asarray(want["drop_dmin"])
    assert np.array_equal(np.isfinite(gd), np.isfinite(wd))
    differ = np.nonzero(gd != wd)[0]
    K = gc.shape[1]
    assert moved[got["seg_start"].numpy()[differ] + K].all()


def test_frame_equals_jax_raster_cast_exact(terrain):
    """The exact frame against the JAX package's: hits, normals and albedo
    equal; t to the parity tolerance (XLA's fused ray directions)."""
    cam = tcam.Camera(**REF_POSE)
    op = np.asarray(cam.pos, np.float32)
    W, H = 96, 56
    w, soup = terrain["w"], terrain["soup"]
    got = traster.raster_cast_exact(*terrain["args"], op, cam.basis(), w.height,
                                    W, H, table=w.table, root=w.root)
    dev = terrain["dev"]
    want = jraster.raster_cast_exact(
        jnp.asarray(soup.lo), jnp.asarray(soup.size),
        jnp.asarray(jraster.pack_box_attr(soup)), op, np.asarray(cam.basis()),
        dev.height, W, H, table=jnp.asarray(dev.table.view(np.int32)),
        root=np.int32(dev.root), want_voxel=False)
    for f in ("hit", "normal", "rgb"):
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    assert np.allclose(got["t"].numpy(), np.asarray(want["t"]), rtol=1e-4,
                       atol=1e-3)
    assert got["n_widen"][0] == int(np.asarray(want["n_widen"])[0])


def _one_direction_set(cam, W, H):
    """The port's pixel-centre directions and a jittered set, (H, W, 3)
    each, for both packages' ``ray_dirs=``."""
    _, centres = tcam.generate_rays(cam, W, H, device="cpu")
    jitter = torch.from_numpy(
        np.random.default_rng(31).random((H, W, 2), np.float32))
    _, jittered = tcam.generate_rays(cam, W, H, jitter=jitter, device="cpu")
    return centres, jittered


def _equal_by_bits(got, want, counts=True):
    """The frame's hit, t, normal and rgb equal by bits; with ``counts``,
    the widen rounds' tile counts too (both sides ran the same rounds)."""
    for f in ("hit", "t", "normal", "rgb"):
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    if counts:
        assert np.array_equal(np.asarray(got["n_widen"]),
                              np.asarray(want["n_widen"])), "n_widen"


def test_frame_equals_jax_raster_cast_exact_on_one_direction_set(terrain):
    """The case above with both packages handed one direction set through
    ``ray_dirs=``: every output equal by bits, t and the widen counts
    included."""
    cam = tcam.Camera(**REF_POSE)
    op = np.asarray(cam.pos, np.float32)
    W, H = 96, 56
    w, soup, dev = terrain["w"], terrain["soup"], terrain["dev"]
    for d in _one_direction_set(cam, W, H):
        got = traster.raster_cast_exact(*terrain["args"], op, cam.basis(),
                                        w.height, W, H, table=w.table,
                                        root=w.root, ray_dirs=d)
        want = jraster.raster_cast_exact(
            jnp.asarray(soup.lo), jnp.asarray(soup.size),
            jnp.asarray(jraster.pack_box_attr(soup)), op,
            np.asarray(cam.basis()), dev.height, W, H,
            table=jnp.asarray(dev.table.view(np.int32)),
            root=np.int32(dev.root), want_voxel=False,
            ray_dirs=jnp.asarray(d.numpy()))
        assert got["hit"].any()
        _equal_by_bits(got, want)


def _reference_cast(world, op, basis, W, H, ray_dirs=None, bins=None):
    """raster_cast as it ran before the segment form: every round's
    records gathered with seg_rows beside a validity mask, the carries of
    the open tiles gathered, folded by resolve_fold_plain and scattered
    back, and the open tiles found from the whole carry. Returns (t, pl,
    rgb) in tile layout, n_widen and the fallback tiles."""
    h = world["w"].height
    if bins is None:
        bins = traster.raster_bins(*world["args"], op, basis, h, W, H,
                                   jittered=ray_dirs is not None)
    DB, spairs, seg_start = bins["dmin_bits"], bins["spairs"], bins["seg_start"]
    skey, K = bins["skey"], bins["cand_k"]
    d_t, ok_t, _ = traster.tile_rays(basis, W, H, ray_dirs)
    NT, R = ok_t.shape
    fold = lambda c, rows, valid, d: tresolve.resolve_fold_plain(  # noqa: E731
        *c, rows, valid, d, op, h, ttrav.FAR)
    carry = (torch.full((NT, R), torch.inf),
             torch.full((NT, R), -1, dtype=torch.int32),
             torch.zeros((NT, R, 3)))
    if bins["near_rows"].shape[0]:
        carry = fold(carry, bins["near_rows"],
                     torch.ones(bins["near_rows"].shape[0], dtype=torch.bool),
                     d_t)
    tix = torch.arange(NT, dtype=torch.int32)
    rows = tresolve.seg_rows(spairs, seg_start, K)
    tb, plb, rgbb = fold(carry, rows, (rows[..., 0] >> DB) == tix[:, None],
                         d_t)
    consumed = torch.full((NT,), K, dtype=torch.int32)
    drop = bins["drop_dmin"].clone()

    def still_open():
        tile_max = torch.amax(torch.where(ok_t, tb, -torch.inf), dim=1)
        return torch.nonzero(torch.isfinite(drop) & (drop < tile_max))[:, 0]

    n_widen = []
    for k_extra in traster.WIDEN_K:
        wl = still_open()
        n_widen.append(int(wl.numel()))
        if not n_widen[-1]:
            break
        rows = tresolve.seg_rows(spairs, seg_start[wl] + consumed[wl], k_extra)
        valid = (rows[..., 0] >> DB) == wl.to(torch.int32)[:, None]
        tb[wl], plb[wl], rgbb[wl] = fold((tb[wl], plb[wl], rgbb[wl]), rows,
                                         valid, d_t[wl])
        consumed[wl] += k_extra
        posr = torch.clamp_max(seg_start[wl] + consumed[wl],
                               skey.shape[0] - 1).long()
        drop[wl] = torch.where((skey[posr] >> DB) == wl.to(torch.int32),
                               tresolve.dequant(skey[posr], DB,
                                                bins["quantum"]), torch.inf)
    n_widen += [0] * (3 - len(n_widen))
    fb = still_open() if n_widen[-1] else torch.zeros(0, dtype=torch.int64)
    return (tb, plb, rgbb), n_widen, fb


@pytest.mark.parametrize("scene,pos,yaw,pitch,W,H,KS", [
    ("terrain", REF_POSE["pos"], REF_POSE["yaw"], REF_POSE["pitch"], 96, 56, 1),
    ("terrain", (30.0, 34.0, 12.0), 0.9, -0.3, 64, 48, 2),
    ("terrain", (32.3, 70.7, 31.9), 0.37, 1.2, 61, 37, 1),  # ragged tiles
    ("clutter", (15.8, 16.2, 16.4), 2.3, -0.4, 64, 40, 1),  # a near list
    ("clutter", (16.21, 17.13, -9.37), 0.11, 0.23, 64, 40, 3),
])
def test_cast_on_segment_form_equals_gathered_rounds(terrain, clutter, scene,
                                                     pos, yaw, pitch, W, H,
                                                     KS):
    """raster_cast on the segment form (the sorted pair array read in
    place, the frame's carry updated in place, per-tile maxima from the
    fold) gives the frame, the widen counters and the fallback list of
    the rounds run on gathered lists and carries."""
    world = terrain if scene == "terrain" else clutter
    cam = tcam.Camera(pos=pos, yaw=yaw, pitch=pitch)
    op = np.asarray(pos, np.float32)
    ds = _jitter_dirs(cam, W, H, range(KS)) if KS > 1 else None
    got = traster.raster_cast(*world["args"], op, cam.basis(),
                              world["w"].height, W, H, ray_dirs=ds)
    (tb, plb, _), n_widen, fb = _reference_cast(world, op, cam.basis(), W, H,
                                                ds)
    assert got["n_widen"] == n_widen and sum(n_widen) > 0
    assert got["n_fallback"] == fb.numel()
    assert np.array_equal(got["fb_tiles"].numpy(), fb.numpy())
    TW, TH = -(-W // 8), -(-H // 8)
    t_px = tb.reshape(TH, TW, KS, 8, 8).permute(2, 0, 3, 1, 4).reshape(
        KS, TH * 8, TW * 8)[:, :H, :W]
    pl_px = plb.reshape(TH, TW, KS, 8, 8).permute(2, 0, 3, 1, 4).reshape(
        KS, TH * 8, TW * 8)[:, :H, :W]
    hit = torch.isfinite(t_px) & (pl_px >= 0)
    g_hit, g_t = got["hit"].reshape(KS, H, W), got["t"].reshape(KS, H, W)
    assert torch.equal(g_hit, hit)
    assert torch.equal(g_t, torch.where(hit, t_px, 0.0))
    assert hit.any()


def test_bins_hold_no_candidate_lists(terrain):
    """The bins carry the sorted pair array and each tile's segment start,
    not per-tile candidate lists; the main fold's candidates are the first
    cand_k records of each segment."""
    cam = tcam.Camera(**REF_POSE)
    bins = traster.raster_bins(*terrain["args"],
                               np.asarray(cam.pos, np.float32), cam.basis(),
                               terrain["w"].height, 96, 56, cand_k=12)
    assert "cand_rows" not in bins and bins["cand_k"] == 12
    NT = bins["seg_start"].shape[0]
    assert all(v.numel() < NT * 12 * 8 for k, v in bins.items()
               if isinstance(v, torch.Tensor) and k != "spairs")
    # the main fold reports the bins' dropped bounds as its next bounds
    d_t, ok_t, _ = traster.tile_rays(cam.basis(), 96, 56)
    carry = (torch.full((NT, 64), torch.inf),
             torch.full((NT, 64), -1, dtype=torch.int32),
             torch.zeros((NT, 64, 3)))
    _, nxt = tresolve.resolve_fold_seg(
        *carry, bins["spairs"], None, bins["seg_start"], 12,
        bins["dmin_bits"], bins["quantum"], d_t, ok_t,
        np.asarray(cam.pos, np.float32), terrain["w"].height, ttrav.FAR)
    assert torch.equal(nxt, bins["drop_dmin"])
    assert torch.isfinite(nxt).any()


def test_cast_counts_its_host_reads(terrain):
    """One host read for the bins' tier counts, one per widen round
    entered, one for the fallback list when the last round ran."""
    cam = tcam.Camera(**REF_POSE)
    op = np.asarray(cam.pos, np.float32)
    h = terrain["w"].height
    traster.host_reads = 0
    bins = traster.raster_bins(*terrain["args"], op, cam.basis(), h, 96, 56)
    assert traster.host_reads == 1
    traster.host_reads = 0
    r = traster.raster_cast(*terrain["args"], op, cam.basis(), h, 96, 56,
                            bins=bins)
    rounds = sum(1 for n in r["n_widen"] if n)
    entered = min(rounds + 1, 3)  # the round that finds no tile is a read
    assert traster.host_reads == entered + (1 if r["n_widen"][-1] else 0)


def _starved(monkeypatch):
    """Bins of 2 candidates and widen rounds of 1, 1 and 2 records, so
    that many tiles stay open after the last round and are re-cast."""
    monkeypatch.setattr(traster, "WIDEN_K", (1, 1, 2))


@pytest.mark.parametrize("pos,yaw,pitch,KS", [
    (REF_POSE["pos"], REF_POSE["yaw"], REF_POSE["pitch"], 1),
    ((30.0, 34.0, 12.0), 0.9, -0.3, 2),
    ((32.3, 70.7, 31.9), 0.37, 1.2, 1),
])
def test_fallback_on_the_heightfield_equals_the_svo_fallback(
        terrain, monkeypatch, pos, yaw, pitch, KS):
    """``raster_cast_exact(hf=...)``: the still-open tiles re-cast on the
    heightfield walk, resumed 2 voxels before each tile's nearest
    unfolded bound, give the frame of the SVO fallback bit for bit."""
    from voxtracer_torch.kernels import heightfield as thf

    _starved(monkeypatch)
    w = terrain["w"]
    cam = tcam.Camera(pos=pos, yaw=yaw, pitch=pitch)
    op = np.asarray(cam.pos, np.float32)
    W, H = 64, 48
    ds = None if KS == 1 else _jitter_dirs(cam, W, H, range(KS))
    bins = traster.raster_bins(*terrain["args"], op, cam.basis(), w.height, W,
                               H, cand_k=2, jittered=ds is not None)
    raw = traster.raster_cast(*terrain["args"], op, cam.basis(), w.height, W,
                              H, ray_dirs=ds, bins=bins)
    assert raw["n_fallback"] > 4 and raw["fb_need"].any()
    assert raw["fb_tmin"].shape == raw["fb_tiles"].shape
    assert torch.isfinite(raw["fb_tmin"]).all()
    # a needy ray's resolved t is no nearer than its tile's bound
    assert (raw["fb_tmin"] > 0).all()
    space = terrain["dev"].space
    tiles, offs, _ = thf.build_height_mips(np.asarray(space.heights),
                                           device="cpu")
    rgb = terrain["soup"].rgb[0]
    kw = dict(ray_dirs=ds, bins=bins)
    want = traster.raster_cast_exact(*terrain["args"], op, cam.basis(),
                                     w.height, W, H, table=w.table,
                                     root=w.root, **kw)
    before = thf.plain_lane_steps
    got = traster.raster_cast_exact(*terrain["args"], op, cam.basis(),
                                    w.height, W, H, hf=(tiles, offs, rgb),
                                    **kw)
    assert thf.plain_lane_steps > before
    for f in ("hit", "t", "normal", "rgb"):
        assert torch.equal(got[f], want[f]), f
    assert not torch.equal(got["hit"], raw["hit"]) \
        or not torch.equal(got["t"], raw["t"])


def test_heightfield_fallback_equals_jax(terrain, monkeypatch):
    """Against the JAX package's ``raster_cast_exact(hf_mips=...)`` with
    its rounds at their smallest (its lists come in chunks of 8), under
    the raster parity bar."""
    from voxtracer.kernels import heightfield as jhf

    from voxtracer_torch.kernels import heightfield as thf

    _starved(monkeypatch)
    cam = tcam.Camera(**REF_POSE)
    op = np.asarray(cam.pos, np.float32)
    W, H = 64, 48
    w, soup, dev = terrain["w"], terrain["soup"], terrain["dev"]
    heights = np.asarray(dev.space.heights)
    tiles, offs, _ = thf.build_height_mips(heights, device="cpu")
    bins = traster.raster_bins(*terrain["args"], op, cam.basis(), w.height, W,
                               H, cand_k=2)
    got = traster.raster_cast_exact(*terrain["args"], op, cam.basis(),
                                    w.height, W, H, bins=bins,
                                    hf=(tiles, offs, soup.rgb[0]))
    assert got["n_fallback"] > 4
    flat, joffs, _ = jhf.build_height_mips(heights)
    want = jraster.raster_cast_exact(
        jnp.asarray(soup.lo), jnp.asarray(soup.size),
        jnp.asarray(jraster.pack_box_attr(soup)), op, np.asarray(cam.basis()),
        dev.height, W, H, hf_mips=flat, hf_offsets=joffs,
        terrain_rgb=jnp.asarray(soup.rgb[0]), want_voxel=False, cand_k=8,
        widen_k=8, widen2_k=8, widen3_k=8)
    assert int(np.asarray(want["n_fallback"])) > 4
    for f in ("hit", "normal", "rgb"):
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f
    assert np.allclose(got["t"].numpy(), np.asarray(want["t"]), rtol=1e-4,
                       atol=1e-3)


def test_heightfield_fallback_equals_jax_on_one_direction_set(
        terrain, monkeypatch):
    """The case above with both packages handed one direction set through
    ``ray_dirs=``: every output of the frame equal by bits (the rounds
    differ by design, the port's starved and the JAX package's in chunks
    of 8, so their counts are not compared)."""
    from voxtracer.kernels import heightfield as jhf

    from voxtracer_torch.kernels import heightfield as thf

    _starved(monkeypatch)
    cam = tcam.Camera(**REF_POSE)
    op = np.asarray(cam.pos, np.float32)
    W, H = 64, 48
    w, soup, dev = terrain["w"], terrain["soup"], terrain["dev"]
    heights = np.asarray(dev.space.heights)
    tiles, offs, _ = thf.build_height_mips(heights, device="cpu")
    flat, joffs, _ = jhf.build_height_mips(heights)
    for d in _one_direction_set(cam, W, H):
        bins = traster.raster_bins(*terrain["args"], op, cam.basis(),
                                   w.height, W, H, cand_k=2, jittered=True)
        got = traster.raster_cast_exact(*terrain["args"], op, cam.basis(),
                                        w.height, W, H, bins=bins,
                                        hf=(tiles, offs, soup.rgb[0]),
                                        ray_dirs=d)
        assert got["n_fallback"] > 4
        want = jraster.raster_cast_exact(
            jnp.asarray(soup.lo), jnp.asarray(soup.size),
            jnp.asarray(jraster.pack_box_attr(soup)), op,
            np.asarray(cam.basis()), dev.height, W, H, hf_mips=flat,
            hf_offsets=joffs, terrain_rgb=jnp.asarray(soup.rgb[0]),
            want_voxel=False, cand_k=8, widen_k=8, widen2_k=8, widen3_k=8,
            ray_dirs=jnp.asarray(d.numpy()))
        assert int(np.asarray(want["n_fallback"])) > 4
        _equal_by_bits(got, want, counts=False)


@pytest.mark.parametrize("which,pos,yaw,pitch", [
    ("terrain", REF_POSE["pos"], REF_POSE["yaw"], REF_POSE["pitch"]),
    ("terrain", (30.0, 34.0, 12.0), 0.9, -0.3),
    ("clutter", (16.21, 17.13, -9.37), 0.11, 0.23),
])
def test_want_voxel_equals_svo_cast_and_jax(terrain, clutter, which, pos,
                                            yaw, pitch):
    """want_voxel (the default): each pixel's leaf id and hit voxel,
    gathered from the winning box, equal the SVO cast's on the same rays
    and the JAX package's raster_cast_exact(want_voxel=True); the
    shading-only form gives the same hit, t, normal and rgb."""
    world = terrain if which == "terrain" else clutter
    w, soup, dev = world["w"], world["soup"], world["dev"]
    cam = tcam.Camera(pos=pos, yaw=yaw, pitch=pitch)
    op = np.asarray(pos, np.float32)
    W, H = 64, 40
    kw = dict(table=w.table, root=w.root)
    got = traster.raster_cast_exact(*world["args"], op, cam.basis(), w.height,
                                    W, H, **kw)
    plain = traster.raster_cast_exact(*world["args"], op, cam.basis(),
                                      w.height, W, H, want_voxel=False, **kw)
    assert "node" not in plain
    for f in ("hit", "t", "normal", "rgb"):
        assert torch.equal(got[f], plain[f]), f
    _, d = tcam.generate_rays(cam, W, H)
    rr = ttrav.svo_raycast(w.table, w.root, w.height, torch.from_numpy(op), d)
    assert got["hit"].any()
    assert torch.equal(got["hit"], rr["hit"])
    assert torch.equal(got["node"], rr["node"])
    assert torch.equal(got["voxel"], rr["voxel"])
    want = jraster.raster_cast_exact(
        jnp.asarray(soup.lo), jnp.asarray(soup.size),
        jnp.asarray(jraster.pack_box_attr(soup)), op, np.asarray(cam.basis()),
        dev.height, W, H, table=jnp.asarray(dev.table.view(np.int32)),
        root=np.int32(dev.root), near_slots=256)
    for f in ("hit", "node", "voxel", "normal", "rgb"):
        assert np.array_equal(got[f].numpy(), np.asarray(want[f])), f


@pytest.mark.parametrize("KS", [1, 2])
def test_want_voxel_through_both_fallbacks(terrain, monkeypatch, KS):
    """Starved bins leave tiles open: the SVO fallback merges K2's node
    and voxel, the heightfield fallback the walk's voxel and the given
    terrain leaf, as the JAX package's apply_fallback_hf; k jittered
    samples resolved in one pass equal separate casts."""
    from voxtracer.kernels import heightfield as jhf

    from voxtracer_torch.kernels import heightfield as thf
    from voxtracer_torch.world.boxes import terrain_leaf_id

    _starved(monkeypatch)
    w, soup, dev = terrain["w"], terrain["soup"], terrain["dev"]
    cam = tcam.Camera(**REF_POSE)
    op = np.asarray(cam.pos, np.float32)
    W, H = 64, 48
    ds = None if KS == 1 else _jitter_dirs(cam, W, H, range(KS))
    bins = traster.raster_bins(*terrain["args"], op, cam.basis(), w.height, W,
                               H, cand_k=2, jittered=ds is not None)
    heights = np.asarray(dev.space.heights)
    tiles, offs, _ = thf.build_height_mips(heights, device="cpu")
    leaf = terrain_leaf_id(dev)
    svo = traster.raster_cast_exact(*terrain["args"], op, cam.basis(),
                                    w.height, W, H, table=w.table,
                                    root=w.root, bins=bins, ray_dirs=ds)
    hf = traster.raster_cast_exact(*terrain["args"], op, cam.basis(),
                                   w.height, W, H, bins=bins, ray_dirs=ds,
                                   hf=(tiles, offs, soup.rgb[0]),
                                   terrain_node=leaf)
    assert svo["n_fallback"] > 4
    for f in ("hit", "t", "normal", "rgb", "node", "voxel"):
        assert torch.equal(svo[f], hf[f]), f
    for k in range(KS):
        one = traster.raster_cast_exact(
            *terrain["args"], op, cam.basis(), w.height, W, H, table=w.table,
            root=w.root, bins=bins, ray_dirs=None if ds is None else ds[k])
        for f in ("node", "voxel"):
            assert torch.equal(svo[f] if KS == 1 else svo[f][k], one[f]), f
    if KS > 1:
        return
    flat, joffs, _ = jhf.build_height_mips(heights)
    want = jraster.raster_cast_exact(
        jnp.asarray(soup.lo), jnp.asarray(soup.size),
        jnp.asarray(jraster.pack_box_attr(soup)), op, np.asarray(cam.basis()),
        dev.height, W, H, hf_mips=flat, hf_offsets=joffs,
        terrain_rgb=jnp.asarray(soup.rgb[0]), terrain_node=leaf, cand_k=8,
        widen_k=8, widen2_k=8, widen3_k=8)
    assert int(np.asarray(want["n_fallback"])) > 4
    for f in ("hit", "node", "voxel", "normal"):
        assert np.array_equal(hf[f].numpy(), np.asarray(want[f])), f
