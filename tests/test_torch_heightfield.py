"""Port vs JAX: the heightfield engine (voxtracer_torch/kernels/
heightfield.py: the pack, the plain version of kernel K4, the edited
hybrid and the frame cast, against voxtracer/kernels/heightfield.py) on
64^3 terrain, on the ray sets of tests/test_heightfield.py.

Tolerances. The pack and its patch: bitwise equal. The plain walk against
JAX ``hf_raycast``: hit, t and normal bitwise equal on every lane. The
hit voxel's y comes from ``floor(s0.y + dd.y * t)``, which XLA may fuse
into one FMA where the port rounds twice, so a lane landing within an ulp
of an integer may differ: budget 1 lane in 10^3 (none seen). Against the
SVO cast (either package's), lane for lane up to the edge-graze budget of
tests/test_heightfield.py (2-4 lanes of 2048-4096).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.kernels import heightfield as jhf
from voxtracer.kernels import traverse as jtr
from voxtracer.world import worldgen as jgen
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import heightfield as thf
from voxtracer_torch.kernels import raster as trs
from voxtracer_torch.kernels import traverse as ttr
from voxtracer_torch.utils import profiling
from voxtracer_torch.world import boxes as tboxes
from voxtracer_torch.world import svo as tsvo

torch.set_num_threads(2)
LOG2 = 6
N = 1 << LOG2
KEYS = ("hit", "t", "normal", "voxel")


@pytest.fixture(scope="module")
def world():
    space = jgen.generate(log2_size=LOG2, verbose=False, backend="python")
    dev = space.serialize()
    heights = np.asarray(space.heights)
    return dict(
        space=space, dev=dev, heights=heights,
        w=tsvo.upload(dev.table, dev.root, dev.height, "cpu"),
        jpack=jhf.build_height_mips(heights),
        tpack=thf.build_height_mips(heights, device="cpu"))


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rand_dirs(rng, n):
    v = rng.standard_normal((n, 3)).astype(np.float32)
    v /= np.linalg.norm(v, axis=-1, keepdims=True)
    return v


def _aimed(rng, B, n=N):
    start = rng.uniform(-n, 2 * n, (B, 3)).astype(np.float32)
    target = rng.uniform(0, n, (B, 3)).astype(np.float32)
    d = target - start
    return start, d / np.linalg.norm(d, axis=-1, keepdims=True)


def _jax_cast(world, start, d, **kw):
    kw = {k: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    flat, offs, h = world["jpack"]
    return jhf.hf_raycast(flat, offs, h, jnp.asarray(start), jnp.asarray(d),
                          **kw)


def _port_cast(world, start, d, pack=None, **kw):
    kw = {k: (_t(v) if isinstance(v, np.ndarray) else v)
          for k, v in kw.items()}
    return thf.hf_raycast(*(pack or world["tpack"]), _t(start), _t(d), **kw)


def _mismatch(a, b, keys=KEYS):
    """Lanes where two casts differ: hit, or any of ``keys`` on a hit."""
    g = lambda r, k: np.asarray(r[k])  # noqa: E731
    mism = g(a, "hit") != g(b, "hit")
    both = g(a, "hit") & g(b, "hit")
    for k in keys[1:]:
        x, y = g(a, k), g(b, k)
        mism |= both & (x != y).reshape(len(both), -1).any(-1)
    return int(mism.sum())


def _assert_equals_jax(want, got):
    """hit/t/normal bitwise equal; voxel within 1 lane in 10^3."""
    B = np.asarray(want["hit"]).size
    for k in ("hit", "t", "normal"):
        assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
    bad = (np.asarray(want["voxel"]) != got["voxel"].numpy()).any(-1).sum()
    assert bad <= B // 1000, f"{bad} voxels differ"


def _surface_rays(world, rng, B):
    """Rays re-cast from hit points (a bounce's geometry: origins exactly
    on voxel faces), toward the hemisphere around the normal."""
    start = rng.uniform(0, N, (B, 3)).astype(np.float32)
    start[:, 1] = rng.uniform(1, N, B)
    d = _rand_dirs(rng, B)
    first = ttr.svo_raycast(world["w"].table, world["w"].root, LOG2,
                            _t(start), _t(d))
    hit = first["hit"].numpy()
    pos = (start + first["t"].numpy()[:, None] * d)[hit]
    nrm = first["normal"].numpy()[hit]
    d2 = _rand_dirs(rng, len(pos))
    back = np.sum(d2 * nrm, axis=-1) < 0
    d2[back] -= 2 * np.sum(d2[back] * nrm[back], axis=-1,
                           keepdims=True) * nrm[back]
    return pos.astype(np.float32), d2.astype(np.float32)


def _solid_starts(world, rng, B):
    sx, sz = np.nonzero(world["heights"] >= 2)
    pick = rng.integers(0, len(sx), B)
    x, z = sx[pick], sz[pick]
    y = world["heights"][x, z] * rng.uniform(0.1, 0.9, B)
    start = np.stack([x + rng.uniform(0.2, 0.8, B), y,
                      z + rng.uniform(0.2, 0.8, B)], axis=-1)
    return start.astype(np.float32), _rand_dirs(rng, B)


def _ray_set(world, name):
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "airborne":
        start = rng.uniform(0, N, (4096, 3)).astype(np.float32)
        return start, _rand_dirs(rng, 4096), {}, 2
    if name == "outside":
        return *_aimed(rng, 2048), {}, 2
    if name == "surface bounce":
        return *_surface_rays(world, rng, 4096), {}, 4
    if name == "inside solid":
        return *_solid_starts(world, rng, 2048), {}, 2
    if name == "inside solid, t == 0 hits kept":
        start, d = _solid_starts(world, rng, 1024)
        start[::2, 1] += N / 2  # every other one from the air
        return start, d, dict(skip_t0=False), 2
    if name == "axis parallel":
        start = rng.uniform(0, N, (2048, 3)).astype(np.float32)
        start[:512] = np.floor(start[:512])  # on voxel boundaries
        d = _rand_dirs(rng, 2048)
        d[::3, 0] = 0.0
        d[1::3, 1] = -0.0
        d[2::3, [0, 2]] = 0.0
        d /= np.linalg.norm(d, axis=-1, keepdims=True)
        return start, d, {}, 4
    if name == "capped":
        start = rng.uniform(0, N, (2048, 3)).astype(np.float32)
        cap = np.where(rng.random(2048) < 0.3, np.float32(jtr.FAR),
                       rng.random(2048, np.float32) * N).astype(np.float32)
        return start, _rand_dirs(rng, 2048), dict(distance=cap), 2
    if name == "masked":
        start = rng.uniform(0, N, (1024, 3)).astype(np.float32)
        return start, _rand_dirs(rng, 1024), \
            dict(active=rng.random(1024) < 0.5), 2
    raise KeyError(name)


SETS = ["airborne", "outside", "surface bounce", "inside solid",
        "inside solid, t == 0 hits kept", "axis parallel", "capped",
        "masked"]


@pytest.mark.parametrize("tile_log", [1, 2, 3])
def test_pack_bitwise_equals_jax(world, tile_log):
    flat, offs, h = jhf.build_height_mips(world["heights"], tile_log=tile_log)
    tiles, toffs, th = thf.build_height_mips(world["heights"],
                                             tile_log=tile_log, device="cpu")
    assert (toffs, th) == (offs, h) and tiles.is_contiguous()
    assert tiles.dtype == torch.float32
    assert np.array_equal(np.asarray(flat).view(np.int32),
                          tiles.numpy().view(np.int32))
    assert float(thf.terrain_max(tiles, toffs)) == world["heights"].max()
    again = thf.mips_from_numpy(np.asarray(flat), offs, h, device="cpu")
    assert again[1:] == (toffs, th) and torch.equal(again[0], tiles)


@pytest.mark.parametrize("n,tile_log", [(2, 3), (4, 1), (8, 3), (16, 3),
                                        (16, 2), (32, 2), (32, 3)])
def test_pack_of_small_and_partial_grids_equals_jax(n, tile_log):
    """Heights at or below one tile, and top grids that fill no tile."""
    rng = np.random.default_rng(n + tile_log)
    heights = rng.integers(0, n + 1, (n, n)).astype(np.uint32)
    flat, offs, h = jhf.build_height_mips(heights, tile_log=tile_log)
    tiles, toffs, th = thf.build_height_mips(heights, tile_log=tile_log,
                                             device="cpu")
    assert (toffs, th) == (offs, h)
    assert np.array_equal(np.asarray(flat), tiles.numpy())


@pytest.mark.parametrize("tile_log", [2, 3])
def test_patch_bitwise_equals_jax_and_a_fresh_build(world, tile_log):
    rng = np.random.default_rng(3)
    heights = world["heights"].copy()
    flat, offs, h = jhf.build_height_mips(heights, tile_log=tile_log)
    tiles, toffs, th = thf.build_height_mips(heights, tile_log=tile_log,
                                             device="cpu")
    cols = [tuple(int(v) for v in rng.integers(0, N, 2)) for _ in range(9)]
    cols.append((int(np.argmax(heights) // N), int(np.argmax(heights) % N)))
    for x, z in cols:
        heights[x, z] = rng.integers(0, N + 1)
    heights[cols[-1]] = 0  # the world's maximum goes
    want = jhf.patch_height_mips(flat, offs, h, heights, cols)
    got = thf.patch_height_mips(tiles, toffs, th, heights, cols)
    assert got is tiles  # in place
    assert np.array_equal(np.asarray(want), got.numpy())
    fresh = thf.build_height_mips(heights, tile_log=tile_log, device="cpu")
    assert torch.equal(fresh[0], got)


@pytest.mark.parametrize("name", SETS)
def test_plain_walk_equals_jax(world, name):
    start, d, kw, _ = _ray_set(world, name)
    want = _jax_cast(world, start, d, **kw)
    got = _port_cast(world, start, d, **kw)
    _assert_equals_jax(want, got)
    assert got["hit"].any() and not got["hit"].all()
    if "active" in kw:
        assert not got["hit"][~_t(kw["active"])].any()


@pytest.mark.parametrize("name", SETS)
def test_plain_walk_equals_the_svo_cast_lane_for_lane(world, name):
    """Against the port's own SVO cast; a capped cast is strict here and
    advisory there, so K2's hits are held to the cap first."""
    start, d, kw, budget = _ray_set(world, name)
    w = world["w"]
    svo = ttr.svo_raycast(w.table, w.root, w.height, _t(start), _t(d),
                          **{k: (_t(v) if isinstance(v, np.ndarray) else v)
                             for k, v in kw.items()})
    if "distance" in kw:
        svo["hit"] = svo["hit"] & (svo["t"] <= _t(kw["distance"]))
    got = _port_cast(world, start, d, **kw)
    assert _mismatch(svo, got) <= budget


def test_degenerate_heightfields_equal_jax():
    """All-empty and all-solid columns, a world of one tile."""
    n = 16
    start, d = _aimed(np.random.default_rng(31), 512, n)
    for fill, expect in ((0, "none"), (n, "all")):
        heights = np.full((n, n), fill, np.uint32)
        flat, offs, h = jhf.build_height_mips(heights)
        want = jhf.hf_raycast(flat, offs, h, jnp.asarray(start),
                              jnp.asarray(d))
        pack = thf.build_height_mips(heights, device="cpu")
        got = thf.hf_raycast(*pack, _t(start), _t(d))
        _assert_equals_jax(want, got)
        assert got["hit"].all() if expect == "all" else not got["hit"].any()


def _grid_starts(rng, B):
    """Rays from integer points, half of them on the floor y = 0 and some
    on the faces x, z = 0 or N, with a third of the direction components
    zero: starts on a (mirrored) low face, whose entry t is -0.0."""
    start = rng.integers(0, N + 1, (B, 3)).astype(np.float32)
    start[:, 1] = np.where(rng.random(B) < 0.5, 0.0, rng.integers(0, 24, B))
    d = rng.standard_normal((B, 3)).astype(np.float32)
    d[rng.random((B, 3)) < 0.3] = 0.0
    d[np.abs(d).sum(1) == 0, 1] = 1.0
    return start, d / np.linalg.norm(d, axis=1, keepdims=True)


def test_starts_on_the_low_face_equal_jax_bit_for_bit(world):
    """A start on the (mirrored) low face enters at t = -0.0; with t == 0
    hits kept, the walk's first column test can hit at t0 = max(-0.0,
    0.0), which is +0.0 in JAX and so in the port: every output compared
    by its bits."""
    start, d = _grid_starts(np.random.default_rng(41), 2048)
    want = _jax_cast(world, start, d, skip_t0=False)
    got = _port_cast(world, start, d, skip_t0=False)
    for k in KEYS:
        w = np.asarray(want[k])
        assert np.array_equal(w.view(np.uint8), got[k].numpy().view(np.uint8)), k
    at0 = np.asarray(want["hit"]) & (np.asarray(want["t"]) == 0.0)
    assert at0.sum() > 100 and not got["hit"].all()


@pytest.mark.parametrize("tile_log,init_desc", [(1, 0), (2, 0), (3, 1),
                                                (3, 2), (2, 5)])
def test_tile_size_and_start_level_change_no_bit(world, tile_log, init_desc):
    """The pack's tile size and the walk's start level are choices of
    schedule: every output equals the default walk's, and JAX's."""
    rng = np.random.default_rng(29)
    start = rng.uniform(-0.25 * N, 1.25 * N, (4096, 3)).astype(np.float32)
    d = _rand_dirs(rng, 4096)
    base = _port_cast(world, start, d)
    pack = thf.build_height_mips(world["heights"], tile_log=tile_log,
                                 device="cpu")
    got = _port_cast(world, start, d, pack=pack, init_desc=init_desc)
    for k in KEYS:
        assert torch.equal(base[k], got[k]), k
    _assert_equals_jax(_jax_cast(world, start, d), got)


def test_t_min_resume_is_exact_and_equals_jax(world):
    """Resumed anywhere in certified air (a random fraction of each lane's
    own hit t; anywhere along the first diagonal for a miss), the walk
    equals the full walk in every output."""
    rng = np.random.default_rng(29)
    B = 4096
    start, d = _aimed(rng, B)
    full = _port_cast(world, start, d)
    hit, t_full = full["hit"].numpy(), full["t"].numpy()
    assert hit.sum() > B // 4
    frac = rng.uniform(0.0, 1.0, B).astype(np.float32)
    # origins below their column's height are in solid at every t_min > 0
    xz = np.floor(start).astype(np.int64)
    inb = np.all((xz >= 0) & (xz < N), axis=1)
    colh = np.where(inb, world["heights"][np.clip(xz[:, 0], 0, N - 1),
                                          np.clip(xz[:, 2], 0, N - 1)], 0.0)
    air0 = ~inb | (start[:, 1] >= colh)
    t_min = np.where(hit, frac * t_full, frac * N)
    t_min = np.where(air0, t_min, 0.0).astype(np.float32)
    for init_desc in (0, 3):
        got = _port_cast(world, start, d, t_min=t_min, init_desc=init_desc)
        for k in KEYS:
            assert torch.equal(full[k], got[k]), (k, init_desc)
    _assert_equals_jax(_jax_cast(world, start, d, t_min=t_min), got)


def _edited_world():
    """A dig of 2x2 top voxels and a white block above it: the edited
    node table, the PRE-edit packs and the bounds box."""
    space = jgen.generate(log2_size=LOG2, verbose=False, backend="python")
    h0 = np.asarray(space.heights).copy()
    cx, cz = np.unravel_index(np.argmax(h0[8:56, 8:56]), (48, 48))
    cx, cz = int(cx) + 8, int(cz) + 8
    top = int(h0[cx, cz])
    edits = [(cx + dx, top - 1, cz + dz) for dx in range(2) for dz in range(2)]
    for p in edits:
        space.set(p, None)
    space.set((cx, top + 2, cz), (1.0, 1.0, 1.0))
    edits.append((cx, top + 2, cz))
    dev = space.serialize()
    bounds = np.stack([np.min(edits, axis=0).astype(np.float32) - 1.0,
                       np.max(edits, axis=0).astype(np.float32) + 2.0])
    return dev, h0, bounds, np.array([cx + 0.5, top + 0.5, cz + 0.5],
                                     np.float32)


def test_edited_world_hybrid_equals_svo_cast_and_jax():
    dev, h0, bounds, tgt = _edited_world()
    w = tsvo.upload(dev.table, dev.root, dev.height, "cpu")
    rng = np.random.default_rng(17)
    B = 4096
    start = np.stack([rng.uniform(8, 56, B), rng.uniform(10, 60, B),
                      rng.uniform(8, 56, B)], -1).astype(np.float32)
    d = _rand_dirs(rng, B)
    d[:256] = tgt[None] - start[:256]  # straight at the edits
    d[:256] /= np.linalg.norm(d[:256], axis=-1, keepdims=True)

    pack = thf.build_height_mips(h0, device="cpu")
    hyb = thf.hf_raycast_edited(*pack, w.table, w.root, bounds, _t(start),
                                _t(d))
    ref = ttr.svo_raycast(w.table, w.root, w.height, _t(start), _t(d))
    n_aff = int(hyb["from_svo"].sum())
    assert 0 < n_aff < B // 4
    assert _mismatch(ref, hyb) <= 2
    aff_hit = hyb["from_svo"] & hyb["hit"]
    assert (hyb["node"][aff_hit] >= 0).all()
    assert (hyb["node"][~hyb["from_svo"]] == -1).all()

    flat, offs, hh = jhf.build_height_mips(h0)
    want = jhf.hf_raycast_edited(
        flat, offs, hh, jnp.asarray(dev.table.view(np.int32)),
        np.int32(dev.root), jnp.asarray(bounds), jnp.asarray(start),
        jnp.asarray(d))
    assert np.array_equal(np.asarray(want["from_svo"]),
                          hyb["from_svo"].numpy())
    for k in ("hit", "t", "normal", "node"):
        assert np.array_equal(np.asarray(want[k]), hyb[k].numpy()), k
    # a list of boxes and a lane mask: unaffected lanes keep the walk
    act = _t(rng.random(B) < 0.5)
    two = np.stack([bounds, bounds + 100.0])
    hyb2 = thf.hf_raycast_edited(*pack, w.table, w.root, two, _t(start),
                                 _t(d), active=act)
    assert torch.equal(hyb2["hit"], hyb["hit"] & act)
    assert not hyb2["from_svo"][~act].any()


def _frame_camera(world, cam_mod):
    return cam_mod.Camera(
        pos=(0.62 * N, float(world["heights"].max()) + 5.0, 0.35 * N),
        yaw=2.2, pitch=-0.3)


def test_frame_cast_equals_svo_cast_and_jax(world):
    W, H = 48, 32
    cam = _frame_camera(world, tcam)
    op = np.asarray(cam.pos, np.float32)
    rgb = (0.3, 0.62, 0.24)
    fr = thf.hf_frame_cast(*world["tpack"], op, cam.basis(), W, H, rgb,
                           terrain_node=77)
    o, d = tcam.generate_rays(cam, W, H, device="cpu")
    w = world["w"]
    rr = ttr.svo_raycast(w.table, w.root, w.height, o, d)
    assert _mismatch({k: rr[k].reshape(-1, *rr[k].shape[2:]) for k in KEYS},
                     {k: fr[k].reshape(-1, *fr[k].shape[2:])
                      for k in KEYS}) == 0
    hit = fr["hit"]
    assert hit.any() and not hit.all()
    assert (fr["node"][hit] == 77).all() and (fr["node"][~hit] == -1).all()
    assert torch.allclose(fr["rgb"][hit], torch.tensor(rgb))
    assert (fr["rgb"][~hit] == 0).all() and (fr["t"][~hit] == 0).all()
    fr2 = thf.hf_frame_cast(*world["tpack"], op, cam.basis(), W, H, rgb,
                            ray_dirs=d)
    assert torch.equal(fr2["t"], fr["t"])

    jc = _frame_camera(world, jcam)
    flat, offs, h = world["jpack"]
    want = jhf.hf_frame_cast(flat, offs, h, op, jc.basis(), W, H,
                             terrain_rgb=rgb, terrain_node=77)
    for k in ("hit", "t", "normal", "node", "rgb", "voxel"):
        assert np.array_equal(np.asarray(want[k]), fr[k].numpy()), k


def test_frame_cast_equals_jax_on_one_direction_set(world):
    """The case above with both packages handed one direction set through
    ``ray_dirs=`` (the pixel centres and a jittered set, made by the
    port), so no last bit of a direction differs: every output equal by
    bits."""
    W, H = 48, 32
    cam = _frame_camera(world, tcam)
    jc = _frame_camera(world, jcam)
    op = np.asarray(cam.pos, np.float32)
    rgb = (0.3, 0.62, 0.24)
    _, centres = tcam.generate_rays(cam, W, H, device="cpu")
    jitter = torch.from_numpy(
        np.random.default_rng(29).random((H, W, 2), np.float32))
    _, jittered = tcam.generate_rays(cam, W, H, jitter=jitter, device="cpu")
    flat, offs, h = world["jpack"]
    for d in (centres, jittered):
        got = thf.hf_frame_cast(*world["tpack"], op, cam.basis(), W, H, rgb,
                                terrain_node=77, ray_dirs=d)
        want = jhf.hf_frame_cast(flat, offs, h, op, jc.basis(), W, H,
                                 terrain_rgb=rgb, terrain_node=77,
                                 ray_dirs=jnp.asarray(d.numpy()))
        assert got["hit"].any() and not got["hit"].all()
        for k in ("hit", "t", "normal", "node", "rgb", "voxel"):
            assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k


def test_frame_cast_equals_raster_cast_exact(world):
    """The two primary engines of a terrain world give one frame."""
    W, H = 48, 32
    cam = _frame_camera(world, tcam)
    op = np.asarray(cam.pos, np.float32)
    dev = world["dev"]
    soup = tboxes.extract_boxes(dev)
    soup_t = trs.soup_to_device(soup.lo, soup.size, soup.leaf, soup.rgb, "cpu")
    w = world["w"]
    want = trs.raster_cast_exact(*soup_t, op, cam.basis(), LOG2, W, H,
                                 table=w.table, root=w.root)
    fr = thf.hf_frame_cast(*world["tpack"], op, cam.basis(), W, H,
                           soup.rgb[0])
    for k in ("hit", "t", "normal", "rgb"):
        assert torch.equal(want[k], fr[k]), k


def test_wrapper_dispatches_on_the_device_and_checks_before_launch(world):
    """CPU tensors take the plain version; the CUDA path raises on what
    the kernel does not take, before any launch, so it is testable
    without a card; any other device raises."""
    tiles, offs, h = world["tpack"]
    start, d = torch.zeros((1, 3)), torch.ones((1, 3))
    one = torch.ones((1,))
    with pytest.raises(ValueError, match="tiles"):
        thf._hf_raycast_cuda(tiles[:, :8], offs, h, start, d, one, True,
                             None, None, 0, one)
    with pytest.raises(ValueError, match="tiles"):
        thf._hf_raycast_cuda(tiles.double(), offs, h, start, d, one, True,
                             None, None, 0, one)
    with pytest.raises(ValueError, match="height"):
        thf.hf_raycast(tiles, offs, 0, start, d)
    with pytest.raises(ValueError, match="device"):
        thf.hf_raycast(tiles, offs, h, start, d.to("meta"))
    # a tile_log the kernel has no instantiation for, and a pack whose
    # float index overflows 32 bits (on the meta device: no storage)
    pack4 = thf.build_height_mips(world["heights"], tile_log=4, device="cpu")
    with pytest.raises(ValueError, match="tile_log 4"):
        thf._hf_raycast_cuda(*pack4, start, d, one, True, None, None, 0, one)
    meta = [x.to("meta") for x in (start, d, one)]
    with pytest.raises(ValueError, match="32-bit"):
        thf._hf_raycast_cuda(torch.empty((1 << 25, 64), device="meta"), offs,
                             h, meta[0], meta[1], meta[2], True, None, None,
                             0, meta[2])
    steps = thf.plain_lane_steps
    r = thf.hf_raycast(tiles, offs, h, torch.tensor([20.5, 60.0, 20.5]),
                       torch.tensor([[0.0, -1.0, 0.0]]))
    assert r["hit"].all() and thf.plain_lane_steps > steps
    assert profiling.counts().get("launches.hf_cast", 0) == 0


@pytest.mark.parametrize("name", ["airborne", "surface bounce", "capped"])
def test_plain_walk_counts_its_steps_by_lane_and_level(world, name):
    """The plain version's record of its walk: the lane-steps by level
    sum to what ``plain_lane_steps`` counted, and so do the per-lane
    steps and the steps by move; every walking lane ends once; the
    longest lane took as many steps as the loop ran."""
    start, d, kw, _ = _ray_set(world, name)
    dist = _t(kw.get("distance", np.full(len(d), ttr.FAR, np.float32)))
    walk = {}
    before = thf.plain_lane_steps
    thf.hf_raycast_plain(*world["tpack"], _t(start), _t(d), dist, walk=walk)
    steps = thf.plain_lane_steps - before
    assert steps > 0 and sum(walk["by_level"].values()) == steps
    assert int(walk["per_lane"].sum()) == steps
    assert sum(walk["moves"].values()) == steps
    assert walk["moves"]["end"] == int((walk["per_lane"] > 0).sum())
    assert int(walk["per_lane"].max()) == walk["iterations"]
    assert walk["per_lane"].shape == (len(start),)
    assert set(walk["by_level"]) <= set(range(0, LOG2, 3))
