"""CUDA kernels K1 (fog march), K2 (SVO cast), K3 (resolve fold), K4
(heightfield walk), K5 (envelope lookup), K6 (beam walk), K7 (beam
resolve), K8 (bit-grid DDA), K9 (the bounce loop) and K10 (the envelope
build) against their plain PyTorch versions, and
the terrain built on the card against the CPU's, on the card. Every test
skips when
torch sees no CUDA device (decided inside the fixture, not at import).

Run on the card from the repository root (the repository's conftest
imports JAX, which the card's machine lacks):
    python -m pytest tests/test_torch_cuda_kernels.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from voxtracer_torch.core.spectra import fog_density
from voxtracer_torch.kernels import fog, heightfield, resolve, traverse
from voxtracer_torch.utils import profiling
from voxtracer_torch.world import svo, worldgen

torch.set_num_threads(2)


def _launched(kernel):
    """The kernel's launches so far, from the port's counter registry."""
    return profiling.counts().get(f"launches.{kernel}", 0)


@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels run only on the card")
    return torch.device("cuda")


@pytest.mark.parametrize("B,steps", [(1, 64), (100, 16), (1000, 64),
                                     (65536, 64)])
def test_fog_march_matches_plain(cuda, B, steps):
    rng = np.random.default_rng(B)
    start = torch.as_tensor(rng.random((B, 3), np.float32) * 1024, device=cuda)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=cuda)
    dens = fog_density(torch.as_tensor(rng.random(B, np.float32), device=cuda))
    y0 = torch.as_tensor(-np.log(1 - rng.random(B, np.float32)), device=cuda)
    before = _launched("fog_march")
    code_k, t_k = fog.fog_march(start, d, dens, y0, n_steps=steps)
    assert _launched("fog_march") == before + 1
    code_p, t_p = fog.fog_march_plain(start, d, dens, y0, n_steps=steps)
    torch.cuda.synchronize()
    assert torch.equal(code_k, code_p)
    assert torch.equal(t_k, t_p)  # both without FMA, same expression order


@pytest.mark.parametrize("B,steps,frac", [(1, 64, 1.0), (100, 16, 0.5),
                                          (1000, 64, 0.1), (4097, 256, 0.01),
                                          (65536, 64, 0.5)])
def test_fog_march_masked_matches_plain(cuda, B, steps, frac):
    """Masked lanes: the kernel equals the plain version (the unmasked
    march on active lanes, code 0 and t 0 elsewhere); ragged sizes."""
    rng = np.random.default_rng(B + steps)
    start = torch.as_tensor(rng.random((B, 3), np.float32) * 1024, device=cuda)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=cuda)
    dens = fog_density(torch.as_tensor(rng.random(B, np.float32), device=cuda))
    y0 = torch.as_tensor(-np.log(1 - rng.random(B, np.float32)), device=cuda)
    active = torch.as_tensor(rng.random(B) < frac, device=cuda)
    before = _launched("fog_march")
    code_k, t_k = fog.fog_march(start, d, dens, y0, n_steps=steps,
                                active=active)
    assert _launched("fog_march") == before + 1
    code_p, t_p = fog.fog_march_plain(start, d, dens, y0, n_steps=steps,
                                      active=active)
    torch.cuda.synchronize()
    assert torch.equal(code_k, code_p)
    assert torch.equal(t_k, t_p)
    assert (code_k[~active] == 0).all() and (t_k[~active] == 0).all()
    # the kernel's own counts: a march the scatter-free test settled does
    # not scatter and marches no segment
    n_set, segs = fog.last_work.tolist()
    n_act = int(active.sum())
    assert n_set + int((code_k == 2).sum()) <= n_act
    assert segs <= steps * (n_act - n_set)


def test_fog_march_rejects_bad_input(cuda):
    x = torch.zeros((4, 3), device=cuda)
    with pytest.raises(ValueError):
        fog.fog_march(x, x, torch.zeros(4, device=cuda, dtype=torch.float64),
                      torch.zeros(4, device=cuda))
    with pytest.raises(ValueError):  # a float mask
        fog.fog_march(x, x, torch.zeros(4, device=cuda),
                      torch.zeros(4, device=cuda),
                      active=torch.ones(4, device=cuda))
    with pytest.raises(ValueError):  # beyond the kernel's fraction table
        fog.fog_march(x, x, torch.zeros(4, device=cuda),
                      torch.zeros(4, device=cuda), n_steps=fog.MAX_STEPS + 1)


@pytest.fixture(scope="module")
def world(cuda):
    dev = worldgen.generate(log2_size=7, verbose=False, device=cuda).serialize()
    return svo.upload(dev.table, dev.root, dev.height, cuda)


@pytest.mark.parametrize("kind", ["random", "capped", "active"])
def test_svo_cast_matches_plain_bit_for_bit(cuda, world, kind):
    rng = np.random.default_rng(7)
    B = 32768
    n = float(1 << world.height)
    start = torch.as_tensor(rng.random((B, 3), np.float32) * n, device=cuda)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[: B // 16, 1] = 0.0
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=cuda)
    dist = torch.full((B,), traverse.FAR, device=cuda)
    active = None
    if kind != "random":
        dist = torch.as_tensor(rng.random(B, np.float32) * n, device=cuda)
    if kind == "active":
        active = torch.as_tensor(rng.random(B) < 0.5, device=cuda)
    w = (world.table, world.root, world.height)
    before = _launched("svo_cast")
    k = traverse.svo_raycast(*w, start, d, dist, active=active)
    assert _launched("svo_cast") == before + 1
    p = traverse.svo_raycast_plain(*w, start, d, dist, active=active)
    torch.cuda.synchronize()
    for key in ("hit", "t", "node", "normal", "voxel"):
        assert torch.equal(k[key], p[key]), key
    assert k["hit"].any()


@pytest.mark.parametrize("B,frac", [(1, 1.0), (37, 0.5), (1000, 0.01),
                                    (32769, 0.01), (100003, 0.1)])
def test_svo_cast_sparse_and_ragged_bit_for_bit(cuda, world, B, frac):
    """Sparse masks and sizes that are no multiple of a warp, a block or
    a chunk: the lane fetch writes every inactive lane's outputs and walks
    every active one."""
    rng = np.random.default_rng(B)
    n = float(1 << world.height)
    start = torch.as_tensor(rng.random((B, 3), np.float32) * n, device=cuda)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=cuda)
    dist = torch.as_tensor(np.where(rng.random(B) < 0.5, traverse.FAR,
                                    rng.random(B) * n).astype(np.float32),
                           device=cuda)
    active = torch.as_tensor(rng.random(B) < frac, device=cuda)
    w = (world.table, world.root, world.height)
    k = traverse.svo_raycast(*w, start, d, dist, active=active)
    p = traverse.svo_raycast_plain(*w, start, d, dist, active=active)
    torch.cuda.synchronize()
    for key in ("hit", "t", "node", "normal", "voxel"):
        assert torch.equal(k[key], p[key]), key
    assert not k["hit"][~active].any()


@pytest.mark.parametrize("R,K", [(64, 16), (512, 16), (64, 104), (512, 256),
                                 (64, 1024), (512, 1024), (64, 1500)])
def test_resolve_fold_matches_plain_bit_for_bit(cuda, R, K):
    """Random records (a fifth invalid), a carry holding some hits and a
    camera inside the first box of every tile, capped and not; K from one
    quarter of a stage of the kernel (64 candidates) to 24 stages."""
    rng = np.random.default_rng(R + K)
    N = 48
    lo = rng.integers(0, 120, (N, K, 3))
    size = rng.integers(1, 9, (N, K, 3))
    lo[:, 0], size[:, 0] = 60, 8
    rows = np.zeros((N, K, 8), np.int32)
    rows[..., 1] = rng.integers(0, 1 << 20, (N, K))
    rows[..., 2] = lo[..., 0] | (lo[..., 1] << 16)
    rows[..., 3] = lo[..., 2] | (size[..., 0] << 16)
    rows[..., 4] = size[..., 1] | (size[..., 2] << 16)
    rows[..., 5:8] = rng.random((N, K, 3), np.float32).view(np.int32)
    d = rng.normal(size=(N, R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t0 = np.where(rng.random((N, R)) < 0.3, rng.random((N, R)) * 90,
                  np.inf).astype(np.float32)
    g = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)  # noqa: E731,E501
    args = (g(t0), g(np.where(np.isfinite(t0), 8, -1).astype(np.int32)),
            g(np.zeros((N, R, 3), np.float32)), g(rows),
            g(rng.random((N, K)) >= 0.2), g(d))
    cam = np.float32([63.5, 61.25, 64.75])
    for dist in (1.0e12, 40.0):
        before = _launched("resolve_fold")
        k = resolve.resolve_fold(*args, cam, 7, dist)
        assert _launched("resolve_fold") == before + 1
        p = resolve.resolve_fold_plain(*args, cam, 7, dist)
        torch.cuda.synchronize()
        for a, b in zip(k, p):
            assert torch.equal(a, b)
        assert (k[0] < args[0]).any()
    # the shared-list form (near pre-pass): tile stride 0
    k = resolve.resolve_fold(*args[:3], args[3][0], args[4][0], args[5], cam,
                             7, 1.0e12)
    p = resolve.resolve_fold_plain(*args[:3], args[3][0], args[4][0],
                                   args[5], cam, 7, 1.0e12)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def _segments(rng, NT, db, most):
    """A sorted pair array of random boxes: each tile a segment of
    0..most records with rising keys, then the sentinel; and the starts."""
    counts = rng.integers(0, most, NT)
    counts[-1] = most - 1
    tile = np.repeat(np.arange(NT), counts)
    n = tile.size + 1
    lo = rng.integers(0, 120, (n, 3))
    size = rng.integers(1, 9, (n, 3))
    rows = np.zeros((n, 8), np.int32)
    rows[:, 1] = rng.integers(0, 1 << 20, n)
    rows[:, 2] = lo[:, 0] | (lo[:, 1] << 16)
    rows[:, 3] = lo[:, 2] | (size[:, 0] << 16)
    rows[:, 4] = size[:, 1] | (size[:, 2] << 16)
    rows[:, 5:8] = rng.random((n, 3), np.float32).view(np.int32)
    rows[:-1, 0] = (tile << db) | np.arange(tile.size)
    rows[-1] = 0
    rows[-1, 0] = NT << db
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return rows, start


def _fold_seg_forced(carry, spairs, tiles, start, k, db, quantum, d, ok, cam,
                     tree_height, ray_tile, spans):
    """``resolve_fold_seg``'s launch with rays a thread and spans forced
    (the wrapper leaves both to the launcher)."""
    from voxtracer_torch.kernels import build

    S = start.shape[0]
    tile_max = torch.full((S,), -torch.inf, device=start.device)
    next_dmin = torch.empty((S,), device=start.device)
    err = build.library().voxt_resolve_fold_seg(
        *(c.data_ptr() for c in carry), spairs.data_ptr(), spairs.shape[0],
        None if tiles is None else tiles.data_ptr(), start.data_ptr(), S, k,
        db, quantum, d.data_ptr(), ok.data_ptr(), tile_max.data_ptr(),
        next_dmin.data_ptr(), *(float(c) for c in cam),
        float(1 << tree_height), 1.0e12, carry[0].shape[1], ray_tile, spans,
        torch.cuda.current_stream().cuda_stream)
    build.check(err, "resolve_fold_seg")
    return tile_max, next_dmin


@pytest.mark.parametrize("ray_tile,spans", [(0, 0), (2, 1), (4, 4), (2, 16)])
@pytest.mark.parametrize("R,k,consumed,listed", [
    (64, 16, 0, None), (512, 16, 0, None), (64, 104, 16, 1470),
    (512, 256, 120, 92), (512, 1024, 120, 5), (64, 1024, 10, 1),
    (192, 100, 3, 300), (70, 37, 0, 0)])
def test_resolve_fold_seg_matches_plain_bit_for_bit(cuda, R, k, consumed,
                                                    listed, ray_tile, spans):
    """The segment form on a random sorted pair array: the main fold over
    every tile, widen rounds over tile lists of the smoke pose's lengths
    (1,470, 92, 5) and of length 1 and 0, segments that end inside the
    span, reads that clamp at the last record; the carry in place, the
    unlisted tiles untouched, the per-tile max over real pixels. (0, 0)
    goes through the wrapper, whose launcher picks its grid; the others
    force rays a thread and spans at the C entry."""
    if ray_tile == 4 and R % 128:
        ray_tile = 2
    rng = np.random.default_rng(R + k)
    NT, db = 2000, 18
    rows, seg_start = _segments(rng, NT, db, 300)
    g = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)  # noqa: E731,E501
    spairs, seg_start = g(rows), g(seg_start)
    d = rng.normal(size=(NT, R, 3)).astype(np.float32)
    d[: NT // 2] = np.abs(d[: NT // 2])  # half the tiles in one octant
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t0 = np.where(rng.random((NT, R)) < 0.3, rng.random((NT, R)) * 90,
                  np.inf).astype(np.float32)
    carry = (g(t0), g(np.where(np.isfinite(t0), 8, -1).astype(np.int32)),
             g(rng.random((NT, R, 3), np.float32)))
    ok = rng.random((NT, R)) < 0.9
    ok[3] = False
    ok = g(ok)
    if listed is None:
        tiles, start = None, seg_start
    else:
        tiles = np.sort(rng.choice(NT, listed, replace=False))
        if listed == 1:
            tiles[0] = NT - 1
        tiles = g(tiles.astype(np.int32))
        start = (seg_start[tiles.long()] + consumed).to(torch.int32)
    cam = np.float32([63.5, 61.25, -4.75])
    got = tuple(c.clone() for c in carry)
    want = tuple(c.clone() for c in carry)
    if (ray_tile, spans) == (0, 0) or listed == 0:
        before = _launched("resolve_fold")
        got_out = resolve.resolve_fold_seg(*got, spairs, tiles, start, k, db,
                                           0.375, g(d), ok, cam, 7, 1.0e12)
        assert _launched("resolve_fold") == before + (listed != 0)
    else:
        got_out = _fold_seg_forced(got, spairs, tiles, start, k, db, 0.375,
                                   g(d), ok, cam, 7, ray_tile, spans)
    want_out = resolve.resolve_fold_seg_plain(*want, spairs, tiles, start, k,
                                              db, 0.375, g(d), ok, cam, 7,
                                              1.0e12)
    torch.cuda.synchronize()
    for a, b in zip(got + got_out, want + want_out):
        assert torch.equal(a, b)
    if listed != 0:
        assert (got[0] < carry[0]).any()


@pytest.mark.parametrize("ray_tile,spans", [(2, 1), (2, 4), (4, 2), (4, 16)])
def test_resolve_fold_settings_match_plain(cuda, ray_tile, spans):
    """The explicit form under every ray tile and forced span counts (at
    the C entry, as the A/B tool's sweep calls it), K not a multiple of
    the stage or the spans, every octant in a warp."""
    from voxtracer_torch.kernels import build
    from voxtracer_torch.tools.kernel_ab import _Fold

    rng = np.random.default_rng(spans)
    N, R, K = 40, 256, 333
    rows, _ = _segments(rng, 1, 18, N * K + 1)
    rows = rows[: N * K].reshape(N, K, 8)
    d = rng.normal(size=(N, R, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    g = lambda a: torch.as_tensor(np.ascontiguousarray(a), device=cuda)  # noqa: E731,E501
    args = (torch.full((N, R), torch.inf, device=cuda),
            torch.full((N, R), -1, dtype=torch.int32, device=cuda),
            torch.zeros((N, R, 3), device=cuda), g(rows),
            g(rng.random((N, K)) >= 0.2), g(d))
    cam = np.float32([63.5, 61.25, 64.75])
    case = _Fold(None, build.library(), args[:3], *args[3:], cam, 7)
    case.run_new((ray_tile, spans))
    k = case.outs[1]
    p = resolve.resolve_fold_plain(*args, cam, 7, 1.0e12)
    torch.cuda.synchronize()
    for a, b in zip(k, p):
        assert torch.equal(a, b)
    assert torch.isfinite(k[0]).any()


@pytest.fixture(scope="module")
def terrain(cuda):
    space = worldgen.generate(log2_size=7, verbose=False, device=cuda)
    dev = space.serialize()
    return (svo.upload(dev.table, dev.root, dev.height, cuda),
            np.asarray(space.heights))


@pytest.mark.parametrize("tile_log", heightfield.TILE_LOGS)
@pytest.mark.parametrize("kind", ["random", "capped", "active", "kept t0",
                                  "resumed", "low face"])
def test_hf_cast_matches_plain_bit_for_bit(cuda, terrain, kind, tile_log):
    """Every output compared by its bits ("low face": starts on integer
    points, half on the floor, with zero direction components and t == 0
    hits kept, so some hit at t0 = max(-0.0, 0.0) = +0.0)."""
    world, heights = terrain
    pack = heightfield.build_height_mips(heights, tile_log=tile_log,
                                         device=cuda)
    rng = np.random.default_rng(11)
    B = 32768
    n = float(1 << world.height)
    start = rng.random((B, 3), np.float32) * n * 1.2 - 0.1 * n
    sx, sz = np.nonzero(heights >= 2)  # a quarter start inside solid
    pick = rng.integers(0, len(sx), B // 4)
    start[: B // 4] = np.stack(
        [sx[pick] + 0.5, heights[sx[pick], sz[pick]] * 0.5, sz[pick] + 0.5],
        -1)
    start = torch.as_tensor(start.astype(np.float32), device=cuda)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[: B // 16, 1] = 0.0
    if kind == "low face":
        g = rng.integers(0, int(n) + 1, (B, 3)).astype(np.float32)
        g[:, 1] = np.where(rng.random(B) < 0.5, 0.0, rng.integers(0, 24, B))
        start = torch.as_tensor(g, device=cuda)
        d[rng.random((B, 3)) < 0.3] = 0.0
        d[np.abs(d).sum(1) == 0, 1] = 1.0
    d = torch.as_tensor(d / np.linalg.norm(d, axis=-1, keepdims=True),
                        device=cuda)
    dist = torch.full((B,), traverse.FAR, device=cuda)
    active = t_min = None
    skip_t0, init_desc = kind not in ("kept t0", "low face"), 0
    if kind in ("capped", "active"):
        dist = torch.as_tensor(rng.random(B, np.float32) * n, device=cuda)
    if kind == "active":
        active = torch.as_tensor(rng.random(B) < 0.5, device=cuda)
    if kind == "resumed":
        # from the air: the walk may resume only where the ray is in air
        start[:, 1] = start[:, 1].abs() + float(heights.max()) + 1.0
        full = heightfield.hf_raycast(*pack, start, d, dist)
        t_min = torch.where(full["hit"], full["t"], n) * torch.as_tensor(
            rng.random(B, np.float32), device=cuda)
        init_desc = 2
    before = _launched("hf_cast")
    k = heightfield.hf_raycast(*pack, start, d, dist, skip_t0=skip_t0,
                               active=active, t_min=t_min,
                               init_desc=init_desc)
    assert _launched("hf_cast") == before + 1
    p = heightfield.hf_raycast_plain(*pack, start, d, dist, skip_t0, active,
                                     t_min, init_desc)
    torch.cuda.synchronize()
    for key in ("hit", "t", "normal", "voxel"):
        a, b = k[key], p[key]
        if a.is_floating_point():
            a, b = a.view(torch.int32), b.view(torch.int32)
        assert torch.equal(a, b), key
    assert k["hit"].any() and not k["hit"].all()
    if kind == "low face":
        assert int((k["hit"] & (k["t"] == 0.0)).sum()) > 100
    if kind == "resumed":
        for key in ("hit", "t", "normal", "voxel"):
            assert torch.equal(k[key], full[key]), key
    if kind == "random":  # against K2, lane for lane up to edge grazes
        r = traverse.svo_raycast(world.table, world.root, world.height, start,
                                 d, dist)
        bad = (r["hit"] != k["hit"]) | (r["hit"] & k["hit"] & (
            (r["t"] != k["t"]) | (r["normal"] != k["normal"]).any(-1)
            | (r["voxel"] != k["voxel"]).any(-1)))
        assert int(bad.sum()) <= B // 10000


def test_hf_cast_rejects_bad_input(cuda, terrain):
    _, heights = terrain
    tiles, offs, h = heightfield.build_height_mips(heights, device=cuda)
    start = torch.zeros((4, 3), device=cuda)
    d = torch.ones((4, 3), device=cuda)
    with pytest.raises(ValueError, match="tiles"):
        heightfield.hf_raycast(tiles.cpu(), offs, h, start, d)
    with pytest.raises(ValueError, match="hmax_w"):
        heightfield.hf_raycast(tiles, offs, h, start, d,
                               hmax_w=torch.ones(1))
    before = _launched("hf_cast")
    pack4 = heightfield.build_height_mips(heights, tile_log=4, device=cuda)
    with pytest.raises(ValueError, match="tile_log"):
        heightfield.hf_raycast(*pack4, start, d)
    huge = torch.empty((1 << 25, 64), device=cuda)  # 2^31 floats
    with pytest.raises(ValueError, match="32-bit"):
        heightfield.hf_raycast(huge, offs, h, start, d,
                               hmax_w=torch.ones(1, device=cuda))
    del huge
    assert _launched("hf_cast") == before


def test_hf_cast_at_8192_matches_plain(cuda):
    """The reference's 8192^3 heightmap: a pack of 1,065,221 rows (68M
    floats, the largest indices the kernel forms in 32 bits); camera rays
    at the smoke pose and random rays, bit for bit the plain version."""
    from voxtracer_torch.core import camera as vcam

    heights = worldgen.heightmap(13, device=cuda)
    pack = heightfield.build_height_mips(heights, device=cuda)
    assert pack[0].shape[0] == 1_065_221
    cam = vcam.Camera(pos=vcam.DEFAULT_POSE.pos, yaw=vcam.DEFAULT_POSE.yaw,
                      pitch=vcam.DEFAULT_POSE.pitch)
    o, d = vcam.generate_rays(cam, 256, 144, device=cuda)
    rng = np.random.default_rng(13)
    B = 32768
    start = torch.as_tensor(rng.random((B, 3), np.float32) * 8192.0,
                            device=cuda)
    rd = rng.normal(size=(B, 3)).astype(np.float32)
    rd = torch.as_tensor(rd / np.linalg.norm(rd, axis=-1, keepdims=True),
                         device=cuda)
    for s, dd in ((o.expand(d.shape).reshape(-1, 3), d.reshape(-1, 3)),
                  (start, rd)):
        dist = torch.full((dd.shape[0],), traverse.FAR, device=cuda)
        k = heightfield.hf_raycast(*pack, s, dd, dist)
        p = heightfield.hf_raycast_plain(*pack, s.expand(dd.shape)
                                         .contiguous(), dd, dist)
        torch.cuda.synchronize()
        for key in ("hit", "t", "normal", "voxel"):
            assert torch.equal(k[key], p[key]), key
        assert k["hit"].any() and not k["hit"].all()


def _sky_env(cuda, tier):
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import skyline
    from voxtracer_torch.render.driver import Renderer

    heights = worldgen.heightmap(13, device=cuda)
    pack = heightfield.build_height_mips(heights, device=cuda)
    cam = vcam.Camera(pos=vcam.DEFAULT_POSE.pos, yaw=vcam.DEFAULT_POSE.yaw,
                      pitch=vcam.DEFAULT_POSE.pitch)
    env = skyline.build_skyline_env_device(
        skyline.sky_levels_from_hf(*pack), np.asarray(cam.pos, np.float64),
        **Renderer.SKY_TIERS[tier][0])
    return pack, cam, env


def _plain_env(pack, origin, bins=4096, ratio=16, K=64, d0=4.0,
               cls_step=1.0):
    """build_skyline_env_device with the plain build on the card."""
    from voxtracer_torch.kernels import skyline

    E = skyline._env_device(pack["flat"], pack["coarse"], origin,
                            pack["offsets"], bins, ratio, K, float(d0),
                            pack["height"], float(cls_step))
    g = (4.0 * (1 << pack["height"]) / d0) ** (1.0 / (K - 1.0))
    return dict(E=E, S=skyline.env_summary(E), d0=float(d0), g=float(g),
                bins=bins, K=K)


@pytest.fixture(scope="module")
def sky_packs(cuda):
    """The envelope pyramids of 128^3, 1024^3 and 8192^3 terrains (built
    on the card), each with its highest column."""
    from voxtracer_torch.kernels import skyline

    out = {}
    for lg in (7, 10, 13):
        h = worldgen.heightmap(lg, device=cuda)
        out[lg] = (skyline.sky_levels_from_hf(
            *heightfield.build_height_mips(h, device=cuda)), float(h.max()))
    return out


@pytest.mark.parametrize("where", ["pose", "edge", "inside", "above",
                                   "outside"])
@pytest.mark.parametrize("log2", [7, 10, 13])
@pytest.mark.parametrize("tier", [0, 1, 2])
def test_sky_env_matches_plain(cuda, sky_packs, tier, log2, where):
    """K10 against the plain build on the card at each of the Renderer's
    envelope tiers: E and S equal (torch.equal), one launch count a
    build; at the smoke pose, on the world's edge, inside a cell under
    the peaks, above all terrain and outside the grid."""
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import skyline
    from voxtracer_torch.render.driver import Renderer

    lv, top = sky_packs[log2]
    n = 1 << log2
    o = np.asarray(dict(
        pose=np.asarray(vcam.DEFAULT_POSE.pos) * n / 8192,
        edge=(0.0, top * 0.6, n * 0.45),
        inside=(n * 0.37 + 0.3, top * 0.7, n * 0.61 + 0.45),
        above=(n * 0.52, top + 9.5, n * 0.3),
        outside=(-0.4 * n, top + 30.0, n * 1.2))[where], np.float64)
    kw = Renderer.SKY_TIERS[tier][0]
    before = _launched("env_build")
    got = skyline.build_skyline_env_device(lv, o, **kw)
    assert _launched("env_build") == before + 1
    want = _plain_env(lv, o, **kw)
    torch.cuda.synchronize()
    assert torch.equal(got["E"], want["E"])
    assert torch.equal(got["S"], want["S"])
    assert (got["d0"], got["g"], got["bins"], got["K"]) \
        == (want["d0"], want["g"], want["bins"], want["K"])
    assert (got["E"] > -1e38).any()


def test_renderer_with_k10_equals_plain_build(cuda, monkeypatch):
    """A hf-only Renderer's preview_frame and sample with K10's envelope
    equal, bit for bit, those of a Renderer on the plain build: three
    rounds at one pose (tiers 0, 1 and 2 by its uses), then a new pose."""
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import skyline
    from voxtracer_torch.render.driver import Renderer

    monkeypatch.setattr(Renderer, "HF_FRAME_SIZE", 512)
    space = worldgen.generate(log2_size=9, verbose=False, device=cuda)
    p = vcam.DEFAULT_POSE
    cam = vcam.Camera(pos=tuple(np.asarray(p.pos) * 512 / 8192), yaw=p.yaw,
                      pitch=p.pitch)
    cam2 = vcam.Camera(pos=(cam.pos[0] + 10.0, cam.pos[1], cam.pos[2]),
                       yaw=p.yaw + 0.03, pitch=p.pitch)
    sun = np.array([0.8, 10.2743, 3.7])

    def run():
        r = Renderer(space.serialize(), 160, 96, seed=0, device=cuda)
        assert r._hf_only()
        outs, tiers = [], []
        for c in (cam, cam, cam, cam2):
            outs.append(r.preview_frame(c, sun).clone())
            r.sample(c, sun)
            outs.append(r.acc.buffer.clone())
            tiers.append(r._sky_env[2])
        return outs, tiers

    before = _launched("env_build")
    k10, tiers = run()
    assert tiers == [1, 1, 2, 1]
    assert _launched("env_build") == before + 5
    monkeypatch.setattr(skyline, "build_skyline_env_device", _plain_env)
    plain, _ = run()
    assert _launched("env_build") == before + 5
    torch.cuda.synchronize()
    for a, b in zip(k10, plain):
        assert torch.equal(a, b)


def _sky_orders(env, d, want):
    """K5 on the (S, H, W, 3) rays ``d`` in image order and flattened in
    lane order: one launch a call, the two equal by bits, rung counts as
    the plain version's ``want`` in all but 2 lanes of 4096 (t_min within
    1e-6 relative elsewhere). Returns the image order's t_min, flat."""
    from voxtracer_torch.kernels import skyline

    outs = []
    for dd in (d, d.reshape(-1, 3)):
        before = _launched("sky_tmin")
        got = skyline.skyline_env_tmin(env["E"], dd, env["d0"], env["g"],
                                       env["K"], summary=env["S"])
        assert _launched("sky_tmin") == before + 1
        assert got.shape == dd.shape[:-1]
        outs.append(got.reshape(-1))
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    off = (outs[0] - want).abs() > 1e-6 * want.abs()
    assert int(off.sum()) <= 2 * want.shape[0] // 4096
    return outs[0]


@pytest.mark.parametrize("tier", [0, 1, 2])
def test_sky_tmin_matches_plain(cuda, tier):
    """K5 on each of the Renderer's envelope tiers for an 8192^3 world's
    camera rays, in image order (pixel tiles) and lane order: rung counts
    as the plain version's in all but 2 lanes of 4096, t_min within 1e-6
    relative elsewhere (the card's atan2f/exp2f and torch's may round
    apart; usually none differ); the resumed walk equals the full walk."""
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import skyline

    pack, cam, env = _sky_env(cuda, tier)
    o, d = vcam.generate_rays(cam, 853, 480, device=cuda)
    want = skyline.skyline_env_tmin_plain(
        env["E"], d.reshape(-1, 3), *skyline._consts(8192, env["d0"],
                                                     env["g"]))
    got = _sky_orders(env, d[None].contiguous(), want)
    d = d.reshape(-1, 3).contiguous()
    start = o.reshape(-1, 3).contiguous()
    dist = torch.full((d.shape[0],), traverse.FAR, device=cuda)
    full = heightfield.hf_raycast(*pack, start, d, dist)
    resumed = heightfield.hf_raycast(*pack, start, d, dist, t_min=got,
                                     init_desc=3)
    for key in ("hit", "t", "normal", "voxel"):
        assert torch.equal(full[key], resumed[key]), key


@pytest.mark.parametrize("tier", [0, 1])
@pytest.mark.parametrize("S,W,H", [(8, 853, 480), (3, 101, 37)])
def test_sky_tmin_jittered_samples_match_plain(cuda, tier, S, W, H):
    """K5 on S jittered samples of a frame (the batch-8 call's primaries,
    and a ragged frame whose last sample group is part masked), in both
    lane orders, against the plain version (test above's budget)."""
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import skyline

    _, cam, env = _sky_env(cuda, tier)
    py, px = vcam.pixel_grid(W, H, cuda)
    ndc = vcam.pixel_ndc(px, py, W, H)
    jit = torch.as_tensor(np.random.default_rng(S).uniform(
        0, 1, (S, H, W, 2)).astype(np.float32), device=cuda)
    d = vcam.ray_directions(cam.basis(), ndc[None].expand(S, H, W, 2),
                            jitter=jit, height=H).contiguous()
    want = skyline.skyline_env_tmin_plain(
        env["E"], d.reshape(-1, 3), *skyline._consts(8192, env["d0"],
                                                     env["g"]))
    got = _sky_orders(env, d, want)
    assert (got > 0).float().mean() > 0.3


@pytest.fixture(scope="module")
def beam_world(cuda):
    from voxtracer_torch.kernels import beam

    dev = worldgen.generate(log2_size=7, verbose=False,
                            device="cpu").serialize()
    w = svo.upload(dev.table, dev.root, dev.height, cuda)
    aug = torch.from_numpy(beam.build_aug_table(dev.table, dev.solid_leaf))
    return w, aug.to(cuda)


@pytest.fixture(scope="module")
def beam_clutter(cuda):
    """A 32^3 random fill (height 5) and its augmented rows."""
    from voxtracer_torch.kernels import beam

    rng = np.random.default_rng(5)
    solid = rng.random((32, 32, 32)) < 0.2
    rgb = rng.random((32, 32, 32, 3)).astype(np.float32)
    rgb[~solid] = 0
    dev = svo.from_dense(solid, rgb).serialize()
    w = svo.upload(dev.table, dev.root, dev.height, cuda)
    aug = torch.from_numpy(beam.build_aug_table(dev.table, dev.solid_leaf))
    return w, aug.to(cuda)


def _bits_of(x):
    return x.contiguous().view(torch.uint8)


# (sides of each round on the state the kernel resumes)
BEAM_SIDES = dict(plain_then_kernel=("plain", "kernel", "kernel"),
                  kernel_then_plain=("kernel", "plain", "plain"))


@pytest.mark.parametrize("K,steps,case", [
    pytest.param(64, 512, "rounds", id="64-512"),
    pytest.param(8, 512, "rounds", id="8-512"),  # a pause every expansion
    pytest.param(16, 30, "rounds", id="16-30"),
    # 943 beams: groups past the last beam in a warp and a block
    pytest.param(64, 512, "ragged", id="ragged"),
    # the kernel resumes the plain walk's state, and the other way round
    pytest.param(8, 24, "plain_then_kernel", id="plain-then-kernel"),
    pytest.param(8, 24, "kernel_then_plain", id="kernel-then-plain"),
    # a third of the beams dead before the first call
    pytest.param(8, 24, "dead", id="dead"),
    # K7 on beams without a candidate and on cut lists
    pytest.param(64, 512, "truncated", id="truncated"),
    # the 32^3 random fill (height 5)
    pytest.param(16, 512, "height5", id="height5"),
])
def test_beam_walk_and_resolve_match_plain(cuda, beam_world, beam_clutter, K,
                                           steps, case):
    """K6 and K7 against their plain versions over three resumed rounds
    of a 1080p-shaped tile grid: candidates, state and resolve by bits,
    the resolve also into the running best of the rounds before."""
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import beam

    if case == "height5":
        w, aug = beam_clutter
        cam = vcam.Camera(pos=(5.3, 30.1, 4.2), yaw=0.8, pitch=-0.7)
    else:
        w, aug = beam_world
        cam = vcam.Camera(pos=(80.3, 70.2, 20.1), yaw=2.6, pitch=-0.25)
    _, d = vcam.generate_rays(cam, 328 if case == "ragged" else 320, 184,
                              device=cuda)
    dt = beam._group(d, 8).contiguous()
    o = torch.tensor(cam.pos, dtype=torch.float32, device=cuda)
    ob = o.expand(dt.shape[0], 3)
    pre = beam._beam_bounds(w.height, ob, ob, torch.amin(dt, 1),
                            torch.amax(dt, 1))
    init = beam._initial_state(w.root, w.height, pre["incoherent"])
    if case == "dead":
        init["alive"][::3] = False
    st_k = {k: v.clone() for k, v in init.items()}
    st_p = {k: v.clone() for k, v in init.items()}
    gen = torch.Generator(device="cpu").manual_seed(3)
    hits = cut = 0
    best_k = best_p = None
    for side in BEAM_SIDES.get(case, ("kernel",) * 3):
        before = (_launched("beam_walk"), _launched("beam_resolve"))
        if side == "kernel":
            ck = beam._beam_walk_cuda(aug, w.height, pre, st_k, K, steps,
                                      True)
        else:
            ck = beam.beam_walk_plain(aug, w.height, pre, st_k, K, steps)
        cp = beam.beam_walk_plain(aug, w.height, pre, st_p, K, steps)
        c = cp
        if case == "truncated":  # each beam's used slots cut at random
            used = (cp["lvl"] >= 0).sum(1).cpu()
            keep = (torch.rand(used.shape, generator=gen)
                    * (used + 1)).long()
            keep[::3] = 0
            gone = (torch.arange(K)[None] >= keep[:, None]).to(cuda)
            c = dict(lvl=torch.where(gone, -1, cp["lvl"]),
                     off=torch.where(gone[..., None], 0, cp["off"]),
                     rgb=torch.where(gone[..., None], 0.0, cp["rgb"]))
            cut += int(((keep > 0) & (keep < used)).sum())
        rk = beam.resolve_candidates(c["lvl"], c["off"], c["rgb"], o, dt,
                                     w.height)
        assert (_launched("beam_walk"), _launched("beam_resolve")) == \
            (before[0] + (side == "kernel"), before[1] + 1)
        rp = beam.resolve_candidates_plain(c["lvl"], c["off"], c["rgb"],
                                           o, dt, w.height)
        torch.cuda.synchronize()
        for key in cp:
            assert torch.equal(_bits_of(ck[key]), _bits_of(cp[key])), key
        for key in st_p:
            assert torch.equal(_bits_of(st_k[key]), _bits_of(st_p[key])), key
        for key in rp:
            assert torch.equal(_bits_of(rk[key]), _bits_of(rp[key])), key
        if best_k is None:
            best_k = {k: v.clone() for k, v in rk.items()}
            best_p = {k: v.clone() for k, v in rp.items()}
        else:
            beam.resolve_candidates(c["lvl"], c["off"], c["rgb"], o, dt,
                                    w.height, best=best_k)
            beam.resolve_candidates_plain(c["lvl"], c["off"], c["rgb"], o,
                                          dt, w.height, best=best_p)
            torch.cuda.synchronize()
            for key in best_p:
                assert torch.equal(_bits_of(best_k[key]),
                                   _bits_of(best_p[key])), key
        hits += int(rp["hit"].sum())
    # a later round's hit at the same t does not take the ray: the same
    # boxes in other colours leave the running best as it was
    best = {k: v.clone() for k, v in rp.items()}
    beam.resolve_candidates(c["lvl"], c["off"], c["rgb"] + 0.5, o, dt,
                            w.height, best=best)
    torch.cuda.synchronize()
    for key in rp:
        assert torch.equal(_bits_of(best[key]), _bits_of(rp[key])), key
    # rays of a beam with other direction signs: each ray mirrors the
    # candidates itself (K7's per-ray path)
    dm = dt.clone()
    dm[:, ::3, 0] = -dm[:, ::3, 0]
    dm[:, 1::5, 2] = -dm[:, 1::5, 2]
    rk = beam.resolve_candidates(c["lvl"], c["off"], c["rgb"], o, dm,
                                 w.height)
    rp = beam.resolve_candidates_plain(c["lvl"], c["off"], c["rgb"], o, dm,
                                       w.height)
    torch.cuda.synchronize()
    for key in rp:
        assert torch.equal(_bits_of(rk[key]), _bits_of(rp[key])), key
    assert hits > 0 and (cut > 0 or case != "truncated")
    if case in ("dead", "plain_then_kernel", "kernel_then_plain"):
        assert bool(st_p["alive"].any())


def test_beam_frame_matches_svo_cast(cuda, beam_world):
    from voxtracer_torch.core import camera as vcam
    from voxtracer_torch.kernels import beam

    w, aug = beam_world
    cam = vcam.Camera(pos=(80.3, 70.2, 20.1), yaw=2.6, pitch=-0.25)
    o, d = vcam.generate_rays(cam, 320, 184, device=cuda)
    r = beam.beam_primary_frame_cast(w.table, aug, w.root, w.height,
                                     np.asarray(cam.pos, np.float32), d)
    ref = traverse.svo_raycast(w.table, w.root, w.height, o, d)
    assert torch.equal(r["hit"], ref["hit"]) and r["hit"].any()
    hit = r["hit"]
    assert torch.equal(r["t"][hit], ref["t"][hit])
    assert torch.equal(r["voxel"][hit], ref["voxel"][hit])


@pytest.mark.parametrize("fetch", [None, (0, 32, 32), (100, 64, 1)])
@pytest.mark.parametrize("B,frac", [(1, None), (1000, 0.5), (65536, None)])
def test_bit_dda_matches_plain(cuda, B, frac, fetch):
    """K8 (the walker of bit_walk.cuh on the lane fetch) by bits against
    its plain version, under the wrapper's lane-fetch settings and two
    corners."""
    from voxtracer_torch.kernels import bitdda
    from voxtracer_torch.world import bitgrid

    rng = np.random.default_rng(B)
    solid = rng.random((128, 128, 128)) < 0.05
    grid = bitgrid.from_dense(solid)
    bw = grid.to_device(cuda)
    start = rng.random((B, 3)).astype(np.float32) * 200 - 36
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dist = np.where(rng.random(B) < 0.3, rng.random(B) * 150.0,
                    1e12).astype(np.float32)
    start, d, dist = (torch.as_tensor(a, device=cuda) for a in (start, d,
                                                               dist))
    active = None if frac is None else torch.as_tensor(rng.random(B) < frac,
                                                       device=cuda)
    before = _launched("bit_dda")
    if fetch is None:
        got = bitdda.bitgrid_raycast(*bw, grid.size, start, d, distance=dist,
                                     active=active)
    else:
        got = bitdda._bitgrid_raycast_cuda(*bw, grid.size, start, d, dist,
                                           True, active, fetch)
    assert _launched("bit_dda") == before + 1
    want = bitdda.bitgrid_raycast_plain(*bw, grid.size, start, d, dist, True,
                                        active)
    torch.cuda.synchronize()
    for key in want:
        assert torch.equal(got[key], want[key]), key


@pytest.mark.parametrize("log2", [10, 13])
def test_heightmap_on_the_card_equals_cpu(cuda, log2):
    """The worlds the card builds are the reference's terrain: the
    heightmap made on the card equals the CPU's by bits."""
    a = worldgen.heightmap(log2, device=cuda)
    b = worldgen.heightmap(log2, device="cpu")
    assert np.array_equal(a, b)


@pytest.mark.parametrize("engine,primary,fuse", [
    ("hf", False, False), ("hf", True, False), ("hf", False, True),
    ("svo", False, False), ("edited", False, False), ("maps", False, False),
    ("maps", True, True), ("bit", False, False), ("bit", True, True)])
def test_path_trace_matches_plain_bit_for_bit(cuda, terrain, engine, primary,
                                              fuse):
    """K9 against the masked loop on the card: radiance and the returned
    state equal by bits in every lane, on each engine, with bounce 0's
    primary hits given, and fused (the state 3 draws ahead; no fused draws
    with the sun maps or the bit grid, as in the JAX package). "maps": the
    heightfield with the sun maps, which settle some NEE lanes and move no
    bit of K9's own output without them; "bit": the bit grid, given with
    the pack and the maps that it wins over."""
    from voxtracer_torch.core.spectra import build_wl_to_rgb_lut
    from voxtracer_torch.kernels import integrator, sunshadow
    from voxtracer_torch.world import bitgrid

    w, heights = terrain
    n = 1 << w.height
    tiles, offs, _ = heightfield.build_height_mips(heights, device=cuda)
    kw = {} if engine == "svo" else dict(hf_mips=tiles, hf_offsets=offs,
                                         terrain_rgb=(0.5, 0.5, 0.5))
    if engine == "edited":
        kw["hf_edit_bounds"] = torch.tensor(
            [[[40, 0, 40], [60, 90, 60]], [[5, 10, 70], [9, 30, 75]]],
            dtype=torch.float32, device=cuda)
    sun = np.float32([0.5, 0.8, 0.33])
    sun /= np.linalg.norm(sun)
    if engine in ("maps", "bit"):
        kw["sun_maps"] = sunshadow.upload(sunshadow.build(heights, sun), cuda)
    if engine == "bit":
        grid = bitgrid.from_heightmap(heights)
        kw.update(bitworld=grid.to_device(cuda), bit_size=grid.size)
    rng = np.random.default_rng(29)
    B = 20000
    start = rng.uniform(2, n - 2, (B, 3)).astype(np.float32)
    start[:, 1] = rng.uniform(heights.max() * 0.5, n - 2, B)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    args = (w.table, w.root, w.height,
            torch.as_tensor(build_wl_to_rgb_lut(256), device=cuda),
            torch.as_tensor(start, device=cuda), torch.as_tensor(d, device=cuda),
            torch.as_tensor(rng.random(B, np.float32), device=cuda),
            torch.as_tensor(sun, device=cuda),
            torch.as_tensor(rng.integers(0, 2**32, (B, 3)), device=cuda))
    prim = None
    if primary:
        pr = heightfield.hf_raycast(tiles, offs, w.height, args[4], args[5])
        prim = dict(hit=pr["hit"], t=pr["t"], normal=pr["normal"],
                    rgb=torch.full((B, 3), 0.5, device=cuda))
    before = _launched("path_trace")
    st_k, col_k = integrator.trace_paths(*args, 8, 32, primary=prim,
                                         fuse_nee=fuse, **kw)
    assert _launched("path_trace") == before + 1
    work = dict(zip(integrator.K9_WORK, integrator.last_work.tolist()))
    st_p, col_p = integrator.trace_paths_plain(*args, 8, 32, primary=prim,
                                               fuse_nee=fuse, **kw)
    torch.cuda.synchronize()
    assert torch.equal(st_k, st_p)
    assert np.array_equal(col_k.cpu().numpy().view(np.int32),
                          col_p.cpu().numpy().view(np.int32))
    assert float(col_k.sum()) > 0
    assert (work["bit_steps"] > 0) == (engine == "bit")
    assert (work["sun_lit"] > 0) == (engine == "maps")
    if engine == "maps":
        # (no fused draws with the maps, so none without them here)
        st_n, col_n = integrator.trace_paths(
            *args, 8, 32, primary=prim, fuse_nee=False,
            **dict(kw, sun_maps=None))
        assert torch.equal(st_k, st_n) and torch.equal(col_k, col_n)
