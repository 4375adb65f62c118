"""Port vs JAX: the resolve fold (voxtracer_torch/kernels/resolve.py,
plain version) against the Pallas kernel it replaces
(voxtracer/kernels/pallas/resolve.py, interpret mode on the CPU) and
against the XLA fold of voxtracer/kernels/raster.py (resolve_scan: the
chunked argmin of raster.py:832-850 over its _mirrored_slab). Same
candidates, same order: t, pl and rgb bit-equal.

The Pallas wrapper takes R = 64 or a stacked R that it lays out as rows
of 128 lanes; at R = 128 its row count comes out 1 and it keeps only the
first 64 rays (pallas/resolve.py:118, :190-192), so the stacked form is
held against it at R = 256 and against the XLA fold at R = 128.

The segment form (resolve_fold_seg_plain: the sorted pair array read
where it lies, the carry updated in place, the per-tile max) is held to
resolve_fold_plain on gathered lists, and through it to the Pallas kernel
and the XLA fold."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.kernels import raster as jraster
from voxtracer.kernels.pallas import resolve as jresolve
from voxtracer_torch.kernels import resolve as tresolve

torch.set_num_threads(2)
TREE_HEIGHT = 6
CHUNK = 8  # the XLA fold's scan step (voxtracer/kernels/raster.py)


def _case(seed, N, R, K, inside=False, invalid=0.2):
    """Random boxes in a 64^3 world as pair records, a carry that already
    holds some hits, and unit ray directions (a few along an axis)."""
    rng = np.random.default_rng(seed)
    lo = rng.integers(0, 56, (N, K, 3))
    size = rng.integers(1, 9, (N, K, 3))
    owner = rng.integers(0, 5000, (N, K))
    rgb = rng.random((N, K, 3), np.float32)
    rows = np.zeros((N, K, 8), np.int32)
    rows[..., 0] = rng.integers(0, 1 << 30, (N, K))
    rows[..., 1] = owner
    rows[..., 2] = lo[..., 0] | (lo[..., 1] << 16)
    rows[..., 3] = lo[..., 2] | (size[..., 0] << 16)
    rows[..., 4] = size[..., 1] | (size[..., 2] << 16)
    rows[..., 5:8] = rgb.view(np.int32)
    valid = rng.random((N, K)) >= invalid
    if inside:  # the camera sits inside the first box of every tile
        lo[:, 0] = [20, 20, 20]
        size[:, 0] = [8, 8, 8]
        rows[:, 0, 2] = 20 | (20 << 16)
        rows[:, 0, 3] = 20 | (8 << 16)
        rows[:, 0, 4] = 8 | (8 << 16)
        cam = np.float32([23.5, 24.25, 22.75])
    else:
        cam = np.float32([31.3, 70.2, -9.6])
    d = rng.normal(size=(N, R, 3)).astype(np.float32)
    d[:, :4, 1:] = 0.0  # axis-aligned rays exercise the EPS clamp
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    t0 = np.where(rng.random((N, R)) < 0.3,
                  rng.random((N, R), np.float32) * 80, np.inf).astype(np.float32)
    pl0 = np.where(np.isfinite(t0), rng.integers(0, 4000, (N, R)) * 4, -1)
    rgb0 = np.where(np.isfinite(t0)[..., None],
                    rng.random((N, R, 3), np.float32), 0).astype(np.float32)
    geo = dict(lo=lo.astype(np.float32), hi=(lo + size).astype(np.float32),
               rgb=rgb, pl=np.where(valid, owner << 2, -4).astype(np.int32))
    return (t0, pl0.astype(np.int32), rgb0), rows, valid, d, cam, geo


def _port(carry, rows, valid, d, cam, distance=1.0e12):
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    out = tresolve.resolve_fold_plain(t(carry[0]), t(carry[1]), t(carry[2]),
                                      t(rows), t(valid), t(d), cam,
                                      TREE_HEIGHT, distance)
    return [o.numpy() for o in out]


def _xla_fold(carry, geo, d, cam, distance=1.0e12):
    """voxtracer/kernels/raster.py resolve_scan + fold_chunk (carry_rgb),
    CHUNK candidates per step, on the JAX package's _mirrored_slab."""
    bt, bpl, brgb = (jnp.asarray(c) for c in carry)
    K = geo["pl"].shape[1]
    for c0 in range(0, K, CHUNK):
        sl = slice(c0, c0 + CHUNK)
        glo, ghi = jnp.asarray(geo["lo"][:, sl]), jnp.asarray(geo["hi"][:, sl])
        t, axis, hit = jraster._mirrored_slab(
            glo[:, :, None, :], ghi[:, :, None, :], jnp.asarray(cam),
            jnp.asarray(d)[:, None], TREE_HEIGHT, distance)
        ck_pl = jnp.asarray(geo["pl"][:, sl])[:, :, None]
        t = jnp.where((ck_pl >= 0) & hit, t, jnp.float32(jnp.inf))
        k_best = jnp.argmin(t, axis=1)
        t_k = jnp.min(t, axis=1)
        onehot = k_best[:, None, :] == jnp.arange(t.shape[1])[None, :, None]
        pl_k = jnp.sum(jnp.where(onehot, ck_pl | axis, 0), axis=1)
        rgb = jnp.asarray(geo["rgb"][:, sl])
        rgb_k = jnp.sum(jnp.where(onehot[..., None], rgb[:, :, None, :], 0.0),
                        axis=1)
        better = t_k < bt
        bt = jnp.where(better, t_k, bt)
        bpl = jnp.where(better, pl_k, bpl)
        brgb = jnp.where(better[..., None], rgb_k, brgb)
    return [np.asarray(x) for x in (bt, bpl, brgb)]


def _assert_equal(got, want):
    for name, a, b in zip(("t", "pl", "rgb"), got, want):
        assert a.dtype == b.dtype and np.array_equal(a, b), name


@pytest.mark.parametrize("R,K,inside", [(64, 16, False), (256, 32, False),
                                        (64, 32, True), (256, 16, True)])
def test_plain_fold_equals_pallas_kernel(R, K, inside):
    carry, rows, valid, d, cam, geo = _case(R + K, 9, R, K, inside=inside)
    got = _port(carry, rows, valid, d, cam)
    want = jresolve.resolve_fold(
        tuple(jnp.asarray(c) for c in carry), jnp.asarray(geo["lo"]),
        jnp.asarray(geo["hi"]), jnp.asarray(geo["rgb"]),
        jnp.asarray(geo["pl"]), jnp.asarray(d), jnp.asarray(cam),
        TREE_HEIGHT, 1.0e12, interpret=True)
    _assert_equal(got, [np.asarray(w) for w in want])
    assert (got[0] < carry[0]).any()  # the fold replaced some carries


@pytest.mark.parametrize("R,K,inside,distance", [
    (64, 16, False, 1.0e12), (128, 32, True, 1.0e12), (128, 16, False, 1.0e12),
    (64, 104, False, 30.0)])
def test_plain_fold_equals_xla_fold(R, K, inside, distance):
    carry, rows, valid, d, cam, geo = _case(7 * K, 6, R, K, inside=inside)
    _assert_equal(_port(carry, rows, valid, d, cam, distance),
                  _xla_fold(carry, geo, d, cam, distance))


def test_shared_list_equals_per_tile_lists():
    """The near pre-pass form (one list, tile stride 0) folds as every
    tile holding that same list."""
    carry, rows, valid, d, cam, _ = _case(11, 5, 64, 24)
    shared = _port(carry, rows[0], valid[0], d, cam)
    tiled = _port(carry, np.broadcast_to(rows[:1], rows.shape),
                  np.broadcast_to(valid[:1], valid.shape), d, cam)
    _assert_equal(shared, tiled)


def test_plain_fold_blocks_are_invisible(monkeypatch):
    """The plain version folds candidates in blocks; any block size gives
    the sequential fold's result."""
    carry, rows, valid, d, cam, _ = _case(12, 4, 64, 40)
    want = _port(carry, rows, valid, d, cam)
    for block in (1, 7 * 4 * 64):
        monkeypatch.setattr(tresolve, "PLAIN_BLOCK", block)
        _assert_equal(_port(carry, rows, valid, d, cam), want)


def test_resolve_fold_checks_shapes():
    carry, rows, valid, d, cam, _ = _case(13, 2, 64, 8)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    with pytest.raises(ValueError):
        tresolve.resolve_fold(t(carry[0]), t(carry[1]), t(carry[2]),
                              t(rows[:, :4]), t(valid), t(d), cam,
                              TREE_HEIGHT, 1.0e12)


DB = 20
QUANTUM = 0.125


def _segments(seed, NT, most=60):
    """A sorted pair array over NT tiles: each tile's segment holds
    0..most records of _case's boxes with rising keys, one tile holds
    none, and a sentinel row (tile NT) closes the array."""
    rng = np.random.default_rng(seed)
    counts = rng.integers(1, most, NT)
    counts[NT // 2] = 0
    n = int(counts.sum())
    _, rows, _, _, _, _ = _case(seed, 1, 64, n + 1)
    rows = rows[0]
    rows[:n, 0] = (np.repeat(np.arange(NT), counts) << DB) | np.arange(n)
    rows[n] = 0
    rows[n, 0] = NT << DB
    start = np.concatenate([[0], np.cumsum(counts)[:-1]]).astype(np.int32)
    return rows, start, counts


def _seg_inputs(seed, NT, R):
    carry, _, _, d, cam, _ = _case(seed, NT, R, 1)
    ok = np.random.default_rng(seed).random((NT, R)) < 0.7
    ok[1] = False  # a tile of padding pixels only
    return carry, d, cam, ok


def _seg_fold(carry, spairs, tiles, start, k, d, ok, cam, distance=1.0e12):
    """resolve_fold_seg_plain on copies; (carry after, tile max); the
    next records' bounds are held to the keys here."""
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    state = [t(c) for c in carry]
    tmax, nxt = tresolve.resolve_fold_seg_plain(
        *state, t(spairs), None if tiles is None else t(tiles), t(start), k,
        DB, QUANTUM, t(d), t(ok), cam, TREE_HEIGHT, distance)
    idx = np.arange(len(start)) if tiles is None else tiles
    key = spairs[np.minimum(start.astype(np.int64) + k, len(spairs) - 1), 0]
    q = np.maximum((key & ((1 << DB) - 1)) - 1, 0).astype(np.float32)
    want = np.where((key >> DB) == idx, q * np.float32(QUANTUM), np.inf)
    assert np.array_equal(nxt.numpy(), want.astype(np.float32))
    return [s.numpy() for s in state], tmax.numpy()


def _gathered_fold(carry, spairs, tiles, start, k, d, cam, distance=1.0e12):
    """The same fold by hand: the records gathered with seg_rows, valid
    where the key names the tile, folded by resolve_fold_plain."""
    rows = tresolve.seg_rows(torch.from_numpy(spairs), torch.from_numpy(start),
                             k).numpy()
    valid = (rows[..., 0] >> DB) == tiles[:, None]
    return _port([c[tiles] for c in carry], rows, valid, d[tiles], cam,
                 distance), rows, valid


@pytest.mark.parametrize("R,k,consumed,listed", [
    (64, 16, 0, None),    # the main fold: every tile from its segment start
    (128, 16, 0, None),
    (64, 24, 16, 6),      # a widen round: segments end inside the span
    (64, 104, 10, 4),     # spans that run far past every segment
    (128, 500, 5, 3),     # reads clamp at the last record
])
def test_seg_fold_equals_plain_fold_on_gathered_lists(R, k, consumed, listed):
    NT = 9
    spairs, seg_start, counts = _segments(R + k, NT)
    carry, d, cam, ok = _seg_inputs(R + k, NT, R)
    if listed is None:
        tiles_arg, tiles, start = None, np.arange(NT), seg_start
    else:
        tiles = np.sort(np.random.default_rng(k).choice(NT, listed,
                                                        replace=False))
        tiles[-1] = NT - 1  # the last segment: its tail is the sentinel
        tiles = np.unique(tiles).astype(np.int32)
        tiles_arg = tiles
        start = (seg_start[tiles] + consumed).astype(np.int32)
    got, tmax = _seg_fold(carry, spairs, tiles_arg, start, k, d, ok, cam)
    want, rows, valid = _gathered_fold(carry, spairs, tiles, start, k, d, cam)
    # the next tile's records, and at k = 500 the clamped tail, are in
    # the lists as invalid candidates
    assert (~valid).any()
    assert k < 500 or (start.astype(np.int64) + k > len(spairs)).all()
    for g, c, w in zip(got, carry, want):
        assert np.array_equal(g[tiles], w)
        rest = np.setdiff1d(np.arange(NT), tiles)
        assert np.array_equal(g[rest], c[rest])  # unlisted tiles untouched
    want_max = np.where(ok[tiles], want[0], -np.inf).max(axis=1)
    assert np.array_equal(tmax, want_max.astype(np.float32))
    assert (got[0] < carry[0]).any()


def test_seg_fold_tile_max_reads_real_pixels_only():
    """A padding ray's t, however far, is not in its tile's max; a tile
    with no real pixel reports -inf."""
    NT, R, k = 5, 64, 16
    spairs, seg_start, _ = _segments(3, NT)
    carry, d, cam, ok = _seg_inputs(3, NT, R)
    ok[:] = True
    ok[1] = False
    ok[:, :8] = False
    carry[0][:] = np.float32(50.0)  # every real ray holds a hit already
    carry[1][:] = 4
    carry[0][:, :8] = np.float32(1.0e9)  # padding rays: far, and they
    d[:, :8] = np.float32([0.0, 1.0, 0.0])  # look away from every box
    got, tmax = _seg_fold(carry, spairs, None, seg_start, k, d, ok, cam)
    assert tmax[1] == -np.inf
    others = np.array([0, 2, 3, 4])
    assert np.array_equal(tmax[others], got[0][others, 8:].max(axis=1))
    assert (got[0][:, :8].max(axis=1) > tmax).all()
    assert (got[0][:, 8:] < 50.0).any()


def test_seg_fold_empty_tile_list():
    NT, R = 4, 64
    spairs, seg_start, _ = _segments(5, NT)
    carry, d, cam, ok = _seg_inputs(5, NT, R)
    got, tmax = _seg_fold(carry, spairs, np.zeros(0, np.int32),
                          np.zeros(0, np.int32), 16, d, ok, cam)
    assert tmax.shape == (0,)
    _assert_equal(got, carry)


def test_seg_fold_wrapper_takes_plain_on_cpu_and_checks_shapes():
    NT, R = 4, 64
    spairs, seg_start, _ = _segments(6, NT)
    carry, d, cam, ok = _seg_inputs(6, NT, R)
    t = lambda a: torch.from_numpy(np.array(a))  # noqa: E731
    state = [t(c) for c in carry]
    tmax, nxt = tresolve.resolve_fold_seg(
        *state, t(spairs), None, t(seg_start), 16, DB, QUANTUM, t(d), t(ok),
        cam, TREE_HEIGHT, 1.0e12)
    assert nxt.shape == (NT,) and torch.isfinite(nxt).any()
    want, want_max = _seg_fold(carry, spairs, None, seg_start, 16, d, ok, cam)
    _assert_equal([s.numpy() for s in state], want)
    assert np.array_equal(tmax.numpy(), want_max)
    with pytest.raises(ValueError):  # one start per listed tile
        tresolve.resolve_fold_seg(*state, t(spairs), None, t(seg_start[:2]),
                                  16, DB, QUANTUM, t(d), t(ok), cam,
                                  TREE_HEIGHT, 1e12)
    with pytest.raises(ValueError):  # the carry is updated in place
        tresolve.resolve_fold_seg(state[0].T.contiguous().T, *state[1:],
                                  t(spairs), None, t(seg_start), 16, DB,
                                  QUANTUM, t(d), t(ok), cam, TREE_HEIGHT, 1e12)
    with pytest.raises(ValueError):
        tresolve.resolve_fold_seg(*state, t(spairs), None, t(seg_start), 0,
                                  DB, QUANTUM, t(d), t(ok), cam, TREE_HEIGHT,
                                  1e12)


@pytest.mark.parametrize("R,k", [(64, 16), (256, 32)])
def test_seg_fold_equals_pallas_kernel_and_xla_fold(R, k):
    """Through the gathered lists the segment form is the JAX package's
    fold: the Pallas kernel in interpret mode and the XLA scan, on the
    records the segment form read."""
    NT = 6
    spairs, seg_start, _ = _segments(R, NT, most=40)
    carry, d, cam, ok = _seg_inputs(R, NT, R)
    tiles = np.arange(NT)
    got, _ = _seg_fold(carry, spairs, None, seg_start, k, d, ok, cam)
    _, rows, valid = _gathered_fold(carry, spairs, tiles, seg_start, k, d, cam)
    lo, hi, rgb, pl = (x.numpy() for x in tresolve.decode(
        torch.from_numpy(rows)))
    geo = dict(lo=lo, hi=hi, rgb=rgb,
               pl=np.where(valid, pl, -4).astype(np.int32))
    want = jresolve.resolve_fold(
        tuple(jnp.asarray(c) for c in carry), jnp.asarray(geo["lo"]),
        jnp.asarray(geo["hi"]), jnp.asarray(geo["rgb"]),
        jnp.asarray(geo["pl"]), jnp.asarray(d), jnp.asarray(cam),
        TREE_HEIGHT, 1.0e12, interpret=True)
    _assert_equal(got, [np.asarray(w) for w in want])
    _assert_equal(got, _xla_fold(carry, geo, d, cam))
