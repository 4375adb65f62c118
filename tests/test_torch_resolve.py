"""Port vs JAX: the resolve fold (voxtracer_torch/kernels/resolve.py,
plain version) against the Pallas kernel it replaces
(voxtracer/kernels/pallas/resolve.py, interpret mode on the CPU) and
against the XLA fold of voxtracer/kernels/raster.py (resolve_scan: the
chunked argmin of raster.py:832-850 over its _mirrored_slab). Same
candidates, same order: t, pl and rgb bit-equal.

The Pallas wrapper takes R = 64 or a stacked R that it lays out as rows
of 128 lanes; at R = 128 its row count comes out 1 and it keeps only the
first 64 rays (pallas/resolve.py:118, :190-192), so the stacked form is
held against it at R = 256 and against the XLA fold at R = 128."""

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
