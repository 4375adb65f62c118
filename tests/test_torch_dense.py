"""Port: the dense-grid path (voxtracer_torch/world/dense.py,
world/svo.from_dense and DeviceSvo.leaf_colors, kernels/traverse's
dense_raycast, kernels/shade's dense frames) against the JAX package on
the same numpy inputs, and the BASELINE config 1 and 2 parity patterns
(tests/test_configs.py) on the port's own dense and SVO frames.

dense_raycast and from_dense do the same float32 operations in the same
order as the JAX package (the DDA's one division through ``rdiv``), so
they are held equal by bits."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.kernels import shade as jshade
from voxtracer.kernels import traverse as jtrav
from voxtracer.world import dense as jdense
from voxtracer.world import svo as jsvo
from voxtracer.world import worldgen as jgen
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import shade as tshade
from voxtracer_torch.kernels import traverse as ttrav
from voxtracer_torch.world import dense as tdense
from voxtracer_torch.world import svo as tsvo
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)
POSE = dict(pos=(16.123, 28.077, -9.955), yaw=0.05, pitch=0.35)


def _clutter(n=16, seed=3):
    rng = np.random.default_rng(seed)
    solid = rng.random((n, n, n)) < 0.2
    rgb = rng.random((n, n, n, 3)).astype(np.float32)
    rgb[~solid] = 0
    return solid, rgb


def _sun():
    sun = np.array([0.4, 0.8, 0.45], np.float32)
    return sun / np.linalg.norm(sun)


def test_from_heightmap_equals_jax():
    h = np.asarray(jgen.heightmap(5))
    got = tdense.from_heightmap(h, 32, rgb=(0.25, 0.5, 0.75))
    want = jdense.from_heightmap(h, 32, rgb=(0.25, 0.5, 0.75))
    assert got.size == want.size == 32
    assert np.array_equal(got.solid, want.solid)
    assert np.array_equal(got.rgb, want.rgb)
    dev = got.to_device("cpu")
    assert dev.solid.dtype == torch.bool and dev.rgb.dtype == torch.float32
    assert torch.equal(dev.solid, torch.from_numpy(want.solid))
    with pytest.raises(ValueError):
        tdense.from_heightmap(h, 16)


def test_from_svo_space_equals_jax():
    solid, rgb = _clutter(8)
    space = jsvo.from_dense(solid, rgb)
    got = tdense.from_svo_space(space)
    want = jdense.from_svo_space(space)
    assert np.array_equal(got.solid, want.solid) and got.solid.any()
    assert np.array_equal(got.rgb, want.rgb)
    back = tdense.from_svo_space(tsvo.from_dense(solid, rgb))
    assert np.array_equal(back.solid, solid) and np.array_equal(back.rgb, rgb)


@pytest.mark.parametrize("case", ["terrain", "clutter", "empty", "one"])
def test_from_dense_table_equals_jax(case):
    """The serialized table, root and height equal the JAX package's by
    bits (the same np.unique order of leaves and child rows), and
    leaf_colors is the table's colour view."""
    if case == "terrain":
        w = jdense.from_heightmap(np.asarray(jgen.heightmap(5)), 32)
        solid, rgb = w.solid, w.rgb
    elif case == "clutter":
        solid, rgb = _clutter(16)
    else:
        solid = np.zeros((4, 4, 4), bool)
        rgb = np.zeros((4, 4, 4, 3), np.float32)
        if case == "one":
            solid[1, 2, 3] = True
            rgb[1, 2, 3] = (0.1, 0.2, 0.3)
    got = tsvo.from_dense(solid, rgb).serialize()
    want = jsvo.from_dense(solid, rgb).serialize()
    assert got.root == want.root and got.height == want.height
    assert np.array_equal(got.table, want.table)
    assert np.array_equal(got.solid_leaf, want.solid_leaf)
    lc = got.leaf_colors()
    assert lc.dtype == np.float32 and lc.shape == (got.table.shape[0], 3)
    assert np.array_equal(lc.view(np.uint32), want.leaf_colors()
                          .view(np.uint32))


def test_from_dense_rejects_non_power_of_two():
    with pytest.raises(ValueError):
        tsvo.from_dense(np.zeros((6, 6, 6), bool),
                        np.zeros((6, 6, 6, 3), np.float32))


def _ray_sets(rng):
    cam = jcam.Camera(**POSE)
    _, d = jcam.generate_rays(cam, 80, 48)
    o = np.asarray(cam.pos, np.float32)
    st = rng.uniform(-5, 37, (4096, 3)).astype(np.float32)
    dr = rng.normal(size=(4096, 3)).astype(np.float32)
    dr /= np.linalg.norm(dr, axis=1, keepdims=True)
    dr[:64, 1] = 0.0  # axis-parallel components take the EPS clamp
    dr[64:96, 0] = -0.0
    cap = rng.uniform(1, 60, 4096).astype(np.float32)
    return [(o, np.array(d), 1e12), (st, dr, 1e12), (st, dr, cap)]


@pytest.mark.parametrize("case", ["terrain", "clutter"])
def test_dense_raycast_equals_jax(case):
    """Camera rays, random rays from inside and outside the grid, with and
    without per-ray caps: hit, t, normal and voxel equal by bits."""
    if case == "terrain":
        w = jdense.from_heightmap(np.asarray(jgen.heightmap(5)), 32)
        solid, n = w.solid, 32
    else:
        solid, _ = _clutter(32, seed=9)
        n = 32
    solid_t = torch.from_numpy(solid)
    before = ttrav.dense_host_reads
    for start, d, dist in _ray_sets(np.random.default_rng(1)):
        want = jtrav.dense_raycast(jnp.asarray(solid), jnp.asarray(start),
                                   jnp.asarray(d), n, distance=dist)
        got = ttrav.dense_raycast(solid_t, torch.from_numpy(start),
                                  torch.from_numpy(d), n,
                                  distance=torch.as_tensor(dist))
        assert got["hit"].any() and not got["hit"].all()
        for k in ("hit", "t", "normal", "voxel"):
            g, wv = got[k].numpy(), np.asarray(want[k])
            assert g.shape == wv.shape and g.dtype == wv.dtype, k
            assert np.array_equal(g.view(np.uint32) if g.dtype == np.float32
                                  else g,
                                  wv.view(np.uint32) if wv.dtype == np.float32
                                  else wv), k
    assert ttrav.dense_host_reads > before


@pytest.mark.parametrize("frame", ["primary", "shadow"])
def test_dense_frames_equal_jax(frame):
    w = jdense.from_heightmap(np.asarray(jgen.heightmap(5)), 32)
    cam = jcam.Camera(**POSE)
    _, d = jcam.generate_rays(cam, 64, 40)
    o = np.asarray(cam.pos, np.float32)
    sun = _sun()
    jfn = getattr(jshade, f"dense_{frame}_frame")
    tfn = getattr(tshade, f"dense_{frame}_frame")
    want = np.asarray(jfn(jnp.asarray(w.solid), jnp.asarray(w.rgb), 32,
                          jnp.asarray(o), d, jnp.asarray(sun)))
    tw = tdense.DenseWorld(w.solid, w.rgb).to_device("cpu")
    got = tfn(tw.solid, tw.rgb, 32, torch.from_numpy(o),
              torch.from_numpy(np.array(d)), torch.from_numpy(sun)).numpy()
    assert np.array_equal(got, want)


@pytest.mark.parametrize("frame,W,H", [("primary", 80, 48),
                                       ("shadow", 64, 40)])
def test_config_parity_on_the_port(frame, W, H):
    """BASELINE configs 1 and 2 (tests/test_configs.py:28-63) on the
    port alone: the dense DDA frame equals the SVO frame of the same
    grid built by from_dense, within 1e-4."""
    n = 32
    w = tdense.from_heightmap(tgen.heightmap(5, device="cpu"), n)
    dev = tsvo.from_dense(w.solid, w.rgb).serialize()
    world = tsvo.upload(dev.table, dev.root, dev.height, "cpu")
    cam = tcam.Camera(**POSE)
    _, d = tcam.generate_rays(cam, W, H)
    o = torch.tensor(cam.pos, dtype=torch.float32)
    sun = torch.from_numpy(_sun())
    tw = w.to_device("cpu")
    a = getattr(tshade, f"dense_{frame}_frame")(tw.solid, tw.rgb, n, o, d,
                                                 sun)
    b = getattr(tshade, f"svo_{frame}_frame")(world.table, world.root,
                                               world.height, o, d, sun)
    assert a.shape == (H, W, 3) and float(a.max()) > 0
    assert np.allclose(a.numpy(), b.numpy(), atol=1e-4)
