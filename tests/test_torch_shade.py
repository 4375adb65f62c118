"""Port: the deterministic shading paths (voxtracer_torch/kernels/shade.py
and raster.raster_primary_frame) against the committed goldens
primary_64w and shadow_64w, under tests/test_golden.py:46-60's contract
(atol 2e-5 on all but < 1e-4 of the values), and against the JAX
package's shade module on the same world."""

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.kernels import shade as jshade
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import raster as traster
from voxtracer_torch.kernels import shade as tshade
from voxtracer_torch.world import boxes as tboxes
from voxtracer_torch.world import svo as tsvo
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)
GOLDEN = Path(__file__).parent / "golden"
W, H = 96, 56


@pytest.fixture(scope="module")
def scene():
    """tests/test_golden.py's scene, built by the port."""
    dev = tgen.generate(log2_size=6, verbose=False, device="cpu").serialize()
    w = tsvo.upload(dev.table, dev.root, dev.height, "cpu")
    s = 64 / 8192
    cam = tcam.Camera(pos=tuple(np.asarray(tcam.DEFAULT_POSE.pos) * s),
                      yaw=tcam.DEFAULT_POSE.yaw, pitch=tcam.DEFAULT_POSE.pitch)
    sun = np.asarray([0.8, 10.2743, 3.7])
    sun = torch.from_numpy((sun / np.linalg.norm(sun)).astype(np.float32))
    o, d = tcam.generate_rays(cam, W, H)
    return dev, w, cam, sun, o, d


def _compare(name, img, atol=2e-5):
    img = img.numpy()
    want = np.load(GOLDEN / f"{name}.npy")
    assert img.shape == want.shape and np.isfinite(img).all()
    frac = (np.abs(img - want) > atol).mean()
    assert frac < 1e-4, f"{name}: {frac:.4%} of values differ"


def test_primary_golden_svo(scene):
    _, w, _, sun, o, d = scene
    _compare("primary_64w", tshade.svo_primary_frame(w.table, w.root,
                                                     w.height, o, d, sun))


def test_shadow_golden_svo(scene):
    _, w, _, sun, o, d = scene
    _compare("shadow_64w", tshade.svo_shadow_frame(w.table, w.root, w.height,
                                                   o, d, sun))


def test_primary_golden_raster(scene):
    dev, w, cam, sun, _, _ = scene
    soup = tboxes.extract_boxes(dev)
    args = traster.soup_to_device(soup.lo, soup.size, soup.leaf, soup.rgb,
                                  "cpu")
    img = traster.raster_primary_frame(
        *args, w.height, np.asarray(cam.pos, np.float32), cam.basis(), sun,
        W, H, table=w.table, root=w.root)
    _compare("primary_64w", img)


def test_shadow_equals_jax_shade(scene):
    """The shadow frame against the JAX package's on the same rays."""
    _, w, cam, sun, o, d = scene
    jt = jnp.asarray(w.table.numpy())
    jd = jnp.asarray(d.numpy())
    want = np.asarray(jshade.svo_shadow_frame(
        jt, np.int32(w.root), w.height, jnp.asarray(o.numpy()), jd,
        jnp.asarray(sun.numpy())))
    got = tshade.svo_shadow_frame(w.table, w.root, w.height, o, d, sun)
    assert (np.abs(got.numpy() - want) > 2e-5).mean() < 1e-4
    sky = tshade.sky_color(d, sun).numpy()
    assert np.allclose(sky, np.asarray(jshade.sky_color(jd, jnp.asarray(
        sun.numpy()))), rtol=0, atol=1e-6)
