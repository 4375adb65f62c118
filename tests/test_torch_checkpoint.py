"""Port: checkpoint and resume (voxtracer_torch/render/checkpoint.py). A
resumed render continues bit-identically, and the file is the JAX
package's: either package loads the other's snapshot."""

import json

import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.render import checkpoint as jckpt
from voxtracer.render.driver import Renderer as JRenderer
from voxtracer.world.svo import from_dense
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.render import checkpoint as tckpt
from voxtracer_torch.render import driver as tdrv
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)
SUN = np.array([0.3, 1.0, 0.2])
KW = dict(max_bounces=2, fog_steps=8, seed=42)


@pytest.fixture(scope="module")
def world():
    n = 16
    solid = np.zeros((n, n, n), bool)
    solid[:, :2, :] = True
    rgb = np.zeros((n, n, n, 3), np.float32)
    rgb[solid] = 0.5
    return from_dense(solid, rgb)


def test_resume_bit_identical(world, tmp_path):
    cam = tcam.Camera(pos=(8.0, 6.0, 8.0), yaw=0.3, pitch=0.4)
    ref = tdrv.Renderer(world.serialize(), 24, 16, device="cpu", **KW)
    for _ in range(4):
        ref.sample(cam, SUN)
    r1 = tdrv.Renderer(world.serialize(), 24, 16, device="cpu", **KW)
    for _ in range(2):
        r1.sample(cam, SUN)
    path = tmp_path / "state.npz"
    tckpt.save_render_state(path, r1, cam, SUN)
    r2, cam2, sun2 = tckpt.load_render_state(path, device="cpu")
    assert r2.acc.samples == 2 and torch.equal(r2.acc.buffer, r1.acc.buffer)
    assert (r2.width, r2.height) == (24, 16)
    assert (r2.max_bounces, r2.fog_steps) == (2, 8)
    assert cam2.pos == cam.pos and np.array_equal(sun2, SUN)
    for _ in range(2):
        r2.sample(cam2, sun2)
    assert ref.acc.samples == r2.acc.samples == 4
    assert torch.equal(ref.acc.buffer, r2.acc.buffer)


def test_file_holds_the_jax_keys(world, tmp_path):
    cam = tcam.Camera(pos=(8.0, 6.0, 8.0), yaw=0.3, pitch=0.4)
    r = tdrv.Renderer(world.serialize(), 24, 16, device="cpu", **KW)
    r.sample(cam, SUN)
    path = tmp_path / "state.npz"
    tckpt.save_render_state(path, r, cam, SUN)
    z = np.load(path, allow_pickle=False)
    assert set(z.files) == {"meta", "accumulator", "table", "rng_state"}
    meta = json.loads(str(z["meta"]))
    assert meta["version"] == jckpt.FORMAT_VERSION == tckpt.FORMAT_VERSION
    assert set(meta) == {"version", "samples", "width", "height",
                         "max_bounces", "fog_steps", "cam_pos", "yaw",
                         "pitch", "sun", "tree_height", "root"}
    assert z["table"].dtype == np.int32 and z["accumulator"].shape == (16, 24, 3)


def test_each_package_loads_the_others_file(world, tmp_path):
    """A snapshot written by the port resumes in the JAX package and the
    other way round: same accumulator, count, RNG stream and world."""
    cam_t = tcam.Camera(pos=(8.0, 6.0, 8.0), yaw=0.3, pitch=0.4)
    cam_j = jcam.Camera(pos=(8.0, 6.0, 8.0), yaw=0.3, pitch=0.4)
    rt = tdrv.Renderer(world.serialize(), 24, 16, device="cpu", **KW)
    rj = JRenderer(world.serialize(), 24, 16, **KW)
    for _ in range(2):
        rt.sample(cam_t, SUN)
        rj.sample(cam_j, SUN)
    tckpt.save_render_state(tmp_path / "port.npz", rt, cam_t, SUN)
    jckpt.save_render_state(tmp_path / "jax.npz", rj, cam_j, SUN)

    j2, jc, js = jckpt.load_render_state(tmp_path / "port.npz")
    assert j2.acc.samples == 2
    assert np.array_equal(np.asarray(j2.acc.buffer), rt.acc.buffer.numpy())
    assert np.array_equal(np.asarray(j2.table), rt.world.table.numpy())
    assert j2.host_rng.getstate() == rt.host_rng.getstate()
    assert tuple(jc.pos) == cam_t.pos and np.array_equal(js, SUN)

    t2, tc, ts = tckpt.load_render_state(tmp_path / "jax.npz", device="cpu")
    assert t2.acc.samples == 2
    assert np.array_equal(t2.acc.buffer.numpy(), np.asarray(rj.acc.buffer))
    assert np.array_equal(t2.world.table.numpy(), np.asarray(rj.table))
    assert (t2.world.root, t2.world.height) == (int(rj.root), rj.tree_height)
    assert t2.host_rng.getstate() == rj.host_rng.getstate()
    t2.sample(tc, ts)  # and it goes on
    assert t2.acc.samples == 3 and torch.isfinite(t2.acc.buffer).all()


def test_world_roundtrip_and_cross_load(world, tmp_path):
    tckpt.save_world(tmp_path / "w.npz", world)
    orig = world.serialize()
    for load in (tckpt.load_world_device, jckpt.load_world_device):
        dev = load(tmp_path / "w.npz")
        assert np.array_equal(dev.table, orig.table)
        assert (dev.root, dev.height) == (orig.root, orig.height)
    jckpt.save_world(tmp_path / "j.npz", world)
    dev = tckpt.load_world_device(tmp_path / "j.npz")
    assert np.array_equal(dev.table, orig.table) and dev.root == orig.root


def test_headless_run_checkpoints_and_resumes(tmp_path):
    """``checkpoint_every`` in the headless loop: the snapshot written at
    the frame's last multiple holds that frame's accumulator, and a
    terrain world resumed from it (on the SVO cast: the snapshot keeps no
    heightmap) goes on rendering."""
    space = tgen.generate(log2_size=5, verbose=False, device="cpu")
    cam = tcam.Camera(pos=(12.0, 14.0, 6.0), yaw=0.4, pitch=0.5)
    r = tdrv.Renderer(space.serialize(), 32, 16, max_bounces=3, fog_steps=8,
                      seed=0, device="cpu")
    path = tmp_path / "render_state.npz"
    tdrv.headless_run(r, cam, out_dir=tmp_path / "frames", frame_samples=4,
                      max_frames=1, batch=2, checkpoint_every=2,
                      checkpoint_path=path, log=lambda s: None)
    assert r._get_hf()[0] is not None
    r2, cam2, sun2 = tckpt.load_render_state(path, device="cpu")
    assert r2.acc.samples == 4 and torch.equal(r2.acc.buffer, r.acc.buffer)
    assert r2._get_hf()[0] is None and r2._get_soup() is None
    assert r2.host_rng.getstate() == r.host_rng.getstate()
    r2.sample(cam2, sun2)
    assert r2.acc.samples == 5

    with pytest.raises(ValueError, match="version"):
        z = dict(np.load(path, allow_pickle=False))
        z["meta"] = json.dumps(dict(json.loads(str(z["meta"])), version=9))
        np.savez_compressed(tmp_path / "bad.npz", **z)
        tckpt.load_render_state(tmp_path / "bad.npz", device="cpu")
