"""Port vs JAX: the SVO cast (the plain version of kernel K2,
voxtracer_torch/kernels/traverse.py, against voxtracer/kernels/traverse.py
svo_raycast) on the golden world and a 128^3 world, with camera rays,
random rays, per-lane caps and an active mask.

hit/t/node/normal/voxel must be equal. The traversal's float ops are
sub/mul/div chains that XLA cannot fuse into an FMA, so any mismatch
would be an edge graze (a ray through a voxel edge or corner, where the
tie-break flips on the last ulp, the class the JAX package's engine
parity tests already budget), allowed on at most 1 lane in 10^4.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.kernels import traverse as jtr
from voxtracer.world import worldgen as jgen
from voxtracer_torch.kernels import traverse as ttr
from voxtracer_torch.world import svo as tsvo

torch.set_num_threads(2)
KEYS = ("hit", "t", "node", "normal", "voxel")


@pytest.fixture(scope="module", params=[6, 7])
def world(request):
    log2 = request.param
    dev = jgen.generate(log2_size=log2, verbose=False,
                        backend="python").serialize()
    return log2, dev, tsvo.upload(dev.table, dev.root, dev.height, "cpu")


def _rays(log2, rng):
    n = 1 << log2
    cam = jcam.Camera(pos=tuple(np.asarray(jcam.DEFAULT_POSE.pos) * n / 8192),
                      yaw=jcam.DEFAULT_POSE.yaw, pitch=jcam.DEFAULT_POSE.pitch)
    o, d = jcam.generate_rays(cam, 96, 56)
    B = 4096
    start = (rng.random((B, 3), np.float32) * n * 1.2 - 0.1 * n).astype(
        np.float32)
    rd = rng.normal(size=(B, 3)).astype(np.float32)
    rd[: B // 16, 0] = 0.0  # axis-parallel components
    rd /= np.linalg.norm(rd, axis=-1, keepdims=True)
    cap = np.where(rng.random(B) < 0.3, np.float32(jtr.FAR),
                   rng.random(B, np.float32) * n).astype(np.float32)
    active = rng.random(B) < 0.6
    return [
        ("camera", np.asarray(o)[0, 0], np.asarray(d), jtr.FAR, None),
        ("random", start, rd, cap, None),
        ("active", start, rd, cap, active),
    ]


def test_plain_cast_matches_jax(world, rng):
    log2, dev, w = world
    for name, start, d, dist, active in _rays(log2, rng):
        want = jtr.svo_raycast(
            jnp.asarray(dev.table.view(np.int32)), np.int32(dev.root),
            dev.height, jnp.asarray(start), jnp.asarray(d),
            distance=jnp.asarray(dist),
            active=None if active is None else jnp.asarray(active))
        got = ttr.svo_raycast(
            w.table, w.root, w.height, torch.from_numpy(np.array(start)),
            torch.from_numpy(np.array(d)), distance=torch.as_tensor(dist),
            active=None if active is None else torch.from_numpy(active))
        lanes = d.reshape(-1, 3).shape[0]
        bad = np.zeros(lanes, bool)
        for k in KEYS:
            a = np.asarray(want[k]).reshape(lanes, -1)
            b = got[k].numpy().reshape(lanes, -1)
            assert a.shape == b.shape, (name, k)
            bad |= (a != b).any(-1)
        assert bad.mean() <= 1e-4, f"{name}: {bad.sum()} edge-graze lanes"
        assert got["hit"].any() and not got["hit"].all()


def test_active_mask_and_empty_world(rng):
    dev = jgen.generate(log2_size=5, verbose=False, backend="python").serialize()
    w = tsvo.upload(dev.table, dev.root, dev.height, "cpu")
    o = torch.tensor([16.0, 40.0, 16.0])
    d = torch.tensor([[0.0, -1.0, 0.0]] * 4)
    r = ttr.svo_raycast(w.table, w.root, w.height, o, d,
                        active=torch.tensor([True, False, True, False]))
    assert r["hit"].tolist() == [True, False, True, False]
    assert r["node"][1] == -1 and r["t"][1] == 0
    assert torch.equal(r["normal"][0], torch.tensor([0.0, 1.0, 0.0]))
    r = ttr.svo_raycast(w.table, -1, w.height, o, d)
    assert not r["hit"].any()


def test_leaf_rgb_matches(world):
    _, dev, w = world
    node = np.array([-1, 0, 1, dev.root, len(dev.table) - 1], np.int32)
    want = jtr.leaf_rgb(jnp.asarray(dev.table.view(np.int32)),
                        jnp.asarray(node))
    got = ttr.leaf_rgb(w.table, torch.from_numpy(node))
    assert np.array_equal(np.asarray(want), got.numpy())


def test_cuda_wrapper_rejects_tall_trees():
    """The kernel's node stack holds height + 1 <= 16 slots; the check
    runs before any launch, so it is testable without a card."""
    with pytest.raises(ValueError, match="height"):
        ttr._svo_raycast_cuda(torch.zeros((1, 8), dtype=torch.int32), 0, 16,
                              None, torch.zeros((1, 3)), None, True, None)
