"""Port: multi-process rendering (voxtracer_torch/dist/multihost.py), a
real two-process job over torch.distributed's gloo backend on 127.0.0.1,
each process owning 4 CPU shards, with the world, seeds and camera of
tests/test_multihost.py. Every process's frame must be equal by bits to
the other's, and within rtol 1e-6 / atol 1e-6 of the single-process
8-shard step (the two processes' sums meet in another order: the same
samples, an ulp of sum jitter, as in the JAX test). The tile-sharded
step's gathered bands equal the full frame by bits. ``multihost.shutdown``
frees the group and joins its threads while meshes and steps built on it
live on. Imports no JAX: the worker (tests/_torch_multihost_worker.py)
imports this module."""

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

torch.set_num_threads(2)
SEEDS = np.stack(
    [np.array([3 * i + 1, 5 * i + 2, 7 * i + 3], np.uint32) for i in range(8)]
)


def build_world():
    """tests/test_multihost.py's world and LUT, built by the port (its
    from_dense table equals the JAX package's by bits)."""
    from voxtracer_torch.core.spectra import build_wl_to_rgb_lut
    from voxtracer_torch.world.svo import from_dense

    rng = np.random.default_rng(42)
    solid = rng.random((8, 8, 8)) < 0.25
    rgb = rng.random((8, 8, 8, 3)).astype(np.float32)
    dev = from_dense(solid, rgb).serialize()
    return (dev.table.view(np.int32), int(dev.root), dev.height,
            np.asarray(build_wl_to_rgb_lut()))


def render_args():
    from voxtracer_torch.core import camera as vcam

    cam = vcam.Camera(pos=(4.0, 9.0, -4.0), yaw=0.2, pitch=-0.5)
    sun = np.array([0.3, 0.8, 0.5])
    sun = torch.from_numpy((sun / np.linalg.norm(sun)).astype(np.float32))
    return np.asarray(cam.pos, np.float32), cam.basis(), sun


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_job_matches_single_process(tmp_path):
    from voxtracer_torch.dist import mesh as tmesh
    from voxtracer_torch.dist import shard
    from voxtracer_torch.kernels.integrator import render_sample

    repo = Path(__file__).resolve().parents[1]
    port = _free_port()
    out = tmp_path / "frame"
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="2")
    procs = [
        subprocess.Popen(
            [sys.executable,
             str(repo / "tests" / "_torch_multihost_worker.py"), str(port),
             str(rank), str(out)],
            cwd=repo, env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        for rank in range(2)
    ]
    logs = []
    try:
        for p in procs:
            stdout, _ = p.communicate(timeout=240)
            logs.append(stdout)
    finally:
        for p in procs:
            p.kill()
    assert all(p.returncode == 0 for p in procs), "\n---\n".join(logs)
    assert "jax" not in "".join(logs).lower()

    f0, f1 = (np.load(f"{out}.{r}.npy") for r in range(2))
    np.testing.assert_array_equal(f0, f1)
    t0, t1 = (np.load(f"{out}.tile.{r}.npy") for r in range(2))
    np.testing.assert_array_equal(t0, t1)

    table_np, root, height, lut_np = build_world()
    mesh = tmesh.make_mesh(devices=["cpu"] * 8)
    table, lut = torch.from_numpy(table_np), torch.from_numpy(lut_np)
    step = shard.sample_sharded_step(mesh, table, root, height, lut, 16, 12,
                                     max_bounces=2, fog_steps=4)
    ref = step(SEEDS, *render_args()).numpy()
    np.testing.assert_allclose(f0, ref, rtol=1e-6, atol=1e-6)
    full = render_sample(table, root, height, lut, *render_args(), SEEDS[0],
                         16, 12, max_bounces=2, fog_steps=4).numpy()
    assert t0.shape == (16, 16, 3)  # ceil(12 / 8) = 2 rows a shard
    np.testing.assert_array_equal(t0[:12], full)


_SHUTDOWN_PROBE = """
import os, sys, weakref
import numpy as np, torch
import torch.distributed as dist
torch.set_num_threads(2)
from voxtracer_torch.dist import multihost, shard
from voxtracer_torch.kernels.integrator import render_sample
from tests.test_torch_multihost import SEEDS, build_world, render_args

def n_threads():
    return len(os.listdir("/proc/self/task"))

table_np, root, height, lut_np = build_world()
table, lut = torch.from_numpy(table_np), torch.from_numpy(lut_np)
render_sample(table, root, height, lut, *render_args(), SEEDS[0], 16, 12,
              max_bounces=2, fog_steps=4)  # the intra-op threads start
multihost.shutdown()  # no group yet: a no-op
before = n_threads()
dist.init_process_group("gloo", init_method="tcp://127.0.0.1:" + sys.argv[1],
                        world_size=1, rank=0)
mesh = multihost.global_mesh(["cpu"] * 2)
step = shard.sample_sharded_step(mesh, table, root, height, lut, 16, 12,
                                 max_bounces=2, fog_steps=4)
tstep = shard.tile_sharded_step(mesh, table, root, height, lut, 16, 12,
                                max_bounces=2, fog_steps=4)
frame = step(SEEDS[:2], *render_args())
tframe = tstep(SEEDS[0], *render_args())
during = n_threads()
group = weakref.ref(dist.group.WORLD)
multihost.shutdown()
assert not dist.is_initialized()
assert group() is None, "a mesh or step still holds the process group"
after = n_threads()
assert after <= before < during, (before, during, after)
for use in (lambda: mesh.rank, lambda: step(SEEDS[:2], *render_args())):
    try:
        use()
    except RuntimeError as e:
        assert "destroyed" in str(e), e
    else:
        raise AssertionError("a mesh whose group was destroyed was used")
print("threads", before, during, after, flush=True)
"""


def test_shutdown_frees_the_group_and_joins_its_threads():
    """The cause of a teardown abort: ``destroy_process_group`` alone left
    the gloo group alive while a mesh held it, so its worker threads ran
    into the interpreter's exit, where one releasing its last
    collective's tensors needed the GIL and aborted the process
    ("terminate called without an active exception"). After
    ``multihost.shutdown`` the group is freed, its threads are joined,
    and the meshes and steps built on it raise. Linux (/proc)."""
    repo = Path(__file__).resolve().parents[1]
    env = dict(os.environ, PYTHONPATH=str(repo), OMP_NUM_THREADS="2")
    res = subprocess.run([sys.executable, "-c", _SHUTDOWN_PROBE,
                          str(_free_port())], cwd=repo, env=env,
                         capture_output=True, text=True, timeout=240)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "threads" in res.stdout
