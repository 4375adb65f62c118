"""Worker for tests/test_torch_multihost.py: one process of a two-process
gloo job on the CPU, 4 shards each. Renders one sample-sharded step over
the job's 8 shards and writes the frame every process holds. Imports
torch and the port, never JAX.

Usage: python tests/_torch_multihost_worker.py PORT RANK OUT_PREFIX
"""

import os
import sys

port, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
os.environ.setdefault("OMP_NUM_THREADS", "2")

import numpy as np  # noqa: E402
import torch  # noqa: E402

torch.set_num_threads(2)

from voxtracer_torch.dist import multihost, shard  # noqa: E402

assert multihost.init(f"127.0.0.1:{port}", world_size=2, rank=rank,
                      local_devices=["cpu"] * 4)
import torch.distributed as dist  # noqa: E402

assert dist.get_backend() == "gloo" and dist.get_world_size() == 2

from tests.test_torch_multihost import (SEEDS, build_world,  # noqa: E402
                                        render_args)

table_np, root, height, lut_np = build_world()
mesh = multihost.global_mesh(["cpu"] * 4)
assert mesh.size == 4 and mesh.global_size == 8
table, lut = multihost.replicate_world_global(mesh, table_np, lut_np)
step = shard.sample_sharded_step(mesh, table, root, height, lut, 16, 12,
                                 max_bounces=2, fog_steps=4)
seeds = multihost.global_seeds(mesh, SEEDS[multihost.local_rows(mesh)])
frame = step(seeds, *render_args())
tstep = shard.tile_sharded_step(mesh, table, root, height, lut, 16, 12,
                                max_bounces=2, fog_steps=4)
tframe = tstep(SEEDS[0], *render_args())
np.save(f"{out}.{rank}.npy", multihost.local_frame(frame))
np.save(f"{out}.tile.{rank}.npy", multihost.local_frame(tframe))
multihost.shutdown()
assert not dist.is_initialized()
print("worker", rank, "ok", flush=True)
assert "jax" not in sys.modules
