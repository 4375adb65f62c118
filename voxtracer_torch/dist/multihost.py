"""Multi-process rendering on ``torch.distributed`` (the counterpart of
``voxtracer/dist/multihost.py``'s ``jax.distributed`` layer).

Every process runs the same program over its own devices; the process
group stitches the meshes together. The strategy stays sample sharding
(``dist/shard.py``): each shard traces the full frame with its own seed,
the process sums its shards in mesh order, and one ``all_reduce(SUM)``
across processes merges the batch, one frame of float32 a step whatever
the shard count. The global index of a process's i-th shard is ``rank *
size + i``.

Workflow (each process runs the same):

    init(..., local_devices=devs)                  # or torchrun's env
    mesh = global_mesh(devs)                       # this process's devices
    table, lut = replicate_world_global(mesh, table_np, lut_np)
    step = shard.sample_sharded_step(mesh, table, root, height, lut, W, H)
    seeds = global_seeds(mesh, all_seeds[local_rows(mesh)])
    frame = local_frame(step(seeds, cam_pos, cam_basis, sun))
    shutdown()                                     # before the process exits

A run on one host with torchrun: ``torchrun --nproc-per-node 1
script.py`` (``MASTER_ADDR``, ``MASTER_PORT``, ``WORLD_SIZE`` and
``RANK`` come from the launcher). NCCL takes one card per process: two
ranks on one card are refused ("Duplicate GPU detected"), so ranks that
share a card name ``backend="gloo"``.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from voxtracer_torch.dist import mesh as vmesh
from voxtracer_torch.dist.shard import replicate


def init(master_addr: str | None = None, world_size: int | None = None,
         rank: int | None = None, local_devices=None,
         backend: str | None = None) -> bool:
    """Join the process group of a multi-process job; a no-op returning
    False for one process (``world_size`` absent or 1).

    Arguments default to torchrun's environment: ``MASTER_ADDR`` and
    ``MASTER_PORT`` (``master_addr`` is ``host:port`` or a ``tcp://``
    URL), ``WORLD_SIZE`` and ``RANK``. ``local_devices``: the devices
    this process will give ``global_mesh`` (repeats allowed), every CUDA
    card by default; they must exist (``mesh.make_mesh`` raises).
    ``backend``: NCCL when the local devices are CUDA, gloo when they are
    the CPU, unless the caller names one; nothing switches it behind the
    caller's back."""
    if world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
    if world_size <= 1:
        return False
    if rank is None:
        rank = int(os.environ["RANK"])
    devices = vmesh.make_mesh(devices=local_devices).devices
    if backend is None:
        backend = "nccl" if devices[0].type == "cuda" else "gloo"
    if master_addr is None:
        master_addr = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ['MASTER_PORT']}")
    url = master_addr if "://" in master_addr else f"tcp://{master_addr}"
    import torch.distributed as dist

    dist.init_process_group(backend, init_method=url, world_size=world_size,
                            rank=rank)
    return True


def global_mesh(devices=None) -> vmesh.Mesh:
    """This process's mesh over ``devices`` (every card when None), joined
    to the job's process group when ``init`` made one. Every process
    gives the same number of devices."""
    import torch.distributed as dist

    group = dist.group.WORLD if dist.is_available() \
        and dist.is_initialized() else None
    return vmesh.make_mesh(devices=devices, group=group)


def global_seeds(mesh: vmesh.Mesh, local_seeds) -> np.ndarray:
    """This process's frame seeds, one (3,) uint32 row per local shard (the
    rows ``local_rows(mesh)`` of the job's seed array), checked and
    returned: no global array exists, and no seed crosses processes."""
    local_seeds = np.asarray(local_seeds, np.uint32)
    if local_seeds.shape != (mesh.size, 3):
        raise ValueError(f"need one seed row per local shard: "
                         f"{local_seeds.shape} != ({mesh.size}, 3)")
    return local_seeds


def replicate_world_global(mesh: vmesh.Mesh, *arrays):
    """Host arrays (node table, LUT) replicated onto this process's
    devices. Every process passes the same data (the world is
    deterministic from its seeds), so nothing big crosses processes."""
    return [replicate(mesh, torch.from_numpy(np.ascontiguousarray(a)))
            for a in arrays]


def local_frame(frame) -> np.ndarray:
    """The step's frame on the host (every process holds the same)."""
    return frame.detach().cpu().numpy()


def local_rows(mesh: vmesh.Mesh) -> list:
    """The global shard indices of this process's mesh entries."""
    return list(range(mesh.rank * mesh.size, (mesh.rank + 1) * mesh.size))


def shutdown() -> None:
    """End this process's part of the job: wait at a barrier until every
    process has finished its collectives, then destroy the process group;
    a no-op without one.

    Meshes hold their group by a weak reference, so destroying it frees
    the group and joins gloo's worker threads here, while the interpreter
    is whole. A group kept alive past this point (a strong reference of
    the caller's) keeps its threads too, and one that drops its last
    collective's tensors once the interpreter has begun to exit needs the
    GIL there and aborts the process ("terminate called without an active
    exception")."""
    import torch.distributed as dist

    if not (dist.is_available() and dist.is_initialized()):
        return
    dist.barrier()
    dist.destroy_process_group()
