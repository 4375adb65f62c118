"""The device mesh of multi-device rendering (the counterpart of
``voxtracer/dist/mesh.py``).

A mesh is an ordered tuple of this process's devices, one entry a shard,
and optionally the ``torch.distributed`` process group that joins it to
the same mesh in other processes (``dist/multihost.py``), held by a weak
reference: destroying the group frees it and joins its threads even
while meshes and the steps built on them live on. PyTorch has no named
mesh axis, so the mesh has none. Sample sharding traces one sample
on each entry; tile sharding one band of rows (``dist/shard.py``).

A device may stand in the mesh more than once: its shards then run in
turn on it and share one copy of the world. That is the counterpart of
the JAX tests' virtual CPU devices (``["cpu"] * 8``) and how one card
runs a four-shard step (``["cuda:0"] * 4``).
"""

from __future__ import annotations

import weakref
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class Mesh:
    devices: tuple  # one torch.device per local shard, in shard order
    group_ref: object = None  # weakref to the process group, or None

    @property
    def group(self):
        """The process group across processes, or None for one process.
        Raises once the group has been destroyed (``multihost.shutdown``)."""
        if self.group_ref is None:
            return None
        group = self.group_ref()
        if group is None:
            raise RuntimeError("the mesh's process group has been destroyed")
        return group

    @property
    def size(self) -> int:
        """This process's shards."""
        return len(self.devices)

    @property
    def distinct(self) -> tuple:
        """The mesh's devices without repeats, in order of first use."""
        return tuple(dict.fromkeys(self.devices))

    @property
    def rank(self) -> int:
        if self.group is None:
            return 0
        import torch.distributed as dist

        return dist.get_rank(self.group)

    @property
    def world_size(self) -> int:
        if self.group is None:
            return 1
        import torch.distributed as dist

        return dist.get_world_size(self.group)

    @property
    def global_size(self) -> int:
        """Shards over every process (each holds ``size``)."""
        return self.size * self.world_size


def _device(d) -> torch.device:
    """``d`` as a device with its index; a CUDA device must exist."""
    d = torch.device(d)
    if d.type != "cuda":
        return d
    if not torch.cuda.is_available():
        raise RuntimeError(f"make_mesh: {d} asked for, but "
                           "torch.cuda.is_available() is false")
    idx = torch.cuda.current_device() if d.index is None else d.index
    if idx >= torch.cuda.device_count():
        raise RuntimeError(f"make_mesh: cuda:{idx} asked for, "
                           f"{torch.cuda.device_count()} CUDA devices present")
    return torch.device("cuda", idx)


def make_mesh(n_devices: int | None = None, devices=None,
              group=None) -> Mesh:
    """The mesh over ``devices`` (repeats allowed), or else over the first
    ``n_devices`` CUDA cards (every card when None). Raises when fewer
    cards exist than asked for: it never makes a smaller mesh. ``group``:
    the process group joining this mesh to the other processes' meshes
    (held by a weak reference)."""
    ref = None if group is None else weakref.ref(group)
    if devices is not None:
        devs = tuple(_device(d) for d in devices)
        if not devs:
            raise ValueError("make_mesh: no devices given")
        if n_devices is not None and n_devices != len(devs):
            raise ValueError(f"make_mesh: n_devices {n_devices} but "
                             f"{len(devs)} devices given")
        return Mesh(devs, ref)
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    n = have if n_devices is None else int(n_devices)
    if have == 0 or not 1 <= n <= have:
        raise RuntimeError(f"make_mesh: {n_devices or 'every'} CUDA "
                           f"device(s) asked for, {have} present; pass "
                           "devices=['cpu'] * n for the CPU")
    return Mesh(tuple(torch.device("cuda", i) for i in range(n)), ref)
