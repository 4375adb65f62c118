"""Checkpoint and resume for progressive renders and worlds.

The reference's only checkpoint is its EXR cadence: a crash loses at most
the current frame. Here the whole render state is saved: the accumulator
(the radiance SUM) and its sample count, the host RNG state, camera and
sun, and the world as its flat node table. The file is the JAX package's
(``voxtracer/render/checkpoint.py``): an ``.npz`` with ``meta`` (JSON),
``accumulator``, ``table`` (int32) and ``rng_state``, so either package
resumes the other's renders. A snapshot holds the whole node table; its
heightmap is not saved, so a resumed renderer casts on the SVO.
"""

from __future__ import annotations

import json

import numpy as np
import torch

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.world.svo import EMPTY, DeviceSvo

FORMAT_VERSION = 2  # the JAX package's (its v2 added an optional solid_leaf)


def save_render_state(path, renderer, cam: vcam.Camera, sun) -> None:
    """Snapshot a ``driver.Renderer`` mid-accumulation."""
    w = renderer.world
    meta = dict(
        version=FORMAT_VERSION,
        samples=renderer.acc.samples,
        width=renderer.width,
        height=renderer.height,
        max_bounces=renderer.max_bounces,
        fog_steps=renderer.fog_steps,
        cam_pos=list(map(float, cam.pos)),
        yaw=float(cam.yaw),
        pitch=float(cam.pitch),
        sun=list(map(float, np.asarray(sun, np.float64))),
        tree_height=int(w.height),
        root=int(w.root),
    )
    np.savez_compressed(
        path,
        meta=json.dumps(meta),
        accumulator=renderer.acc.buffer.cpu().numpy(),
        table=w.table.cpu().numpy(),
        rng_state=np.frombuffer(
            json.dumps(renderer.host_rng.getstate()).encode(), dtype=np.uint8),
    )


def load_render_state(path, device="cuda"):
    """Restore ``(renderer, cam, sun)`` from a snapshot, on ``device``."""
    from voxtracer_torch.render.driver import Renderer

    z = np.load(path, allow_pickle=False)
    meta = json.loads(str(z["meta"]))
    if not 1 <= meta["version"] <= FORMAT_VERSION:
        raise ValueError(f"checkpoint version {meta['version']} not supported")
    dev = DeviceSvo(
        table=np.ascontiguousarray(z["table"]).view(np.uint32),
        root=meta["root"] if meta["root"] >= 0 else EMPTY,
        height=meta["tree_height"],
    )
    r = Renderer(dev, meta["width"], meta["height"],
                 max_bounces=meta["max_bounces"], fog_steps=meta["fog_steps"],
                 device=device)
    state = json.loads(bytes(z["rng_state"]).decode())
    r.host_rng.setstate((state[0], tuple(state[1]), state[2]))
    cam = vcam.Camera(pos=tuple(meta["cam_pos"]), yaw=meta["yaw"],
                      pitch=meta["pitch"])
    sun = np.asarray(meta["sun"], np.float64)
    # re-arm the accumulator with the saved contents
    sun_unit = sun / np.linalg.norm(sun)
    r.acc.begin_sample(cam.pos, cam.yaw, cam.pitch,
                       sun_unit.astype(np.float32))
    r.acc.buffer.copy_(torch.from_numpy(np.asarray(z["accumulator"])))
    r.acc.samples = meta["samples"]
    return r, cam, sun


def save_world(path, space) -> None:
    """Persist a world as its serialized node table."""
    dev = space.serialize()
    np.savez_compressed(path, table=dev.table, root=np.int64(dev.root),
                        height=np.int64(dev.height))


def load_world_device(path) -> DeviceSvo:
    z = np.load(path)
    return DeviceSvo(table=z["table"], root=int(z["root"]),
                     height=int(z["height"]))
