"""The one traffic generator: a traffic mix is a JSON file of parameters
under ``vtbench/workloads/``, found by its name; this module turns it and
the run's seed into the run's requests. The same seed gives the same
requests.

Two kinds of loop, both closed (the reference's headless mode is a busy
loop, and its window renders a frame, then polls input):

* ``headless``: back-to-back ``headless_run`` calls of one frame each,
  the sun stepped one day-cycle step a frame (main.rs:112-145).
* ``session``: the interactive app's actions (main.rs:149-309). Each
  action is a new pose (a move of ``move_step`` voxels in a seeded
  direction, kept within ``radius`` of the start, and a look drawn within
  ``look`` radians of the start's), then an optional edit at the
  crosshair (``edit``: deletes and placements alternate, the first drawn
  from the seed), a preview and ``samples_per_action`` samples.
"""

from __future__ import annotations

import json
import math
from pathlib import Path

import numpy as np

WORKLOADS = Path(__file__).resolve().parent / "workloads"


def load(name: str) -> dict:
    """The traffic mix ``name`` (``workloads/<name>.json``)."""
    path = WORKLOADS / f"{name}.json"
    if not path.is_file():
        raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
    return json.loads(path.read_text())


def rng(seed: int, stream: int) -> np.random.Generator:
    """A generator for one use of the seed (``stream`` keeps the uses
    apart); any whole number of any size."""
    return np.random.Generator(np.random.PCG64([stream, seed & (2**64 - 1),
                                                seed >> 64]))


def _forward_right(yaw: float):
    """The walking axes of a fly camera at ``yaw`` (the app's WASD moves:
    ``camera_basis(yaw, 0) @ (0, 0, 1)`` and ``@ (1, 0, 0)``)."""
    cy, sy = math.cos(yaw), math.sin(yaw)
    return np.array([sy, 0.0, cy]), np.array([cy, 0.0, -sy])


def session_actions(mix: dict, pose: dict, seed: int, count: int):
    """The first ``count`` actions of a session: a list of dicts with
    ``pos`` (3 floats), ``yaw``, ``pitch`` and ``edit`` (None, "del" or
    "place")."""
    g = rng(seed, 1)
    pos0 = np.asarray(mix.get("pos", pose["pos"]), np.float64)
    yaw0 = float(mix.get("yaw", pose["yaw"]))
    pitch0 = float(mix.get("pitch", pose["pitch"]))
    step = float(mix.get("move_step", 0.0))
    radius = float(mix.get("radius", 0.0))
    look = float(mix.get("look", 0.0))
    kinds = ("del", "place")
    k0 = int(g.integers(2))
    pos = pos0.copy()
    out = []
    for i in range(count):
        yaw = yaw0 + float(g.uniform(-look, look))
        pitch = pitch0 + float(g.uniform(-look, look))
        if step:
            fwd, right = _forward_right(yaw)
            axis = (fwd, -fwd, right, -right)[int(g.integers(4))]
            nxt = pos + axis * step
            if np.hypot(*(nxt - pos0)[[0, 2]]) > radius:
                nxt = pos - axis * step  # turned back at the edge
            pos = nxt
        out.append(dict(pos=tuple(float(c) for c in pos), yaw=yaw,
                        pitch=pitch,
                        edit=kinds[(k0 + i) % 2] if mix.get("edit") else None))
    return out


def check_pixels(seed: int, count: int, width: int, height: int,
                 stream: int, center: int = 0):
    """``count`` distinct pixels of a width x height frame drawn from the
    seed, as (px, py) int32 arrays; ``center`` > 0 puts the centre
    ``center`` x ``center`` block first (where the crosshair's edits
    show)."""
    g = rng(seed, stream)
    cx, cy = width // 2, height // 2
    first = [(cx - center // 2 + i) + (cy - center // 2 + j) * width
             for j in range(center) for i in range(center)]
    rest = np.setdiff1d(np.arange(width * height), first)
    idx = np.concatenate([np.asarray(first, np.int64), g.choice(
        rest, size=min(count - len(first), rest.size), replace=False)])
    return (idx % width).astype(np.int32), (idx // width).astype(np.int32)


def pick_checked(seed: int, n_done: int, count: int, stream: int = 3):
    """Which of ``n_done`` answers the check compares: ``count`` drawn
    from the seed, the last always among them."""
    if n_done <= count:
        return list(range(n_done))
    g = rng(seed, stream)
    rest = g.choice(n_done - 1, size=count - 1, replace=False)
    return sorted(int(i) for i in rest) + [n_done - 1]
