"""The check on a 2^6 world on the CPU: the reference agrees with the
port (a headless frame, previews and samples, edits and picks); the
control, the reference in bfloat16 in the program's place, fails the
limits; and a run whose timed path is broken underneath comes out not
correct, once for each fault a cell can have."""

import numpy as np
import pytest
import torch

from vtbench.tests import tiny


CELLS = [("daycycle_8192", None), ("fly_8192", None), ("edit_8192", None),
         ("daycycle_8192", 4)]  # the day cycle sharded over four devices


@pytest.mark.parametrize("cell,devices", CELLS,
                         ids=[c + (f"-x{d}" if d else "") for c, d in CELLS])
def test_the_port_agrees_and_the_control_fails(cell, devices):
    """One process a cell: the program's numbers (a sample's frame, one
    preview and sample an action, one edit an action) are within the
    limits, and the control's are not."""
    import contextlib
    import io
    import json

    from vtbench import check, readings, traffic

    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = readings.main(["--workload", cell, "--seeds", "41",
                            "--control-seeds", "41", "--seconds", "2"],
                           test=tiny.overrides(cell, devices))
    assert rc == 0
    row = json.loads(out.getvalue().strip().splitlines()[-1])
    limits = traffic.load(cell.split("_")[0])["limits"]
    ok, _ = check.judge(row["program"], limits)
    assert ok, row
    ok, _ = check.judge(row["control"], limits)
    assert not ok, row


def _accumulator_unchanged(monkeypatch):
    from voxtracer_torch.render.accumulator import Accumulator

    def add(self, radiance, samples=1):
        self.samples += samples  # the sum is left as it was

    monkeypatch.setattr(Accumulator, "add", add)


def _half_the_samples(monkeypatch):
    from voxtracer_torch.render.accumulator import Accumulator

    orig = Accumulator.add
    calls = {"n": 0}

    def add(self, radiance, samples=1):
        calls["n"] += 1
        if calls["n"] % 2:
            orig(self, radiance, samples)  # the rest are left out

    monkeypatch.setattr(Accumulator, "add", add)


def _no_exchange(monkeypatch):
    from voxtracer_torch.dist import shard

    orig = shard.run_shards

    def run_shards(mesh, fn):
        out = orig(mesh, fn)
        return out[:1] + [torch.zeros_like(o) for o in out[1:]]

    monkeypatch.setattr(shard, "run_shards", run_shards)


def _preview_altered(monkeypatch):
    from voxtracer_torch.render.driver import Renderer

    orig = Renderer.preview_frame

    def preview_frame(self, cam, sun):
        img = orig(self, cam, sun)
        return img * 1.01 if img is not None else img

    monkeypatch.setattr(Renderer, "preview_frame", preview_frame)


def _frame_altered(monkeypatch):
    from voxtracer_torch.render import film

    orig = film.save_exr

    def save_exr(path, rgba):
        orig(path, np.asarray(rgba) * np.float32(1.05))

    monkeypatch.setattr(film, "save_exr", save_exr)


def _pick_altered(monkeypatch):
    from voxtracer_torch.app import interactive

    orig = interactive.center_pick

    def center_pick(world, pos, yaw, pitch):
        got = orig(world, pos, yaw, pitch)
        if got is None:
            return got
        voxel, normal = got
        return voxel + np.array([0, 1, 0]), normal

    monkeypatch.setattr(interactive, "center_pick", center_pick)


FAULTS = [
    ("daycycle_8192", None, _accumulator_unchanged),
    ("daycycle_8192", None, _half_the_samples),
    ("daycycle_8192", None, _frame_altered),
    ("daycycle_8192", 4, _no_exchange),
    ("fly_8192", None, _accumulator_unchanged),
    ("fly_8192", None, _preview_altered),
    ("edit_8192", None, _half_the_samples),
    ("edit_8192", None, _pick_altered),
]


@pytest.mark.parametrize(
    "cell,devices,fault", FAULTS,
    ids=[c + (f"-x{d}" if d else "") + "-" + f.__name__.strip("_")
         for c, d, f in FAULTS])
def test_a_broken_timed_path_is_not_correct(cell, devices, fault,
                                            monkeypatch):
    fault(monkeypatch)
    rc, out = tiny.run(cell, devices=devices)
    assert rc == 0
    assert out["correct"] is False, out["check"]
