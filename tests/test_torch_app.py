"""Port: the app layer (voxtracer_torch/app: the CLI's parser and the
interactive editor session) on the CPU at 32^3, the counterparts of
tests/test_app.py, and one scripted session through both packages: the
same pose lines, the same picks and edits, and spaces that serialize to
equal tables."""

import numpy as np
import pytest
import torch

from voxtracer_torch.app import cli as tcli
from voxtracer_torch.app import interactive as tint
from voxtracer_torch.utils.profiling import FrameTimer

torch.set_num_threads(2)

SMALL = ["--log2-size", "5", "--width", "24", "--height", "16",
         "--max-bounces", "2", "--fog-steps", "4"]


def _run(args, script=None, **kw):
    """A session on the CPU; returns its log lines."""
    logs = []
    feed = None if script is None else iter(script)
    tint.run_interactive(
        args, input_fn=None if feed is None else (lambda _: next(feed)),
        log=lambda *a: logs.append(" ".join(map(str, a))), device="cpu",
        **kw)
    return logs


def test_parser_all_subcommands():
    ap = tcli.build_parser()
    for argv in (
        ["render", "--mode", "shaded", "--log2-size", "5"],
        ["headless", "--frame-samples", "2", "--max-frames", "1"],
        ["combine", "--frames-dir", "x", "--movie-dir", "y"],
        ["interact", "--spp", "1"],
        ["interact", "--noise-device", "cpu"],
    ):
        args = ap.parse_args(argv)
        assert callable(args.fn)
    args = ap.parse_args(["interact"])
    assert args.spp == 4 and args.noise_device == "default"
    with pytest.raises(SystemExit):
        ap.parse_args(["interact", "--noise-device", "tpu"])


def test_session_refuses_to_start_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = tcli.build_parser().parse_args(["interact"] + SMALL)
    with pytest.raises(RuntimeError, match="CUDA"):
        tint.run_interactive(args, input_fn=lambda _: "q")


def test_frame_timer_ring_buffer():
    t = FrameTimer(window=3)
    assert t.fps == 0.0
    for _ in range(5):
        t.tick()
    assert len(t.times) == 3 and t.frames == 5
    assert t.fps > 0 and t.mrays_per_sec(10**6) == pytest.approx(t.fps)


def test_interactive_session(tmp_path, monkeypatch):
    """Scripted interactive session: move, pick, edit, save."""
    monkeypatch.chdir(tmp_path)
    args = tcli.build_parser().parse_args(["interact", "--spp", "1"] + SMALL)
    logs = _run(args, ["pose", "w 2", "look 0.1 0.05", "r", "del", "place",
                       "spp 1", "save shot.png", "q"])
    assert (tmp_path / "preview.png").exists()
    assert (tmp_path / "shot.png").exists()
    assert any("pos=" in line for line in logs)


def test_interactive_live_progressive(tmp_path, monkeypatch):
    """Live (not scripted) mode accumulates samples while the input is
    idle, and a command restarts the accumulation."""
    monkeypatch.chdir(tmp_path)
    args = tcli.build_parser().parse_args(["interact", "--spp", "2"] + SMALL)
    polls = iter([None, None, None, "look 0.05 0.02", None, None, "q"])
    monkeypatch.setattr(tint, "_stdin_poller", lambda: lambda: next(polls))
    logs = _run(args)
    assert (tmp_path / "preview.png").exists()
    counts = [int(line.split()[0][1:]) for line in logs if "samples" in line]
    assert max(counts) >= 3
    assert any("fps" in line for line in logs)


def test_interactive_idle_cadence(tmp_path, monkeypatch):
    """With preview_interval=0 every idle tick presents the freshest
    accumulation, whatever the sample-count cadence (spp)."""
    monkeypatch.chdir(tmp_path)
    args = tcli.build_parser().parse_args(["interact", "--spp", "1000"]
                                          + SMALL)
    logs = _run(args, [None, None, None, None, "q"], preview_interval=0.0)
    counts = [int(line.split()[0][1:]) for line in logs if "samples" in line]
    assert counts == [1, 2, 3, 4, 5]
    assert (tmp_path / "preview.png").exists()


def test_interactive_fast_preview(tmp_path, monkeypatch):
    """A camera or edit command writes the shaded raster preview before
    the next path-traced sample's line."""
    monkeypatch.chdir(tmp_path)
    args = tcli.build_parser().parse_args(["interact", "--spp", "1"] + SMALL)
    logs = _run(args, ["w 3", "q"])
    raster_lines = [i for i, line in enumerate(logs)
                    if "raster preview" in line]
    assert raster_lines, logs
    assert [i for i, line in enumerate(logs)
            if "samples" in line and i > raster_lines[0]]
    assert (tmp_path / "preview.png").exists()


# a session whose picks land: the reference pose at 32^3 looks down onto
# terrain, and the moves keep the crosshair on it
PARITY_SCRIPT = ["pose", "del", "place", "w 2", "look 0.05 0.1", "del",
                 "place", "a 1", "up 1", "del", "pose", "r", "place",
                 "d 4", "g", "down 4", "look -0.2 -0.1", "del", "pose", "q"]


def _session_lines(logs):
    """The lines both packages print alike: everything but timings."""
    return [line for line in logs
            if "fps" not in line and not line.startswith("worldgen")]


def test_session_matches_jax(tmp_path, monkeypatch):
    """One script through both packages' sessions on the CPU: the same
    pose lines, picks and edits (deleted/placed voxels), and spaces that
    serialize to equal node tables."""
    from voxtracer.app import cli as jcli
    from voxtracer.app import interactive as jint

    monkeypatch.chdir(tmp_path)
    spaces = {}

    def keep(name, build):
        def wrapped(*a, **k):
            spaces[name] = build(*a, **k)
            return spaces[name]
        return wrapped

    monkeypatch.setattr(jcli, "_build_world", keep("jax", jcli._build_world))
    monkeypatch.setattr(tcli, "_build_world", keep("port", tcli._build_world))
    argv = ["interact", "--spp", "1", "--noise-device", "cpu"] + SMALL
    got = _session_lines(_run(tcli.build_parser().parse_args(argv),
                              PARITY_SCRIPT))
    jlogs = []
    feed = iter(PARITY_SCRIPT)
    jint.run_interactive(jcli.build_parser().parse_args(argv),
                         input_fn=lambda _: next(feed),
                         log=lambda *a: jlogs.append(" ".join(map(str, a))))
    want = _session_lines(jlogs)
    assert got == want
    edits = [line for line in got if line.startswith(("deleted", "placed"))]
    assert len(edits) >= 5, got
    assert sum(line.startswith("pos=") for line in got) == 3
    a, b = spaces["port"].serialize(), spaces["jax"].serialize()
    assert a.root == b.root and a.height == b.height
    assert np.array_equal(a.table, b.table)


def test_center_pick_equals_jax():
    """The crosshair pick against the JAX package's cast of the same ray
    (svo_raycast with skip_t0=False), from outside and from inside a
    block (t == 0 counts)."""
    import jax.numpy as jnp

    from voxtracer.core import camera as jcam
    from voxtracer.kernels.traverse import svo_raycast as jcast
    from voxtracer.world import worldgen as jgen
    from voxtracer_torch.world.svo import upload

    space = jgen.generate(log2_size=5, verbose=False, backend="python")
    dev = space.serialize()
    world = upload(dev.table, dev.root, dev.height, "cpu")
    table = jnp.asarray(dev.table.view(np.int32))
    top = int(space.heights[16, 16])
    poses = [((12.3, 20.7, 6.1), 0.4, 0.9), ((16.5, top - 0.5, 16.5), 0.2,
                                             1.2),
             ((3.0, 30.0, 3.0), 0.7, 0.3), ((16.0, 8.0, 16.0), 0.0, -1.2)]
    hits = 0
    for pos, yaw, pitch in poses:
        got = tint.center_pick(world, np.asarray(pos), yaw, pitch)
        d = np.asarray(jcam.camera_basis(yaw, pitch)) @ np.array([0., 0., 1.])
        r = jcast(table, np.int32(dev.root), dev.height,
                  jnp.asarray(np.asarray(pos)[None], jnp.float32),
                  jnp.asarray(d[None], jnp.float32), skip_t0=False)
        if not bool(np.asarray(r["hit"])[0]):
            assert got is None
            continue
        hits += 1
        assert np.array_equal(got[0], np.asarray(r["voxel"])[0])
        assert np.array_equal(got[1], np.asarray(r["normal"])[0]
                              .astype(np.int64))
    assert hits >= 3
