"""Port: the headless day-cycle, combine, the CLI and the Renderer
(voxtracer_torch/render and app), on the CPU at a small size. Files must
be readable by the JAX package's film codec and the sun schedule equal
to voxtracer/render/driver.py's."""

import numpy as np
import pytest
import torch

from voxtracer.render import driver as jdrv
from voxtracer.render import film as jfilm
from voxtracer.world import worldgen as jgen
from voxtracer_torch.app.cli import build_parser, main
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.render import driver as tdrv
from voxtracer_torch.render import film as tfilm
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)


def _renderer(seed=0):
    space = tgen.generate(log2_size=5, verbose=False)
    cam = tcam.Camera(pos=(12.0, 14.0, 6.0), yaw=0.4, pitch=0.5)
    r = tdrv.Renderer(space.serialize(), 32, 16, max_bounces=3, fog_steps=8,
                      seed=seed, device="cpu")
    return space, cam, r


def test_headless_run_and_combine(tmp_path):
    _, cam, r = _renderer()
    lines = []
    tdrv.headless_run(r, cam, out_dir=tmp_path / "frames", frame_samples=2,
                      max_frames=2, batch=2, log=lines.append)
    exrs = sorted((tmp_path / "frames").glob("*.exr"))
    assert [p.name for p in exrs] == ["0000-000.exr", "0000-001.exr"]
    assert sum("paths/px/sec" in line for line in lines) == 2
    for p in exrs:
        img = jfilm.load_exr(p)  # the JAX package's codec reads them
        assert img.shape == (16, 32, 4) and np.isfinite(img).all()
        assert img[..., :3].mean() > 0 and (img[..., 3] == 1).all()
        assert np.array_equal(img, tfilm.load_exr(p))
    tdrv.combine(tmp_path / "frames", tmp_path / "movie", log=lines.append)
    assert (tmp_path / "movie" / "0.png").exists()
    assert (tmp_path / "movie" / "1.png").exists()


def test_batch_equals_single_samples():
    """sample_batch(k) accumulates the same radiance as k sample() calls
    drawing the same frame seeds."""
    sun = np.array([0.8, 10.2743, 3.7])
    _, cam, a = _renderer(seed=7)
    _, _, b = _renderer(seed=7)
    a.sample_batch(cam, sun, 3)
    for _ in range(3):
        b.sample(cam, sun)
    assert a.acc.samples == b.acc.samples == 3
    assert np.array_equal(a.acc.mean(), b.acc.mean())


def test_renderer_takes_jax_world_and_restarts_on_update(tmp_path):
    jdev = jgen.generate(log2_size=5, verbose=False, backend="python").serialize()
    space, cam, r = _renderer()
    r2 = tdrv.Renderer(jdev, 32, 16, max_bounces=3, fog_steps=8, seed=0)
    sun = np.array([0.8, 10.2743, 3.7])
    r.sample(cam, sun)
    r2.sample(cam, sun)
    assert np.array_equal(r.acc.mean(), r2.acc.mean())
    space.set((12, 13, 6), (1.0, 1.0, 1.0))
    r.update_space(space.serialize())
    r.sample(cam, sun)
    assert r.acc.samples == 1  # the world changed: accumulation restarted
    r.save_png(tmp_path / "f.png")
    assert (tmp_path / "f.png").exists()


def test_retry_then_raise():
    _, cam, r = _renderer()
    calls = []

    def boom(*a):
        calls.append(1)
        raise RuntimeError("device lost")

    r.sample = boom
    lines = []
    with pytest.raises(RuntimeError):
        tdrv.headless_run(r, cam, frame_samples=1, max_frames=1,
                          log=lines.append)
    assert len(calls) == 4
    assert sum("sample failed" in line for line in lines) == 4


def test_rotate_sun_matches_jax():
    sun = jdrv.SUN_START / np.linalg.norm(jdrv.SUN_START)
    a, b = sun, sun
    for _ in range(50):
        a, b = jdrv.rotate_sun(a), tdrv.rotate_sun(b)
        assert np.array_equal(a, b)


def test_cli_headless_combine_render(tmp_path, monkeypatch):
    """The CLI's parser takes the JAX CLI's subcommands; render and
    headless refuse to start without a card; combine reads the frames a
    CPU headless run wrote."""
    monkeypatch.chdir(tmp_path)
    for argv in (["render", "--mode", "path"], ["headless"],
                 ["combine", "--frames-dir", "x", "--movie-dir", "y"]):
        assert callable(build_parser().parse_args(argv).fn)
    common = ["--log2-size", "5", "--width", "24", "--height", "16",
              "--max-bounces", "2", "--fog-steps", "4"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["headless", *common, "--max-frames", "1"],
                 ["render", *common, "--spp", "1"]):
        with pytest.raises(RuntimeError, match="CUDA card"):
            main(argv)
    _, cam, r = _renderer()
    tdrv.headless_run(r, cam, out_dir=tmp_path / "frames", frame_samples=2,
                      max_frames=1, log=lambda line: None)
    main(["combine", "--frames-dir", str(tmp_path / "frames"),
          "--movie-dir", str(tmp_path / "movie")])
    assert (tmp_path / "movie" / "0.png").exists()
