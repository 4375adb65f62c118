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
    space = tgen.generate(log2_size=5, verbose=False, device="cpu")
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
    r2 = tdrv.Renderer(jdev, 32, 16, max_bounces=3, fog_steps=8, seed=0,
                       device="cpu")
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
                 ["render", "--mode", "shaded", "--engine", "ray"],
                 ["render", "--mode", "shadow"],
                 ["combine", "--frames-dir", "x", "--movie-dir", "y"]):
        assert callable(build_parser().parse_args(argv).fn)
    common = ["--log2-size", "5", "--width", "24", "--height", "16",
              "--max-bounces", "2", "--fog-steps", "4"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in (["headless", *common, "--max-frames", "1"],
                 ["render", *common, "--spp", "1"],
                 ["render", *common, "--mode", "shaded"]):
        with pytest.raises(RuntimeError, match="CUDA card"):
            main(argv)
    _, cam, r = _renderer()
    tdrv.headless_run(r, cam, out_dir=tmp_path / "frames", frame_samples=2,
                      max_frames=1, log=lambda line: None)
    main(["combine", "--frames-dir", str(tmp_path / "frames"),
          "--movie-dir", str(tmp_path / "movie")])
    assert (tmp_path / "movie" / "0.png").exists()


def test_entry_points_default_to_the_card(monkeypatch):
    """Renderer, generate and heightmap run on the card unless the caller
    asks for the CPU; so do make_mesh, the Renderer's sharded step
    (``devices=``) and multihost.init: without a card they raise, given
    CPU devices they run there."""
    import inspect

    from voxtracer_torch.dist import mesh as tmesh
    from voxtracer_torch.dist import multihost

    for fn in (tdrv.Renderer.__init__, tgen.generate, tgen.heightmap):
        assert inspect.signature(fn).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dev = tgen.generate(log2_size=4, verbose=False, device="cpu").serialize()
    with pytest.raises(RuntimeError, match="CUDA"):
        tmesh.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        tdrv.Renderer(dev, 16, 8, devices=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        multihost.init("127.0.0.1:1", world_size=2, rank=0)
    r = tdrv.Renderer(dev, 16, 8, max_bounces=2, fog_steps=4,
                      devices=["cpu"] * 2)
    assert r.device == torch.device("cpu") and r.mesh.size == 2


def test_soup_built_once_bins_once_per_pose(monkeypatch):
    """A terrain world rasterizes its primaries: the soup is extracted
    once, the bins once per pose, and a pose change rebuilds the bins."""
    calls = {"soup": 0, "bins": 0}

    def counted(name, fn):
        def wrapper(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return wrapper

    monkeypatch.setattr(tdrv.boxes, "extract_boxes",
                        counted("soup", tdrv.boxes.extract_boxes))
    monkeypatch.setattr(tdrv.raster, "raster_bins",
                        counted("bins", tdrv.raster.raster_bins))
    space, cam, r = _renderer()
    assert r.soup_world
    sun = np.array([0.8, 10.2743, 3.7])
    r.sample(cam, sun)
    r.sample_batch(cam, sun, 2)
    assert calls == {"soup": 1, "bins": 1}
    cam2 = tcam.Camera(pos=(12.5, 14.0, 6.0), yaw=0.4, pitch=0.5)
    r.sample(cam2, sun)
    assert calls == {"soup": 1, "bins": 2}
    img = r.preview_frame(cam2, sun)
    assert img.shape == (16, 32, 3) and torch.isfinite(img).all()
    assert calls == {"soup": 1, "bins": 2} and img.max() > 0
    # an edit leaves no exact heightmap: the new world's soup is its
    # octree's instances, extracted once; the heightfield engine is off
    space.set((12, 13, 6), (1.0, 1.0, 1.0))
    r.update_space(space.serialize())
    assert r.soup_world and r._get_hf()[0] is None
    img = r.preview_frame(cam, sun)
    r.sample(cam, sun)
    assert calls == {"soup": 2, "bins": 3} and img.max() > 0


def test_dense_world_keeps_svo_primaries():
    """A JAX from_dense world has no heightmap: decided up front, its
    primaries stay on the SVO cast, and the radiance equals a renderer
    told not to rasterize."""
    from voxtracer.world.svo import from_dense

    rng = np.random.default_rng(3)
    solid = np.zeros((32, 32, 32), bool)
    solid[:, :6] = rng.random((32, 6, 32)) < 0.7
    dev = from_dense(solid, np.full((32, 32, 32, 3), 0.5,
                                    np.float32)).serialize()
    cam = tcam.Camera(pos=(12.0, 14.0, 6.0), yaw=0.4, pitch=0.5)
    sun = np.array([0.8, 10.2743, 3.7])
    a = tdrv.Renderer(dev, 32, 16, max_bounces=3, fog_steps=8, seed=1,
                      device="cpu")
    b = tdrv.Renderer(dev, 32, 16, max_bounces=3, fog_steps=8, seed=1,
                      device="cpu", use_soup=False)
    assert not a.soup_world and a._get_soup() is None
    a.sample(cam, sun)
    b.sample(cam, sun)
    assert np.array_equal(a.acc.mean(), b.acc.mean())


def test_soup_and_svo_primaries_agree():
    """The default renderer (rasterized primaries) and use_soup=False
    accumulate the same radiance on a terrain world."""
    sun = np.array([0.8, 10.2743, 3.7])
    space, cam, a = _renderer(seed=5)
    b = tdrv.Renderer(space.serialize(), 32, 16, max_bounces=3, fog_steps=8,
                      seed=5, device="cpu", use_soup=False)
    a.sample_batch(cam, sun, 2)
    b.sample_batch(cam, sun, 2)
    assert a.soup_world and not b.soup_world
    assert np.array_equal(a.acc.mean(), b.acc.mean())


def test_headless_frames_take_whole_batches(tmp_path):
    """Every frame is traced in calls of ``batch`` samples: a new frame
    does not start with a single sample."""
    _, cam, r = _renderer()
    calls = []
    orig = r.sample_batch
    r.sample = lambda *a: calls.append(1)
    r.sample_batch = lambda c, s, k: (calls.append(k), orig(c, s, k))
    tdrv.headless_run(r, cam, out_dir=tmp_path, frame_samples=4,
                      max_frames=2, batch=2, log=lambda line: None)
    assert calls == [2, 2, 2, 2]


def test_hf_and_svo_engines_agree():
    """``use_hf`` (the default) against ``use_hf=False``, with rasterized
    and with per-ray primaries: one radiance, bit for bit; the pack is
    built once per world and dropped with it."""
    sun = np.array([0.8, 10.2743, 3.7])
    space, cam, a = _renderer(seed=5)
    out = []
    for kw in (dict(), dict(use_hf=False), dict(use_soup=False),
               dict(use_hf=False, use_soup=False)):
        r = tdrv.Renderer(space.serialize(), 32, 16, max_bounces=3,
                          fog_steps=8, seed=5, device="cpu", **kw)
        r.sample(cam, sun)
        r.sample_batch(cam, sun, 2)
        assert (r._get_hf()[0] is not None) == kw.get("use_hf", True)
        out.append(r.acc.buffer)
    for b in out[1:]:
        assert torch.equal(out[0], b)
    pack = a._get_hf()
    assert a._get_hf()[0] is pack[0]
    a.update_space(space.serialize())
    assert a._hf is None and a._get_hf()[0] is not pack[0]
    space.set((3, 3, 3), (1.0, 0.0, 0.0))  # no exact heightmap any more
    a.update_space(space.serialize())
    assert a._get_hf() == (None, None, None)


def test_renderer_hf_only_mode(monkeypatch):
    """The policy for the reference's scale (``HF_FRAME_SIZE`` lowered to
    this world): no soup is built, previews are exact heightfield frames,
    samples accumulate, and everything equals the SVO engine's."""
    from voxtracer_torch.kernels import shade
    from voxtracer_torch.world import boxes

    space = tgen.generate(log2_size=6, verbose=False, device="cpu")
    cam = tcam.Camera(pos=(0.62 * 64, float(space.heights.max()) + 5.0,
                           0.35 * 64), yaw=2.2, pitch=-0.3)
    sun = np.asarray([0.8, 10.2743, 3.7])
    assert tdrv.Renderer.HF_FRAME_SIZE == 4096
    monkeypatch.setattr(tdrv.Renderer, "HF_FRAME_SIZE", 64)
    monkeypatch.setattr(boxes, "extract_boxes", lambda *a, **k: 1 / 0)
    r = tdrv.Renderer(space.serialize(), 32, 24, max_bounces=2, fog_steps=4,
                      seed=3, device="cpu")
    assert r._hf_only() and r._get_soup() is None and r._soup is None
    img = r.preview_frame(cam, sun)
    o, d = tcam.generate_rays(cam, 32, 24, device="cpu")
    su = torch.from_numpy((sun / np.linalg.norm(sun)).astype(np.float32))
    w = r.world
    assert torch.equal(img, shade.svo_primary_frame(w.table, w.root, w.height,
                                                    o, d, su))
    assert img.sum() > 0
    r.sample(cam, sun)
    r.sample_batch(cam, sun, 2)
    s = tdrv.Renderer(space.serialize(), 32, 24, max_bounces=2, fog_steps=4,
                      seed=3, device="cpu", use_hf=False, use_soup=False)
    assert not s._hf_only() and s.preview_frame(cam, sun) is None
    s.sample(cam, sun)
    s.sample_batch(cam, sun, 2)
    assert r.acc.samples == 3 and torch.equal(r.acc.buffer, s.acc.buffer)


def test_cli_headless_checkpoint_flags(tmp_path, monkeypatch):
    args = build_parser().parse_args(
        ["headless", "--checkpoint-every", "8", "--checkpoint-path",
         str(tmp_path / "s.npz")])
    assert args.checkpoint_every == 8
    assert args.checkpoint_path == str(tmp_path / "s.npz")
    args = build_parser().parse_args(["headless"])
    assert args.checkpoint_every is None
    assert args.checkpoint_path == "render_state.npz"


def test_sky_env_tiers_by_pose_reuse(monkeypatch):
    """An hf-only Renderer builds the pose's envelope at tier 0, climbs to
    tier 1 at the second use and tier 2 at the fifth (SKY_TIERS); a new
    pose starts again at tier 0; update_space drops the pyramid and the
    table; sample_batch hands the envelope to render_samples."""
    monkeypatch.setattr(tdrv.Renderer, "HF_FRAME_SIZE", 32)
    space, cam, r = _renderer()
    assert r._hf_only() and r._sky_env is None
    tiers = []
    for _ in range(6):
        env = r._get_sky_env(cam)
        tiers.append(r._sky_env[2])
        assert env[0].shape == (8192, r.SKY_TIERS[tiers[-1]][0]["K"])
    assert tiers == [0, 1, 1, 1, 2, 2]
    cam2 = tcam.Camera(pos=(12.5, 14.0, 6.0), yaw=0.4, pitch=0.5)
    r._get_sky_env(cam2)
    assert r._sky_env[2] == 0 and r._sky_mips is not None

    seen = {}
    real = tdrv.render_samples

    def spy(*a, **k):
        seen.update(k)
        return real(*a, **k)

    monkeypatch.setattr(tdrv, "render_samples", spy)
    sun = np.array([0.8, 10.2743, 3.7])
    r.sample_batch(cam2, sun, 2)
    E, d0, g, K, S = seen["hf_sky_env"]
    assert E is r._sky_env[1][0] and S is r._sky_env[1][4]
    assert seen["soup"] is None
    b = tdrv.Renderer(space.serialize(), 32, 16, max_bounces=3, fog_steps=8,
                      seed=0, device="cpu", use_soup=False)
    monkeypatch.setattr(tdrv.Renderer, "_get_sky_env", lambda self, c: None)
    b.sample_batch(cam2, sun, 2)
    assert torch.equal(r.acc.buffer, b.acc.buffer)
    r.update_space(space.serialize())
    assert r._sky_env is None and r._sky_mips is None
