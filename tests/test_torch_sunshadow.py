"""Port vs JAX: the sun-visibility maps (voxtracer_torch/kernels/
sunshadow.py against voxtracer/kernels/sunshadow.py) and their hooks
(``trace_paths(sun_maps=)``, ``render_sample(s)(sun_maps=)``, the
Renderer's ``_get_sun_maps``) on 64^3 terrain.

Tolerances. ``build`` is host numpy in both packages on the same
heights: both maps equal by bits, and gated suns None in both.
``sun_clear`` is two gathers and compares: equal by bits lane for lane.
With and without the maps the port's radiance and RNG state are equal
by bits (the maps only skip shadow walks whose outcome they prove); the
port's radiance with the maps against JAX's with its maps is held to the
path-sample budget of tests/test_torch_integrator.py (the class of
XLA's CPU code against the port's op-by-op rounding), and JAX's own with
and without are equal by bits, so the maps move neither package.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from test_sunshadow import _heightmaps, _origins, _suns
from voxtracer.core import camera as jcam
from voxtracer.core.spectra import build_wl_to_rgb_lut
from voxtracer.kernels import heightfield as jhf
from voxtracer.kernels import integrator as jint
from voxtracer.kernels import sunshadow as jsun
from voxtracer.world import worldgen as jgen
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.core import rng as trng
from voxtracer_torch.kernels import heightfield as thf
from voxtracer_torch.kernels import integrator as tint
from voxtracer_torch.kernels import sunshadow as tsun
from voxtracer_torch.render import driver as tdrv
from voxtracer_torch.world import svo as tsvo
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)
LOG2 = 6
FRAC, MEAN_REL = 5e-3, 1e-3  # tests/test_torch_integrator.py's budget
SUN = np.array([0.5, 0.8, 0.33])


@pytest.fixture(scope="module")
def terrain():
    space = jgen.generate(log2_size=LOG2, verbose=False, backend="python")
    return space, space.serialize()


@pytest.mark.parametrize("kind", ["rough", "spikes", "ridge"])
def test_build_and_query_equal_jax(kind):
    rng = np.random.default_rng(11)
    h = _heightmaps(rng)[kind]
    built = 0
    for sun in _suns():
        want = jsun.build(h, sun)
        got = tsun.build(h, sun)
        if want is None:
            assert got is None
            continue
        built += 1
        for k in ("t_near", "t_far"):
            assert got[k].dtype == np.float32
            assert np.array_equal(got[k].view(np.uint32),
                                  want[k].view(np.uint32)), k
        assert (got["pool"], got["subres"], got["n"]) == \
            (want["pool"], want["subres"], want["n"])
        pos = _origins(h, rng)
        jm = dict(want, t_near=jnp.asarray(want["t_near"]),
                  t_far=jnp.asarray(want["t_far"]))
        lit_j = np.asarray(jsun.sun_clear(jm, jnp.asarray(pos)))
        lit_t = tsun.sun_clear(tsun.upload(got, "cpu"), torch.from_numpy(pos))
        assert np.array_equal(lit_t.numpy(), lit_j)
    assert built >= 5
    assert tsun.upload(None, "cpu") is None


def _hf_args(space):
    tiles, offs, _ = thf.build_height_mips(np.asarray(space.heights),
                                           device="cpu")
    return dict(hf_mips=tiles, hf_offsets=offs,
                terrain_rgb=torch.tensor(np.asarray(space.terrain_rgb,
                                                    np.float32)))


def _sun_unit():
    return (SUN / np.linalg.norm(SUN)).astype(np.float32)


def test_trace_paths_state_and_radiance_equal_with_maps(terrain):
    """Every NEE lane the maps prove lit skips its walk; the state and the
    radiance of every lane, dead or alive, are the same bit for bit."""
    space, dev = terrain
    w = tsvo.upload(dev.table, dev.root, dev.height, "cpu")
    rng = np.random.default_rng(3)
    B = 2048
    start = np.stack([rng.uniform(4, 60, B), rng.uniform(30, 64, B),
                      rng.uniform(4, 60, B)], -1).astype(np.float32)
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d[:, 1] = -np.abs(d[:, 1])
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    wl = torch.from_numpy(rng.random(B, np.float32))
    state = trng.to_state(rng.integers(0, 2**32, (B, 3), dtype=np.uint32))
    lut = torch.from_numpy(build_wl_to_rgb_lut(256))
    sun = _sun_unit()
    maps = tsun.upload(tsun.build(space.heights, sun), "cpu")
    assert maps is not None
    hf = _hf_args(space)
    args = (w.table, w.root, w.height, lut, torch.from_numpy(start),
            torch.from_numpy(d), wl, torch.from_numpy(sun), state)
    steps0 = thf.plain_lane_steps
    s1, c1 = tint.trace_paths(*args, max_bounces=4, fog_steps=8, **hf)
    steps1 = thf.plain_lane_steps
    s2, c2 = tint.trace_paths(*args, max_bounces=4, fog_steps=8, **hf,
                              sun_maps=maps)
    steps2 = thf.plain_lane_steps
    assert torch.equal(s1, s2)
    assert torch.equal(c1.view(torch.int32), c2.view(torch.int32))
    assert c1.sum() > 0
    # the skipped walks: fewer heightfield steps with the maps
    assert steps2 - steps1 < steps1 - steps0


def _budget(img, want):
    assert img.shape == want.shape and np.isfinite(img).all()
    frac = (np.abs(img - want) > 1e-3).mean()
    assert frac <= FRAC, f"{frac:.4%} of values beyond 1e-3"
    assert abs(img.mean() / want.mean() - 1.0) <= MEAN_REL


def test_render_sample_with_maps_equals_without_and_jax(terrain):
    """tests/test_sunshadow.py's integrator case through both packages."""
    space, dev = terrain
    w = tsvo.upload(dev.table, dev.root, dev.height, "cpu")
    lut = build_wl_to_rgb_lut(256)
    cam = tcam.Camera(pos=(20.0, 50.0, 12.0), yaw=0.7, pitch=-0.5)
    sun = _sun_unit()
    maps = tsun.build(space.heights, sun)
    hf = _hf_args(space)
    seeds = np.array([[7, 1234, 99], [3, 4, 5]], np.uint32)
    W, H = 64, 48
    kw = dict(max_bounces=6, fog_steps=8)
    base = (w.table, w.root, w.height, torch.from_numpy(lut),
            np.asarray(cam.pos, np.float32), cam.basis(),
            torch.from_numpy(sun))
    a = tint.render_sample(*base, seeds[0], W, H, **kw, **hf)
    b = tint.render_sample(*base, seeds[0], W, H, **kw, **hf,
                           sun_maps=tsun.upload(maps, "cpu"))
    assert torch.equal(a, b) and a.sum() > 0
    ka = tint.render_samples(*base, seeds, W, H, **kw, **hf)
    kb = tint.render_samples(*base, seeds, W, H, **kw, **hf,
                             sun_maps=tsun.upload(maps, "cpu"))
    assert torch.equal(ka, kb)

    flat, offs, hh = jhf.build_height_mips(space.heights)
    jc = jcam.Camera(pos=np.array(cam.pos), yaw=cam.yaw, pitch=cam.pitch)
    jkw = dict(kw, hf_mips=flat, hf_offsets=offs,
               terrain_rgb=jnp.asarray(np.asarray(space.terrain_rgb,
                                                  np.float32)))
    jargs = (jnp.asarray(dev.table.view(np.int32)), np.int32(dev.root), hh,
             jnp.asarray(lut), np.asarray(cam.pos, np.float32), jc.basis(),
             jnp.asarray(sun), jnp.asarray(seeds[0]), W, H)
    jm = dict(maps, t_near=jnp.asarray(maps["t_near"]),
              t_far=jnp.asarray(maps["t_far"]))
    ja = np.asarray(jint.render_sample(*jargs, **jkw))
    jb = np.asarray(jint.render_sample(*jargs, **jkw, sun_maps=jm))
    assert np.array_equal(ja, jb)
    _budget(b.numpy(), jb)


def test_renderer_sun_maps_opt_in_cached_and_gated(monkeypatch):
    space = tgen.generate(log2_size=5, verbose=False, device="cpu")
    cam = tcam.Camera(pos=(12.0, 14.0, 6.0), yaw=0.4, pitch=0.5)
    sun = np.array([0.8, 10.2743, 3.7])

    def renderer():
        return tdrv.Renderer(space.serialize(), 32, 16, max_bounces=3,
                             fog_steps=8, seed=5, device="cpu")

    off = renderer()
    off.sample_batch(cam, sun, 2)
    assert off._sun_maps is None  # not opted in
    calls = []
    real = tsun.build
    monkeypatch.setattr(tsun, "build",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    monkeypatch.setenv("VOXT_SUNMAPS", "1")
    on = renderer()
    on.sample_batch(cam, sun, 2)
    maps = on._sun_maps
    assert maps is not None and torch.is_tensor(maps["t_near"])
    on.sample(cam, sun)
    assert len(calls) == 1 and on._sun_maps is maps  # cached per sun
    on.sample(cam, tdrv.rotate_sun(sun))
    assert len(calls) == 2  # a new sun builds anew
    monkeypatch.delenv("VOXT_SUNMAPS")
    off.sample(cam, sun)
    off.sample(cam, tdrv.rotate_sun(sun))
    assert np.array_equal(on.acc.mean(), off.acc.mean())
    # gates: a near-vertical sun builds None; an edited world takes none
    monkeypatch.setenv("VOXT_SUNMAPS", "1")
    assert on._get_sun_maps(np.float32([0.01, 1.0, 0.01])) is None
    space.set((3, int(space.heights[3, 3]) + 4, 3), (1.0, 0.2, 0.2))
    on.apply_edits(space, edits=[(3, int(space.heights[3, 3]) + 4, 3)])
    assert on._get_sun_maps(_sun_unit()) is None
