"""Port vs JAX: the beam engine (voxtracer_torch/kernels/beam.py: the
plain versions of kernels K6 (walk) and K7 (resolve), the frame cast,
the shadow mask and frames, and ``render_sample(aug=)``) against
voxtracer/kernels/beam.py, on the scenes of tests/test_beam.py (a 32^3
random fill, a solid world, a floor, 64^3 terrain).

Tolerances. Both packages get one set of directions (JAX's pixel-centre
grid, as the frame parity tests do): XLA's camera product differs from
the port's in the last bit at some pixels. Augmented rows: equal by bits.
The walk's candidates (levels, corners, colours, the done flag, t_safe)
and its resumed rounds: equal by bits. The resolve and the frame cast
(hit, t, normal, rgb, voxel): equal by bits; the resolve's voxel is
``floor(o + dm * t)`` off the hit axis, which XLA may fuse into one FMA,
so a crossing within an ulp of a plane could move one voxel (none seen).
Against the port's own per-ray SVO cast, tests/test_beam.py's budget:
none on generic cameras. The shadow frame: equal by bits to JAX's, and
within tests/test_beam.py's 1e-3 share (atol 1e-4) of the per-ray shadow
frame. ``render_sample(aug=)``: the path-sample budget of
tests/test_torch_integrator.py against JAX's, and equal by bits to the
port's per-ray render on all but the graze share (2 in 4096) of pixels.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.core.spectra import build_wl_to_rgb_lut
from voxtracer.kernels import beam as jb
from voxtracer.kernels import integrator as jint
from voxtracer.world import worldgen as jgen
from voxtracer.world.svo import from_dense
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import beam as tb
from voxtracer_torch.kernels import integrator as tint
from voxtracer_torch.kernels import shade as tshade
from voxtracer_torch.kernels import traverse as ttr
from voxtracer_torch.world import svo as tsvo

torch.set_num_threads(2)
KEYS = ("hit", "t", "normal", "rgb", "voxel")
FRAC, MEAN_REL = 5e-3, 1e-3  # tests/test_torch_integrator.py's budget


@pytest.fixture(scope="module")
def clutter():
    rng = np.random.default_rng(5)
    n = 32
    solid = rng.random((n, n, n)) < 0.2
    rgb = rng.random((n, n, n, 3)).astype(np.float32)
    rgb[~solid] = 0
    return _world(from_dense(solid, rgb).serialize())


def _world(dev):
    aug = tb.build_aug_table(dev.table, dev.solid_leaf)
    return dict(dev=dev, aug=aug, aug_t=torch.from_numpy(aug),
                w=tsvo.upload(dev.table, dev.root, dev.height, "cpu"),
                table_j=jnp.asarray(dev.table.view(np.int32)))


def _dirs(pos, yaw, pitch, W, H):
    cam = jcam.Camera(pos=pos, yaw=yaw, pitch=pitch)
    return np.array(jcam.generate_rays(cam, W, H)[1])


def _bits_equal(a, b):
    a, b = np.asarray(a), np.asarray(b)
    return a.shape == b.shape and np.array_equal(
        np.ascontiguousarray(a).view(np.uint8),
        np.ascontiguousarray(b).view(np.uint8))


def test_aug_table_equals_jax(clutter):
    dev = clutter["dev"]
    assert _bits_equal(clutter["aug"],
                       jb.build_aug_table(dev.table, dev.solid_leaf))


@pytest.mark.parametrize("pos,yaw,pitch,K", [
    ((16.3, 16.7, -10.2), 0.31, 0.12, 64),
    ((5.3, 30.1, 4.2), 0.8, -0.7, 8),    # pauses on nearly every tile
    ((16.5, 16.5, 16.5), 0.3, -0.2, 16),  # starts inside geometry
])
def test_walk_and_resolve_rounds_equal_jax(clutter, pos, yaw, pitch, K):
    dev, W, H = clutter["dev"], 64, 40
    d = _dirs(pos, yaw, pitch, W, H)
    op = np.asarray(pos, np.float32)
    dt = d.reshape(H // 8, 8, W // 8, 8, 3).transpose(0, 2, 1, 3, 4) \
        .reshape(-1, 64, 3)
    dlo, dhi = dt.min(1), dt.max(1)
    ob = np.broadcast_to(op, dlo.shape).copy()
    sj = st = None
    collected = 0
    for _ in range(3):
        cj, sj = jb.beam_walk(jnp.asarray(clutter["aug"]), np.int32(dev.root),
                              dev.height, jnp.asarray(ob), jnp.asarray(ob),
                              jnp.asarray(dlo), jnp.asarray(dhi), K=K,
                              max_steps=200, state=sj)
        ct, st = tb.beam_walk(clutter["aug_t"], dev.root, dev.height,
                              torch.from_numpy(ob), torch.from_numpy(ob),
                              torch.from_numpy(dlo), torch.from_numpy(dhi),
                              K=K, max_steps=200, state=st)
        for k in ("lvl", "off", "rgb", "ok", "t_safe"):
            assert _bits_equal(ct[k].numpy(), cj[k]), k
        collected += int((ct["lvl"] >= 0).sum())
        rj = jb.resolve_candidates(cj["lvl"], cj["off"], cj["rgb"],
                                   jnp.asarray(op), jnp.asarray(dt),
                                   dev.height)
        rt = tb.resolve_candidates(ct["lvl"], ct["off"], ct["rgb"], op,
                                   torch.from_numpy(dt), dev.height)
        for k in KEYS:
            assert _bits_equal(rt[k].numpy(), rj[k]), k
    assert collected > 0


def _frame_pair(world, pos, yaw, pitch, W=64, H=40, K=64):
    dev = world["dev"]
    d = _dirs(pos, yaw, pitch, W, H)
    op = np.asarray(pos, np.float32)
    w = world["w"]
    got = tb.beam_primary_frame_cast(w.table, world["aug_t"], w.root,
                                     w.height, op, torch.from_numpy(d), K=K)
    want = jb.beam_primary_frame_cast(world["table_j"],
                                      jnp.asarray(world["aug"]),
                                      np.int32(dev.root), dev.height, op,
                                      jnp.asarray(d), K=K,
                                      bands=H // 8)
    ref = ttr.svo_raycast(w.table, w.root, w.height, torch.from_numpy(op),
                          torch.from_numpy(d))
    return got, want, ref


@pytest.mark.parametrize("pos,yaw,pitch,K", [
    ((16.1234567, 16.0721311, -10.0412399), 0.0137, 0.0213, 64),
    ((-5.0, 40.0, -5.0), 0.7, 0.5, 64),
    ((16.5, 16.5, 16.5), 0.3, -0.2, 64),
    ((16.1234567, 16.0721311, -10.0412399), 0.0137, 0.0213, 8),
])
def test_frame_cast_equals_jax_and_svo_cast(clutter, pos, yaw, pitch, K):
    got, want, ref = _frame_pair(clutter, pos, yaw, pitch, K=K)
    for k in KEYS:
        assert _bits_equal(got[k].numpy(), want[k]), k
    hb, hr = got["hit"], ref["hit"]
    assert torch.equal(hb, hr) and hb.any()
    assert torch.equal(got["t"][hb], ref["t"][hb])
    assert torch.equal(got["normal"], ref["normal"])
    assert torch.equal(got["voxel"][hb], ref["voxel"][hb])
    w = clutter["w"]
    assert torch.equal(got["rgb"][hb], ttr.leaf_rgb(w.table, ref["node"])[hb])
    assert tb.last_frame_stats["tiles"] == 40


def test_frame_cast_solid_floor_and_terrain():
    n = 16
    solid = np.ones((n, n, n), bool)
    rgb = np.full((n, n, n, 3), 0.5, np.float32)
    full = _world(from_dense(solid, rgb).serialize())
    got, want, _ = _frame_pair(full, (8.31721, 8.30533, 8.29917), 0.1, 0.1)
    for k in KEYS:
        assert _bits_equal(got[k].numpy(), want[k]), k
    space = jgen.generate(log2_size=6, verbose=False, backend="python")
    terr = _world(space.serialize())
    s = 64 / 8192
    pos = tuple(np.asarray(jcam.DEFAULT_POSE.pos) * s)
    got, want, ref = _frame_pair(terr, pos, jcam.DEFAULT_POSE.yaw,
                                 jcam.DEFAULT_POSE.pitch, W=96, H=56)
    for k in KEYS:
        assert _bits_equal(got[k].numpy(), want[k]), k
    assert torch.equal(got["hit"], ref["hit"])


def test_shadow_frame_equals_jax_and_per_ray(clutter):
    dev, w = clutter["dev"], clutter["w"]
    pos = (16.1234567, 40.0721311, -10.0412399)
    d = _dirs(pos, 0.0137, 0.4213, 64, 40)
    sun = np.float32([0.3, 0.9, 0.2])
    sun /= np.linalg.norm(sun)
    op = np.asarray(pos, np.float32)
    got = tb.beam_shadow_frame(w.table, clutter["aug_t"], w.root, w.height,
                               op, torch.from_numpy(d), torch.from_numpy(sun))
    want = jb.beam_shadow_frame(clutter["table_j"], jnp.asarray(clutter["aug"]),
                                np.int32(dev.root), dev.height, op,
                                jnp.asarray(d), jnp.asarray(sun))
    assert _bits_equal(got.numpy(), want)
    per_ray = tshade.svo_shadow_frame(w.table, w.root, w.height,
                                      torch.from_numpy(op), torch.from_numpy(d),
                                      torch.from_numpy(sun))
    frac = (~np.isclose(got.numpy(), per_ray.numpy(), atol=1e-4)).mean()
    assert frac < 1e-3
    shaded = tb.beam_primary_frame(w.table, clutter["aug_t"], w.root,
                                   w.height, op, torch.from_numpy(d),
                                   torch.from_numpy(sun))
    assert _bits_equal(shaded.numpy(), jb.beam_primary_frame(
        clutter["table_j"], jnp.asarray(clutter["aug"]), np.int32(dev.root),
        dev.height, op, jnp.asarray(d), jnp.asarray(sun)))
    assert torch.equal(shaded, tshade.svo_primary_frame(
        w.table, w.root, w.height, torch.from_numpy(op), torch.from_numpy(d),
        torch.from_numpy(sun)))


def test_render_sample_beam_primaries(clutter):
    dev, w = clutter["dev"], clutter["w"]
    lut = build_wl_to_rgb_lut(256)
    cam = jcam.Camera(pos=(16.1234567, 40.0721311, -10.0412399), yaw=0.0137,
                      pitch=0.4213)
    sun = np.float32([0.3, 0.9, 0.2])
    sun /= np.linalg.norm(sun)
    seeds = np.array([[5, 6, 7], [8, 9, 10]], np.uint32)
    W, H, kw = 48, 32, dict(max_bounces=3, fog_steps=8)
    tc = tcam.Camera(pos=cam.pos, yaw=cam.yaw, pitch=cam.pitch)
    base = (w.table, w.root, w.height, torch.from_numpy(lut),
            np.asarray(cam.pos, np.float32), tc.basis(),
            torch.from_numpy(sun))
    got = tint.render_samples(*base, seeds, W, H, **kw, aug=clutter["aug_t"])
    one = tint.render_sample(*base, seeds[0], W, H, **kw,
                             aug=clutter["aug_t"])
    two = tint.render_sample(*base, seeds[1], W, H, **kw,
                             aug=clutter["aug_t"])
    assert torch.equal(got, one + two)
    per_ray = tint.render_sample(*base, seeds[0], W, H, **kw)
    assert (one != per_ray).any(-1).float().mean() <= 2 / 4096
    want = np.asarray(jint.render_sample(
        clutter["table_j"], np.int32(dev.root), dev.height, jnp.asarray(lut),
        np.asarray(cam.pos, np.float32), cam.basis(), jnp.asarray(sun),
        jnp.asarray(seeds[0]), W, H, **kw,
        aug=jnp.asarray(clutter["aug"])))
    img = one.numpy()
    assert np.isfinite(img).all()
    assert (np.abs(img - want) > 1e-3).mean() <= FRAC
    assert abs(img.mean() / want.mean() - 1.0) <= MEAN_REL
    with pytest.raises(ValueError):
        tint.render_sample(*base, seeds[0], 44, 32, **kw,
                           aug=clutter["aug_t"])


def test_cli_render_engine_beam(tmp_path, monkeypatch, capsys):
    """``render --engine beam``: the beam engine renders 8-aligned frames
    (shaded and shadow; the same image as the per-ray engine at this
    pose), other sizes fall back to the per-ray cast, as in the JAX CLI;
    the line names the engine. On the CPU through the CLI's device hook."""
    from voxtracer_torch.app import cli

    monkeypatch.setattr(cli, "_device", lambda: "cpu")
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    common = ["--log2-size", "5", "--noise-device", "cpu"]
    imgs = {}
    for engine, (w, h) in (("beam", (48, 32)), ("ray", (48, 32)),
                           ("beam", (44, 32))):
        for mode in ("shaded", "shadow"):
            out = tmp_path / f"{engine}-{w}-{mode}.png"
            cli.main(["render", "--mode", mode, "--engine", engine,
                      "--width", str(w), "--height", str(h), "--out",
                      str(out), *common])
            line = [x for x in capsys.readouterr().out.splitlines()
                    if "engine: frame in" in x][0]
            want = "beam" if engine == "beam" and w % 8 == 0 else "ray"
            assert line.startswith(f"{want} engine"), line
            from PIL import Image

            imgs[(engine, w, mode)] = np.asarray(Image.open(out))
    for mode in ("shaded", "shadow"):
        a, b = imgs[("beam", 48, mode)], imgs[("ray", 48, mode)]
        assert a.shape == (32, 48, 3) and a.mean() > 0
        assert (a != b).any(-1).mean() <= 1e-3
