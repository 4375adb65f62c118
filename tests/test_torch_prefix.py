"""Port vs JAX: the certified-air prefixes of the frame cast, the cone
march (voxtracer_torch/kernels/conemarch.py against
voxtracer/kernels/conemarch.py) and the tile skyline (the host half of
voxtracer_torch/kernels/skyline.py against voxtracer/kernels/skyline.py),
and ``hf_frame_cast(cone=, sky=, sky_env=)``, on 64^3 terrain.

Tolerances. Host numpy in both packages on the same inputs, equal by
bits: the cone pyramid, ``build_sky_mips``, ``build_skyline``,
``tile_sky``, ``rays_sky`` and the host ``build_skyline_env``. The cone
march is float32 arithmetic that XLA's CPU backend contracts into FMAs
where the host has them (``o + s * dc``, the crossing
``(c * cell - o) * inv``, the fit test); the port rounds every operation
as written, and one rounding at a cell boundary changes every later step
of that bundle's march. So JAX's S is computed in a child process with
the contraction off (``XLA_FLAGS=--xla_cpu_max_isa=SSE4_2``: no FMA
instructions, each operation rounded as JAX wrote it), and the port's S
must equal it by bits on every bundle. Every S the port certifies is also
attacked by brute force: sampled directions of the bundle box must stay
in air on [0, S] (tests/test_conemarch.py's fuzz).
The bundles (``frame_tile_bundles``) bound every pixel's and jittered
ray's direction (the oracle's test). Frames: every prefix and composition
equal by bits to the unprefixed cast, and to JAX's prefixed frame on one
set of directions.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.kernels import conemarch as jcone
from voxtracer.kernels import heightfield as jhf
from voxtracer.kernels import skyline as jsky
from voxtracer.world import worldgen as jgen
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import conemarch as tcone
from voxtracer_torch.kernels import heightfield as thf
from voxtracer_torch.kernels import skyline as tsky

torch.set_num_threads(2)
REPO = Path(__file__).resolve().parents[1]
LOG2 = 6
N = 1 << LOG2
TRGB = (0.3, 0.62, 0.24)


@pytest.fixture(scope="module")
def world():
    space = jgen.generate(log2_size=LOG2, verbose=False, backend="python")
    heights = np.asarray(space.heights)
    return dict(heights=heights,
                tpack=thf.build_height_mips(heights, device="cpu"),
                jpack=jhf.build_height_mips(heights),
                cone=tcone.build_cone_mips(heights, device="cpu"),
                jcone=jcone.build_cone_mips(heights),
                sky_mips=tsky.build_sky_mips(heights))


def _poses(heights, mod):
    hm = float(heights.max())
    return (mod.Camera(pos=(0.62 * N, hm + 5.0, 0.35 * N), yaw=2.2,
                       pitch=-0.3),
            mod.Camera(pos=(0.62 * N, hm + 5.0, 0.35 * N), yaw=2.2,
                       pitch=0.2),
            mod.Camera(pos=(0.5 * N, hm * 0.8, 0.5 * N), yaw=-0.7,
                       pitch=0.05))


def test_host_structures_equal_jax(world):
    h = world["heights"]
    flat, offs, lo = world["cone"]
    jflat, joffs, jlo = world["jcone"]
    assert np.array_equal(flat.numpy(), np.asarray(jflat))
    assert (offs, lo) == (joffs, jlo)
    jm = jsky.build_sky_mips(h)
    assert all(np.array_equal(a, b) for a, b in zip(world["sky_mips"], jm))
    rng = np.random.default_rng(4)
    d = rng.standard_normal((2048, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    for pose in _poses(h, jcam):
        op = np.asarray(pose.pos, np.float32)
        a = tsky.build_skyline(world["sky_mips"], op)
        b = jsky.build_skyline(jm, op)
        for k in ("B", "B_dil", "B_max"):
            assert np.array_equal(a[k], b[k]), k
        basis = np.asarray(pose.basis(), np.float32)
        assert np.array_equal(tsky.tile_sky(a, basis, 52, 36),
                              jsky.tile_sky(b, basis, 52, 36))
        assert np.array_equal(tsky.rays_sky(a, d), jsky.rays_sky(b, d))
        ea = tsky.build_skyline_env(world["sky_mips"], op, bins=512, K=32)
        eb = jsky.build_skyline_env(jm, op, bins=512, K=32)
        assert np.array_equal(ea["E"], eb["E"])
        assert (ea["d0"], ea["g"]) == (eb["d0"], eb["g"])


def test_bundles_bound_pixel_dirs_and_equal_jax():
    W, H = 52, 36
    cam = tcam.Camera(pos=(3.0, 9.0, 4.0), yaw=0.9, pitch=-0.4)
    basis = cam.basis().numpy()
    dc, sig, nmin = (x.numpy() for x in
                     tcone.frame_tile_bundles(basis, W, H, device="cpu"))
    jdc, jsig, jnmin = (np.asarray(x) for x in
                        jcone.frame_tile_bundles(basis, W, H))
    assert np.array_equal(nmin, jnmin)
    assert np.allclose(dc, jdc, rtol=0, atol=2e-7)
    assert np.allclose(sig, jsig, rtol=0, atol=2e-7)
    rng = np.random.default_rng(8)
    tx = -(-W // 8)
    for _ in range(400):
        x, y = rng.integers(0, W), rng.integers(0, H)
        jx, jy = rng.uniform(-0.5, 0.5, 2)
        lx = (2.0 * (x + 0.5 + jx) - W) / H
        ly = (2.0 * (y + 0.5 + jy) - H) / H
        du = np.array([lx, -ly, 1.0], np.float32) @ basis.T
        t = (y // 8) * tx + (x // 8)
        assert (np.abs(du - dc[t]) <= sig[t] + 1e-6).all(), (x, y)
        assert np.linalg.norm(du) >= nmin[t] - 1e-6


def _rand_bundles(rng, n, spread):
    dc = rng.standard_normal((n, 3)).astype(np.float32)
    dc /= np.linalg.norm(dc, axis=-1, keepdims=True)
    sig = rng.uniform(0.0, spread, (n, 3)).astype(np.float32)
    return dc, sig


SPREADS = (0.002, 0.02)
ORIGINS = ((0.4 * N, N + 3.0, 0.52 * N), (0.9 * N, N * 0.6, 0.1 * N))

# JAX's cone_prefix over every (spread, origin) case of the test, in a
# process whose XLA emits no FMA: argv[1] the inputs (.npz), argv[2] out
_JAX_CONE_CHILD = """
import sys
import numpy as np
import jax.numpy as jnp
from voxtracer.kernels import conemarch
a = np.load(sys.argv[1])
flat, offs, lo = conemarch.build_cone_mips(a["heights"])
out = {}
for k in range(int(a["n"])):
    out[f"S{k}"] = np.asarray(conemarch.cone_prefix(
        flat, offs, lo, int(a["log2"]), jnp.asarray(a[f"o{k}"]),
        jnp.asarray(a[f"dc{k}"]), jnp.asarray(a[f"sig{k}"])))
np.savez(sys.argv[2], **out)
"""


def _cone_cases():
    """(spread, origin, dc, sig) of each case, from the spread's seed."""
    cases = []
    for spread in SPREADS:
        rng = np.random.default_rng(int(spread * 1000))
        dc, sig = _rand_bundles(rng, 384, spread)
        cases += [(spread, o, dc, sig) for o in ORIGINS]
    return cases


@pytest.fixture(scope="module")
def jax_cone_s(world, tmp_path_factory):
    """JAX's S for each case, with XLA's FMA contraction off."""
    tmp = tmp_path_factory.mktemp("cone")
    cases = _cone_cases()
    arrays = dict(heights=world["heights"], log2=LOG2, n=len(cases))
    for k, (_, o, dc, sig) in enumerate(cases):
        arrays.update({f"o{k}": np.asarray(o, np.float32), f"dc{k}": dc,
                       f"sig{k}": sig})
    np.savez(tmp / "in.npz", **arrays)
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS=(os.environ.get("XLA_FLAGS", "")
                          + " --xla_cpu_max_isa=SSE4_2").strip())
    res = subprocess.run([sys.executable, "-c", _JAX_CONE_CHILD,
                          str(tmp / "in.npz"), str(tmp / "out.npz")],
                         cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-2000:]
    out = np.load(tmp / "out.npz")
    return {(spread, o): out[f"S{k}"]
            for k, (spread, o, _, _) in enumerate(cases)}


@pytest.mark.parametrize("spread", SPREADS)
def test_cone_prefix_near_jax_and_sound(world, jax_cone_s, spread):
    flat, offs, lo = world["cone"]
    rng = np.random.default_rng(int(spread * 1000))
    dc, sig = _rand_bundles(rng, 384, spread)
    certified = 0
    for origin in ORIGINS:
        S = tcone.cone_prefix(flat, offs, lo, LOG2, origin,
                              torch.from_numpy(dc), torch.from_numpy(sig))
        S = S.numpy()
        want = jax_cone_s[(spread, origin)]
        assert np.array_equal(S, want), \
            f"{int((S != want).sum())} of {S.size} bundles differ from JAX"
        certified += int((S > 0).sum())
        # brute force: corners and interior points of each bundle's box
        u = rng.uniform(-1.0, 1.0, (16, dc.shape[0], 3)).astype(np.float32)
        u[:8] = np.array([[x, y, z] for x in (-1, 1) for y in (-1, 1)
                          for z in (-1, 1)], np.float32)[:, None, :]
        ds = (dc[None] + u * sig[None]).reshape(-1, 3)
        r = thf.hf_raycast(*world["tpack"], torch.tensor(origin),
                           torch.from_numpy(ds))
        hit = r["hit"].numpy().reshape(16, -1)
        t = r["t"].numpy().reshape(16, -1)
        bad = hit & (t <= S[None]) & (S[None] > 0)
        assert not bad.any(), f"{int(bad.sum())} sampled rays violate S"
    assert certified > 0


def _frames(world, pose, W, H, d=None, **kw):
    op = np.asarray(pose.pos, np.float32)
    return thf.hf_frame_cast(*world["tpack"], op, pose.basis(), W, H, TRGB,
                             ray_dirs=d, **kw)


def test_prefixed_frames_bit_identical_and_equal_jax(world):
    W, H = 48, 32
    rng = np.random.default_rng(3)
    tposes = _poses(world["heights"], tcam)
    jposes = _poses(world["heights"], jcam)
    for pose, jpose in zip(tposes, jposes):
        op = np.asarray(pose.pos, np.float32)
        sky = tsky.build_skyline(world["sky_mips"], op)
        env = tsky.build_skyline_env_device(
            tsky.sky_levels_from_hf(world["tpack"][0], world["tpack"][1],
                                    LOG2), op, bins=1024, K=64, ratio=16)
        env_t = (env["E"], env["d0"], env["g"], env["K"])
        jit = torch.from_numpy(rng.uniform(0, 1, (H, W, 2))
                               .astype(np.float32))
        py, px = tcam.pixel_grid(W, H)
        ld = tcam.pixel_ndc(px, py, W, H)
        for d in (None, tcam.ray_directions(pose.basis(), ld, jitter=jit,
                                            height=H)):
            a = _frames(world, pose, W, H, d)
            for kw in (dict(cone=world["cone"]), dict(sky=sky),
                       dict(sky=sky, cone=world["cone"]),
                       dict(sky=sky, cone=world["cone"], sky_env=env_t),
                       dict(cone=world["cone"], sky_env=env_t)):
                b = _frames(world, pose, W, H, d, **kw)
                for k in a:
                    assert torch.equal(a[k], b[k]), (k, sorted(kw))
        # against JAX's prefixed frame, one set of directions
        d = tcam.generate_rays(pose, W, H)[1]
        jsky_ = jsky.build_skyline(jsky.build_sky_mips(world["heights"]), op)
        flat, offs, h = world["jpack"]
        want = jhf.hf_frame_cast(flat, offs, h, op, jpose.basis(), W, H,
                                 terrain_rgb=TRGB, ray_dirs=jnp.asarray(
                                     d.numpy()), cone=world["jcone"],
                                 sky=jsky_)
        got = _frames(world, pose, W, H, d, cone=world["cone"], sky=sky)
        for k in ("hit", "t", "normal", "rgb", "voxel"):
            assert np.array_equal(np.asarray(want[k]), got[k].numpy()), k
