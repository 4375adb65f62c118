"""Port vs JAX: the per-pose horizon envelope (voxtracer_torch/kernels/
skyline.py: the pyramid, its patch, the device build and the plain
version of kernel K5, against voxtracer/kernels/skyline.py) and the
resumed heightfield frame, on 64^3 worlds.

Tolerances. Soundness (the port's table resuming the port's walk) and
the resumed frames: bit for bit, since a resume in certified air changes
no output bit. The pyramid and its patch: bit for bit (ceil and max are
exact). The port's table against JAX's host and device builds: the
closeness measure of tests/test_skyline_env.py:178-207 at that test's
origin. The two float32 builds round atan2, hypot and log2 on different
libraries, so a cell whose azimuth lies on a bin boundary can land its
centre one bin over in one of them: the one-bin pad then moves to the
cell's other side, and the port's table may lie below the host's in that
pad bin (seen at 1 entry of 262,144 at another origin; sound either way,
as the soundness cases check). The lookup against JAX's on the same
table: a rung count may differ where the slope or the bin rounds across
a boundary, in at most 2 lanes of 4096 (the graze share of the engine
tests); every other lane's t_min within 1e-6 relative (JAX takes log2 g
at run time, the port once on the host, one ulp apart).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.kernels import heightfield as jhf
from voxtracer.kernels import skyline as jsky
from voxtracer.world import worldgen as jgen
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import heightfield as thf
from voxtracer_torch.kernels import skyline as tsky

torch.set_num_threads(2)
LOG2 = 6
N = 1 << LOG2


@pytest.fixture(scope="module")
def world():
    space = jgen.generate(log2_size=LOG2, verbose=False, backend="python")
    heights = np.asarray(space.heights)
    return dict(heights=heights,
                tpack=thf.build_height_mips(heights, device="cpu"),
                jpack=jhf.build_height_mips(heights))


def _rand_dirs(rng, n):
    """tests/test_skyline_env.py's set: half of it in the horizon band."""
    d = rng.standard_normal((n, 3))
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    d[: n // 2, 1] = rng.uniform(-0.15, 0.3, n // 2)
    d[: n // 2] /= np.linalg.norm(d[: n // 2], axis=-1, keepdims=True)
    return d.astype(np.float32)


def _port_env(pack, origin, **kw):
    return tsky.build_skyline_env_device(tsky.sky_levels_from_hf(*pack),
                                         origin, **kw)


def _assert_sound(pack, origin, dirs):
    """The port's table resumes the port's walk to the same bits; an
    all-miss certificate is a real miss. Returns the certified share."""
    env = _port_env(pack, origin)
    d = torch.from_numpy(dirs)
    tm = tsky.skyline_env_tmin(env["E"], d, env["d0"], env["g"], env["K"])
    o = torch.tensor(origin, dtype=torch.float32)
    a = thf.hf_raycast(*pack, o, d)
    b = thf.hf_raycast(*pack, o, d, t_min=tm, init_desc=3)
    for k in a:
        assert torch.equal(a[k], b[k]), (k, origin)
    assert not ((tm >= 1e37) & a["hit"]).any()
    return float((tm > 0).float().mean())


@pytest.mark.parametrize("x,above,frac,z,useful", [
    (0.6, 9.0, 1.0, 0.3, 0.3), (0.22, 0.0, 0.7, 0.81, 0.05),
    (-0.4, 20.0, 1.0, 1.5, None), (3.0, 0.0, 0.5, -2.0, None)])
def test_sound_and_useful_on_terrain(world, x, above, frac, z, useful):
    """tests/test_skyline_env.py:66-80 on the port: above the peaks, in
    a valley and far outside the grid (y = frac * the highest peak +
    above)."""
    hi = float(world["heights"].max())
    o = (x * N, hi * frac + above, z * N)
    share = _assert_sound(world["tpack"], o, _rand_dirs(
        np.random.default_rng(21), 4096))
    if useful is not None:
        assert share > useful


def _fields():
    spike = np.zeros((N, N), np.float32)
    spike[17, 23] = N - 1
    spike[48, 9] = N / 2 + 0.49  # a fractional column: its top is ceil(h)
    wall = np.zeros((N, N), np.float32)
    wall[:, 31] = N - 2
    return dict(spike=spike, wall=wall)


@pytest.mark.parametrize("field", ["spike", "wall"])
@pytest.mark.parametrize("origin", [
    (0.4 * N, N + 3.0, 0.52 * N), (0.9 * N, N * 0.6, 0.1 * N),
    (23.5, float(N - 1) + 0.2, 17.5), (9.6, N / 2 + 0.6, 48.2),
    (31.6, 1.5, 30.2), (17.5, 3.0, 23.5)])
def test_sound_adversarial_fields(field, origin):
    """tests/test_skyline_env.py:131-175's fields and origins: a spike,
    a wall, the .49 column, origins beside and just above them."""
    pack = thf.build_height_mips(_fields()[field], device="cpu")
    _assert_sound(pack, origin, _rand_dirs(np.random.default_rng(9), 2048))


def _close(Eh, Ed):
    """tests/test_skyline_env.py:178-207's measure of table Ed against
    table Eh."""
    Eh = np.asarray(Eh, np.float64)
    Ed = np.asarray(Ed, np.float64)
    fin = (Eh > -1e38) & (Ed > -1e38) & np.isfinite(Eh) & np.isfinite(Ed)
    assert ((Eh > -1e38) == (Ed > -1e38)).mean() > 0.999
    scale = np.maximum(np.abs(Eh[fin]), 1e-3)
    rel = np.abs(Ed[fin] - Eh[fin]) / scale
    assert (rel < 1e-3).mean() > 0.9
    assert (Ed[fin] >= Eh[fin] - 1e-3 * scale).all()


def test_device_build_close_to_jax(world):
    """The port's table against JAX's host build (f64) and JAX's device
    build, at tests/test_skyline_env.py's origin; the same ladder."""
    heights = world["heights"]
    origin = (0.37 * N, float(heights.max()) * 0.8, 0.61 * N)
    port = _port_env(world["tpack"], origin)
    host = jsky.build_skyline_env(jsky.build_sky_mips(heights), origin)
    jdev = jsky.build_skyline_env_device(
        jsky.sky_levels_from_hf(*world["jpack"]), origin)
    assert port["E"].shape == (4096, 64) and port["E"].dtype == torch.float32
    assert port["g"] == pytest.approx(host["g"], rel=1e-12)
    _close(host["E"], port["E"].numpy())
    _close(np.asarray(jdev["E"]), port["E"].numpy())


def test_tmin_lookup_matches_jax(world):
    """skyline_env_tmin_plain against JAX's skyline_env_tmin on one table
    (the port's): rung counts and t_min (module doc), on the random set
    and on pixel-centre camera rays."""
    heights = world["heights"]
    origin = (0.55 * N, float(heights.max()) + 4.0, 0.4 * N)
    for kw in (dict(), dict(bins=8192, K=256, ratio=32)):
        env = _port_env(world["tpack"], origin, **kw)
        cam = tcam.Camera(pos=origin, yaw=2.2, pitch=0.15)
        _, cd = tcam.generate_rays(cam, 64, 64)
        d = np.concatenate([_rand_dirs(np.random.default_rng(3), 4096),
                            cd.reshape(-1, 3).numpy()])
        got = tsky.skyline_env_tmin(env["E"], torch.from_numpy(d), env["d0"],
                                    env["g"], env["K"]).numpy()
        want = np.asarray(jsky.skyline_env_tmin(
            jnp.asarray(env["E"].numpy()), jnp.asarray(d), env["d0"],
            env["g"], env["K"]))
        rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
        off = rel > 1e-6
        assert int(off.sum()) <= 2 * len(d) // 4096, int(off.sum())
        assert (got > 0).mean() > 0.3  # the lookup certifies something
        assert ((got >= 1e37) == (want >= 1e37))[~off].all()


def _two_level(E, S, cb, tan_adj):
    """The rungs of row ``cb`` below ``tan_adj`` from the summary S (the
    blocks of 16 rungs wholly below) and the one block of E that holds
    the bound, as K5 finds them; returns (k*, block), block ==
    ceil(K / 16) where every rung lies below."""
    K = E.shape[1]
    nblk = S.shape[1]
    blk = (S[cb] < tan_adj[:, None]).sum(dim=1)
    k = (torch.clamp(blk, max=nblk - 1) * 16)[:, None] + torch.arange(16)
    inside = (k < K) & (blk < nblk)[:, None]
    vals = E[cb[:, None], torch.clamp(k, max=K - 1)]
    cnt = ((vals < tan_adj[:, None]) & inside).sum(dim=1)
    return torch.where(blk < nblk, blk * 16 + cnt, K), blk


@pytest.mark.parametrize("kw", [dict(), dict(bins=8192, K=256, ratio=32),
                                dict(bins=8192, K=512, ratio=128),
                                dict(bins=2048, K=100, ratio=16)])
def test_two_level_count_equals_full_count(world, kw):
    """K5's two-level search in PyTorch (_two_level: the summary's blocks
    below the slope, then one block of E) gives the full count's rung in
    every lane, on the default table, the Renderer's two table shapes and
    a K that is no multiple of 16; the summary is E's last rung of each
    block of 16; E still matches JAX's device build."""
    heights = world["heights"]
    origin = (0.55 * N, float(heights.max()) + 4.0, 0.4 * N)
    env = _port_env(world["tpack"], origin, **kw)
    E, S = env["E"], env["S"]
    bins, K = E.shape
    nblk = -(-K // 16)
    assert S.shape == (bins, nblk)
    last = [min(16 * j + 15, K - 1) for j in range(nblk)]
    assert torch.equal(S, E[:, last])
    cam = tcam.Camera(pos=origin, yaw=2.2, pitch=0.15)
    _, cd = tcam.generate_rays(cam, 64, 64)
    d = torch.from_numpy(np.concatenate(
        [_rand_dirs(np.random.default_rng(4), 4096),
         cd.reshape(-1, 3).numpy()]))
    bin_w = tsky._consts(bins, env["d0"], env["g"])[0]
    cb, _, tan_adj = tsky.lane_slopes(d, bin_w, bins)
    full = (E[cb] < tan_adj[:, None]).sum(dim=1)
    ks, blk = _two_level(E, S, cb, tan_adj)
    assert torch.equal(ks, full)
    assert (full == 0).any() and ((full > 0) & (full < K)).any()
    assert ((blk < nblk) == (full < K)).all()
    jdev = jsky.build_skyline_env_device(
        jsky.sky_levels_from_hf(*world["jpack"]), origin, **kw)
    _close(np.asarray(jdev["E"]), E.numpy())


def test_patch_sky_levels_matches_rebuild(world):
    """tests/test_skyline_env.py:210-235: the patched pyramid equals the
    port's rebuild and JAX's patch, bit for bit; above 16 columns it
    rebuilds. Then an edit that raises the world's maximum: the port's
    patch still equals its rebuild. (JAX's patch pads its columns to 16
    with cell (0, 0), whose stale value overwrites the coarsest levels'
    new maximum there: ROADMAP.md section C.)"""
    heights = world["heights"]
    tiles, offs, h = thf.build_height_mips(heights, device="cpu")
    flat, joffs, _ = jhf.build_height_mips(heights)
    pack = tsky.sky_levels_from_hf(tiles, offs, h)
    jpack = jsky.sky_levels_from_hf(flat, joffs, h)
    h2 = np.array(heights).astype(np.int64)
    cols = [(5, 9), (41, 33), (41, 34), (63, 0)]
    for i, (x, z) in enumerate(cols):
        h2[x, z] = max(int(h2[x, z]) + (3 if i % 2 == 0 else -1), 0)
    many = [(i, i) for i in range(20)]
    for batch in (cols, many):
        thf.patch_height_mips(tiles, offs, h, h2, batch)
        flat = jhf.patch_height_mips(flat, joffs, h, h2, batch)
        pack = tsky.patch_sky_levels(pack, tiles, batch)
        jpack = jsky.patch_sky_levels(jpack, flat, batch)
        full = tsky.sky_levels_from_hf(tiles, offs, h)
        assert len(pack["coarse"]) == len(full["coarse"])
        for a, b, c in zip(pack["coarse"], full["coarse"], jpack["coarse"]):
            assert torch.equal(a, b)
            assert np.array_equal(a.numpy(), np.asarray(c))
    h2[40, 40] = N - 4  # above every other column
    thf.patch_height_mips(tiles, offs, h, h2, [(40, 40)])
    pack = tsky.patch_sky_levels(pack, tiles, [(40, 40)])
    full = tsky.sky_levels_from_hf(tiles, offs, h)
    for a, b in zip(pack["coarse"], full["coarse"]):
        assert torch.equal(a, b)
    assert float(pack["coarse"][-1].max()) == N - 4


def _frame_keys(a, b, keys=("hit", "t", "normal", "node", "rgb", "voxel")):
    for k in keys:
        x = a[k].numpy() if isinstance(a[k], torch.Tensor) else np.asarray(a[k])
        y = b[k].numpy() if isinstance(b[k], torch.Tensor) else np.asarray(b[k])
        assert np.array_equal(x.view(np.uint8), y.view(np.uint8)), k


@pytest.mark.parametrize("pose", [0, 1])
def test_env_frame_bit_identical(world, pose):
    """tests/test_skyline_env.py:238-270's poses: hf_frame_cast with the
    port's envelope equals the un-resumed frame, and JAX's frame resumed
    by its own envelope, by bits, for pixel-centre rays and for jittered
    rays. Both packages cast the port's directions: JAX's own pixel-centre
    grid differs from the port's in the last bit in some pixels (its
    camera product rounds differently), and those rays' t with it."""
    heights = world["heights"]
    hi = float(heights.max())
    pos, yaw, pitch = ((0.62 * N, hi + 5.0, 0.35 * N), 2.2, 0.2) if pose == 0 \
        else ((0.5 * N, hi * 0.8, 0.5 * N), -0.7, 0.05)
    cam = tcam.Camera(pos=pos, yaw=yaw, pitch=pitch)
    jc = jcam.Camera(pos=pos, yaw=yaw, pitch=pitch)
    op = np.asarray(pos, np.float32)
    W, H = 48, 32
    trgb = (0.3, 0.62, 0.24)
    env = _port_env(world["tpack"], op)
    targs = (env["E"], env["d0"], env["g"], env["K"])
    jenv = jsky.build_skyline_env(jsky.build_sky_mips(heights), op)
    jargs = (jnp.asarray(jenv["E"]), jenv["d0"], jenv["g"], jenv["K"])
    tp, jp = world["tpack"], world["jpack"]

    py, px = tcam.pixel_grid(W, H)
    ndc = tcam.pixel_ndc(px, py, W, H)
    jit = np.random.default_rng(5).uniform(0, 1, (H, W, 2)).astype(np.float32)
    centre = tcam.ray_directions(cam.basis(), ndc)
    jittered = tcam.ray_directions(cam.basis(), ndc,
                                   jitter=torch.from_numpy(jit), height=H)
    a = thf.hf_frame_cast(*tp, op, cam.basis(), W, H, trgb)
    assert torch.equal(a["t"], thf.hf_frame_cast(
        *tp, op, cam.basis(), W, H, trgb, ray_dirs=centre)["t"])
    for d in (centre, jittered):
        a = thf.hf_frame_cast(*tp, op, cam.basis(), W, H, trgb, ray_dirs=d)
        b = thf.hf_frame_cast(*tp, op, cam.basis(), W, H, trgb, ray_dirs=d,
                              sky_env=targs)
        _frame_keys(a, b)
        c = jhf.hf_frame_cast(*jp, op, jc.basis(), W, H, trgb,
                              ray_dirs=jnp.asarray(d.numpy()), sky_env=jargs)
        _frame_keys(b, c)
    assert bool(a["hit"].any()) and not bool(a["hit"].all())
