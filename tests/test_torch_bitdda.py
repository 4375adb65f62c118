"""Port vs JAX: the bit-grid pyramid (voxtracer_torch/world/bitgrid.py)
and the bit-grid DDA (voxtracer_torch/kernels/bitdda.py: the plain
version of kernel K8 and ``svo_color_at``) against voxtracer/world/
bitgrid.py and voxtracer/kernels/bitdda.py, on the worlds of
tests/test_bitdda.py (a 64^3 random fill padded to one 128^3 region, and
terrain).

Tolerances. The pyramid and its edits: equal by bits. The DDA against
JAX's on the same rays: hit, normal and voxel equal, and t equal by bits,
on all but a graze budget of 2 lanes in 4096 (tests/test_heightfield.py's
edge-graze share): XLA fuses the crossing point ``o + dm * t`` into one
FMA where the port rounds twice, so a crossing within an ulp of a cell
plane may land in the neighbouring cell. Against the port's SVO cast
(K2's plain version), on the oracle's rays (generic starts, no cap: the
DDA's cap is strict where the SVO walk's is advisory) and tolerances
(tests/test_bitdda.py): hit, voxel and normal equal, t at rtol 1e-5 /
atol 2e-4. ``svo_color_at``:
equal by bits to JAX's. The path tracer on the bit grid against JAX's:
the path-sample budget of tests/test_torch_integrator.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core.spectra import build_wl_to_rgb_lut
from voxtracer.kernels import bitdda as jdda
from voxtracer.kernels import integrator as jint
from voxtracer.world import bitgrid as jbg
from voxtracer.world import worldgen as jgen
from voxtracer.world.svo import from_dense
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import bitdda as tdda
from voxtracer_torch.kernels import integrator as tint
from voxtracer_torch.kernels import traverse as ttr
from voxtracer_torch.world import bitgrid as tbg
from voxtracer_torch.world import svo as tsvo

torch.set_num_threads(2)
GRAZE = 2 / 4096
FRAC, MEAN_REL = 5e-3, 1e-3  # tests/test_torch_integrator.py's budget


@pytest.fixture(scope="module")
def world():
    rng = np.random.default_rng(7)
    n = 64
    solid = rng.random((n, n, n)) < 0.1
    rgb = rng.random((n, n, n, 3)).astype(np.float32)
    rgb[~solid] = 0
    dev = from_dense(solid, rgb).serialize()
    return solid, dev, tbg.from_dense(solid)


def _grid_equal(a, b):
    assert a.size == b.size
    for k in ("top", "regions", "bricks"):
        assert np.array_equal(getattr(a, k), getattr(b, k)), k


def test_pyramid_and_edits_equal_jax(world, rng):
    solid, _, grid = world
    jgrid = jbg.from_dense(solid)
    _grid_equal(grid, jgrid)
    h = rng.integers(0, 200, (256, 256))
    _grid_equal(tbg.from_heightmap(h), jbg.from_heightmap(h))
    for _ in range(40):
        p = rng.integers(0, 64, 3)
        val = bool(rng.random() < 0.5)
        tbg.set_voxel(grid, p, val)
        jbg.set_voxel(jgrid, p, val)
    _grid_equal(grid, jgrid)
    # a brick and a region emptied entirely
    for x in range(8):
        for y in range(8):
            for z in range(8):
                tbg.set_voxel(grid, (x, y, z), False)
                jbg.set_voxel(jgrid, (x, y, z), False)
    _grid_equal(grid, jgrid)


def _rays(rng, B):
    start = rng.random((B, 3)).astype(np.float32) * 160 - 45
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dist = np.where(rng.random(B) < 0.3, rng.random(B) * 90.0,
                    1e12).astype(np.float32)
    return start, d, dist


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint8).reshape(a.shape[0], -1)


@pytest.mark.parametrize("skip_t0", [False, True])
def test_raycast_equals_jax_and_svo(world, rng, skip_t0):
    solid, dev, grid = world
    B = 4096
    start, d, dist = _rays(rng, B)
    start[:512] = np.floor(start[:512])  # corners and faces
    act = rng.random(B) < 0.9
    bw = grid.to_device("cpu")
    got = tdda.bitgrid_raycast(*bw, grid.size, torch.from_numpy(start),
                               torch.from_numpy(d),
                               distance=torch.from_numpy(dist),
                               skip_t0=skip_t0,
                               active=torch.from_numpy(act))
    jb = (jnp.asarray(grid.top), jnp.asarray(grid.regions),
          jnp.asarray(grid.bricks))
    want = jdda.bitgrid_raycast(*jb, grid.size, jnp.asarray(start),
                                jnp.asarray(d), distance=jnp.asarray(dist),
                                skip_t0=skip_t0, active=jnp.asarray(act))
    differ = np.zeros(B, bool)
    for k in ("hit", "t", "normal", "voxel"):
        differ |= (_bits(got[k].numpy()) != _bits(np.asarray(want[k]))).any(1)
    assert differ.mean() <= GRAZE, f"{int(differ.sum())} lanes differ"
    assert not got["hit"][~torch.from_numpy(act)].any()
    assert got["hit"].sum() > B // 16

    # against the SVO cast on the oracle's rays: generic starts, no cap
    # (the DDA's cap is strict, the SVO walk's advisory)
    w = tsvo.upload(dev.table, dev.root, dev.height, "cpu")
    s_t, d_t = torch.from_numpy(start[512:]), torch.from_numpy(d[512:])
    got = tdda.bitgrid_raycast(*bw, grid.size, s_t, d_t, skip_t0=skip_t0)
    rs = ttr.svo_raycast(w.table, w.root, w.height, s_t, d_t,
                         skip_t0=skip_t0)
    both = got["hit"] & rs["hit"]
    assert torch.equal(got["hit"], rs["hit"])
    assert torch.allclose(got["t"][both], rs["t"][both], rtol=1e-5,
                          atol=2e-4)
    assert torch.equal(got["voxel"][both], rs["voxel"][both])
    assert torch.equal(got["normal"][both], rs["normal"][both])
    col = tdda.svo_color_at(w.table, w.root, w.height, got["voxel"],
                            got["hit"])
    jcol = jdda.svo_color_at(jnp.asarray(dev.table.view(np.int32)),
                             np.int32(dev.root), dev.height,
                             jnp.asarray(got["voxel"].numpy()),
                             jnp.asarray(got["hit"].numpy()))
    assert np.array_equal(col.numpy(), np.asarray(jcol))
    assert torch.equal(col[both], ttr.leaf_rgb(w.table, rs["node"])[both])


def test_path_tracer_on_the_bit_grid_equals_jax():
    """tests/test_bitdda.py's integration case through both packages:
    render_sample(bitworld=) on 64^3 terrain (the grid padded to 128)."""
    space = jgen.generate(log2_size=6, verbose=False, backend="python")
    dev = space.serialize()
    grid = tbg.from_heightmap(np.asarray(space.heights))
    w = tsvo.upload(dev.table, dev.root, dev.height, "cpu")
    lut = build_wl_to_rgb_lut(256)
    cam = tcam.Camera(pos=(40.3, 45.2, 18.7), yaw=2.4, pitch=-0.4)
    sun = np.float32([0.3, 0.9, 0.3])
    sun /= np.linalg.norm(sun)
    seed = np.array([11, 22, 33], np.uint32)
    W, H, kw = 48, 32, dict(max_bounces=4, fog_steps=8)
    base = (w.table, w.root, w.height, torch.from_numpy(lut),
            np.asarray(cam.pos, np.float32), cam.basis(),
            torch.from_numpy(sun), seed, W, H)
    got = tint.render_sample(*base, **kw, bitworld=grid.to_device("cpu"),
                             bit_size=grid.size).numpy()
    svo_img = tint.render_sample(*base, **kw).numpy()
    from voxtracer.core import camera as jcam

    jc = jcam.Camera(pos=np.array(cam.pos), yaw=cam.yaw, pitch=cam.pitch)
    want = np.asarray(jint.render_sample(
        jnp.asarray(dev.table.view(np.int32)), np.int32(dev.root), dev.height,
        jnp.asarray(lut), np.asarray(cam.pos, np.float32), jc.basis(),
        jnp.asarray(sun), jnp.asarray(seed), W, H, **kw,
        bitworld=(jnp.asarray(grid.top), jnp.asarray(grid.regions),
                  jnp.asarray(grid.bricks)), bit_size=grid.size))
    for img, ref in ((got, want), (got, svo_img)):
        assert img.shape == ref.shape and np.isfinite(img).all()
        frac = (np.abs(img - ref) > 1e-3).mean()
        assert frac <= FRAC, f"{frac:.4%} of values beyond 1e-3"
        assert abs(img.mean() / ref.mean() - 1.0) <= MEAN_REL


def test_edge_crossing_never_steps_back():
    """A jittered primary of the 1024^3 smoke pose that crosses an edge
    where two crossing t's are equal (t = 1084.383): the reference's walk
    takes the other axis's cell from ``floor(o + dm * t)``, which rounds
    below the cell the ray is in, so it steps back and forth between
    (904, 521, 728) and (903, 521, 729) forever; the port never lets a cell
    index decrease and the walk ends. A 1024^3 grid holding four voxels
    keeps both bricks of the crossing occupied (the walk is at voxel level
    there) without blocking the ray, which misses."""
    n = 1024
    nr, nb = n // 128, n // 8
    grid = tbg.BitGrid(size=n, top=np.zeros((nr ** 3 + 31) // 32, np.uint32),
                       regions=np.zeros((nr ** 3, 128), np.uint32),
                       bricks=np.zeros((nb ** 3, 16), np.uint32))
    for p in ((911, 527, 735), (896, 527, 735), (896, 520, 720),
              (911, 520, 720)):
        tbg.set_voxel(grid, p, True)
    start = torch.tensor([[100.02940368652344, 188.98365783691406,
                           81.80015563964844]], dtype=torch.float32)
    d = torch.tensor([[0.7414082288742065, 0.3067566156387329,
                       0.5968368649482727]], dtype=torch.float32)
    before = tdda.plain_lane_steps
    r = tdda.bitgrid_raycast(*grid.to_device("cpu"), n, start, d)
    assert 0 < tdda.plain_lane_steps - before < 1000
    assert not r["hit"].any()
