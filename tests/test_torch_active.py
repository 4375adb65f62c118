"""Port: the per-pose culled box view (voxtracer_torch/world/active.py and
world/occlusion.py) on the CPU, the counterparts of tests/test_active.py
and tests/test_occlusion.py.

The contract: for any camera inside the validity volume of the last
cull, the rasterized frame of the active subset equals the full soup's in
every output (hit, t, node, normal, voxel). The horizon tables round
atan2 and arcsin on torch's libraries, not XLA's, so they are not held to
the JAX package's by bits: soundness is fuzzed against a brute-force
line-of-sight march, and the kept count is held to JAX's ``_cull`` on the
same inputs within ``N_ACTIVE_BUDGET``."""

import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.world import active as jact
from voxtracer.world import occlusion as jocc
from voxtracer.world import worldgen as jgen
from voxtracer.world.boxes import extract_boxes as jextract
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import heightfield as thf
from voxtracer_torch.kernels import raster as traster
from voxtracer_torch.world import active as tact
from voxtracer_torch.world import boxes as tboxes
from voxtracer_torch.world import occlusion as tocc

torch.set_num_threads(2)
OUT = ("hit", "t", "node", "normal", "voxel")
# boxes whose keep decision may differ from JAX's: a box whose bearing
# lies within float32 rounding of a theta-bin edge, or whose slope or
# frustum test ties within an ulp, can fall the other way on torch's
# atan2/arcsin; a share of the soup, and never a visible box (the frames
# below are exact)
N_ACTIVE_BUDGET = 2e-3


def _frame(rows, cam, height, W, H, **kw):
    r = traster.raster_cast_exact(*rows, np.asarray(cam.pos, np.float32),
                                  cam.basis(), height, W, H, **kw)
    return {k: r[k] for k in OUT}


def _assert_same(a, b, what):
    for k in OUT:
        assert torch.equal(a[k], b[k]), (what, k)


@pytest.fixture(scope="module")
def terrain64():
    space = jgen.generate(log2_size=6, verbose=False, backend="python")
    dev = space.serialize()
    soup = jextract(dev)
    w = dict(dev=dev, soup=soup, table=torch.from_numpy(
        dev.table.view(np.int32).copy()),
        full=traster.soup_to_device(soup.lo, soup.size, soup.leaf, soup.rgb,
                                    "cpu"))
    return w


def _exact64(t):
    return dict(table=t["table"], root=int(t["dev"].root))


def test_active_soup_matches_full(terrain64):
    """Frustum cull: the culled frame equals the full soup's at the build
    pose and at a pose inside the validity volume (no re-cull); a big
    move re-culls."""
    W, H = 96, 56
    h = terrain64["dev"].height
    cam = tcam.Camera(pos=(6.2, 20.1, 5.4), yaw=-5.38, pitch=0.22)
    act = tact.ActiveSoup(terrain64["full"], W, H, margin_deg=12.0,
                          keep_radius=16.0)
    rows = act.active(cam.pos, cam.basis())
    assert not act.overflowed
    assert 0 < act.n_active < len(terrain64["soup"])
    assert rows[0].shape[0] == act.n_active
    kw = _exact64(terrain64)
    _assert_same(_frame(rows, cam, h, W, H, **kw),
                 _frame(terrain64["full"], cam, h, W, H, **kw), "build pose")
    cam2 = tcam.Camera(pos=(7.9, 19.3, 6.0), yaw=-5.30, pitch=0.17)
    pose = act._pose
    rows2 = act.active(cam2.pos, cam2.basis())
    assert act._pose is pose and rows2 is rows
    _assert_same(_frame(rows2, cam2, h, W, H, **kw),
                 _frame(terrain64["full"], cam2, h, W, H, **kw), "moved")
    cam3 = tcam.Camera(pos=(50.0, 30.0, 52.0), yaw=2.0, pitch=0.4)
    act.active(cam3.pos, cam3.basis())
    assert act._pose is not pose


def test_active_soup_keeps_soup_order(terrain64):
    """The subset is rows of the full soup in the full soup's order (soup
    order breaks raster ties)."""
    cam = tcam.Camera(pos=(32.0, 40.0, 32.0), yaw=0.0, pitch=-1.5)
    act = tact.ActiveSoup(terrain64["full"], 64, 40, margin_deg=8.0,
                          keep_radius=4.0)
    rows = act.active(cam.pos, cam.basis())
    assert 0 < act.n_active < len(terrain64["soup"])

    def records(lo, size, attr):
        return torch.cat([lo, size, attr.view(torch.int32)], 1).tolist()

    index = {tuple(r): i for i, r in enumerate(records(*terrain64["full"]))}
    got = [index[tuple(r)] for r in records(*rows)]
    assert len(got) == act.n_active and got == sorted(set(got))


def test_active_soup_explicit_cap_serves_full(terrain64):
    """A subset above an explicit cap is not truncated: the full soup is
    served, and the frame is still the full soup's."""
    W, H = 64, 40
    h = terrain64["dev"].height
    cam = tcam.Camera(pos=(6.2, 20.1, 5.4), yaw=-5.38, pitch=0.22)
    act = tact.ActiveSoup(terrain64["full"], W, H, cap=8, keep_radius=16.0)
    rows = act.active(cam.pos, cam.basis())
    assert act.overflowed and act.n_active > 8
    assert rows[0] is terrain64["full"][0]
    kw = _exact64(terrain64)
    _assert_same(_frame(rows, cam, h, W, H, **kw),
                 _frame(terrain64["full"], cam, h, W, H, **kw), "cap")


@pytest.mark.parametrize("pool", [4, 32])
def test_min_pool_heights_equals_jax(pool):
    rng = np.random.default_rng(pool)
    h = rng.integers(0, 900, (256, 256)).astype(np.uint32)
    got = tocc.min_pool_heights(h, pool)
    assert got.dtype == np.float32
    assert np.array_equal(got, jocc.min_pool_heights(h, pool))


def _ridge_heights(n=2048, x0=800, x1=960, top=400):
    """Bumpy flat terrain with a tall ridge at x in [x0, x1)
    (tests/test_occlusion.py)."""
    xx = np.arange(n)[:, None]
    zz = np.arange(n)[None, :]
    h = 8 + (3 * np.sin(xx * 0.05) * np.cos(zz * 0.07)).astype(np.int64)
    h = np.clip(h, 1, None)
    h[x0:x1, :] = top
    return h.astype(np.int64)


def _los_clear(heights, p0, p1, step):
    """Per segment p0[i] -> p1[i]: True if it clears the true heightfield
    (tests/test_occlusion.py's march, every segment at once)."""
    n = heights.shape[0]
    d = p1 - p0
    dist = np.linalg.norm(d[:, [0, 2]], axis=1)
    steps = np.maximum((dist / step).astype(np.int64), 2)
    i = np.arange(1, steps.max())[None, :]
    t = i / steps[:, None]
    q = p0[:, None, :] + d[:, None, :] * t[..., None]
    ix = np.trunc(q[..., 0]).astype(np.int64)
    iz = np.trunc(q[..., 2]).astype(np.int64)
    inside = (ix >= 0) & (ix < n) & (iz >= 0) & (iz < n) & (i < steps[:, None])
    hq = heights[np.clip(ix, 0, n - 1), np.clip(iz, 0, n - 1)]
    return ~(inside & (q[..., 1] <= hq)).any(axis=1)


def _soundness_fuzz(heights, pool, slack, cam, half_lo, half_hi, seed):
    """Every box the port's hidden_mask culls is occluded from every
    camera in the slack ball toward every box corner."""
    n = heights.shape[0]
    nd = int(np.ceil(n * 1.5 / pool)) + 1
    tables = tocc.build_horizon(
        torch.from_numpy(tocc.min_pool_heights(heights, pool)), cam, slack,
        nd, pool)
    rng = np.random.default_rng(seed)
    M = 300
    bx = rng.uniform(0, n, M)
    bz = rng.uniform(0, n, M)
    by = rng.uniform(0, 1, M) * heights[bx.astype(int), bz.astype(int)]
    c = np.stack([bx, by, bz], 1).astype(np.float32)
    half = rng.uniform(half_lo, half_hi, (M, 3)).astype(np.float32)
    hidden = tocc.hidden_mask(tables, torch.from_numpy(c),
                              torch.from_numpy(half), cam, slack, nd,
                              pool).numpy()
    offs = [np.zeros(3)]
    diag = slack * 0.999 / np.sqrt(3.0)
    offs += [np.array([sx, sy, sz]) * diag for sx in (-1, 1)
             for sy in (-1, 1) for sz in (-1, 1)]
    for ax in range(3):
        for s in (-1, 1):
            o = np.zeros(3)
            o[ax] = s * slack * 0.999
            offs.append(o)
    corners = np.array([[sx, sy, sz] for sx in (-1, 1) for sy in (-1, 1)
                        for sz in (-1, 1)], np.float64)
    for i in np.nonzero(hidden)[0]:
        p0 = np.repeat(cam[None] + np.asarray(offs), 8, axis=0)
        p1 = np.tile(c[i] + corners * half[i], (len(offs), 1))
        clear = _los_clear(heights, p0, p1.astype(np.float64), 2.0)
        assert not clear.any(), (c[i], half[i], p0[clear][:1])
    return hidden, c


def test_hidden_mask_sound_large_boxes_pool32():
    """pool 32 (the flagship tuning), boxes far wider than the slack: the
    window-fit guard and the lateral bound keep every cull sound."""
    heights = _ridge_heights()
    cam = np.array([100.0, 30.0, 1024.0], np.float32)
    hidden, _ = _soundness_fuzz(heights, 32, 16.0, cam, 8.0, 80.0, seed=5)
    assert hidden.any(), "no large box culled: the fuzz is vacuous"


def test_hidden_mask_sound_fine_pool4():
    """pool 4 (the 1024^3 tuning): sound, and effective behind a ridge at
    sub-flagship distances."""
    heights = _ridge_heights(1024, 400, 480, 200)
    cam = np.array([50.0, 25.0, 512.0], np.float32)
    hidden, c = _soundness_fuzz(heights, 4, 16.0, cam, 1.0, 8.0, seed=7)
    behind = (c[:, 0] > 500) & (np.linalg.norm((c - cam)[:, [0, 2]], axis=1)
                                >= tocc.r_min(4) + 16)
    assert hidden[behind].mean() > 0.6, hidden[behind].mean()


@pytest.fixture(scope="module")
def ridge512():
    """A 512^3 terrain with a ridge, its soup and heightfield pack."""
    heights = _ridge_heights(512, 150, 190, 200)
    rgb = np.array([0.5, 0.5, 0.5], np.float32)
    soup = tboxes.extract_boxes_terrain(heights, 0, rgb)
    tiles, offs, _ = thf.build_height_mips(heights, device="cpu")
    full = traster.soup_to_device(soup.lo, soup.size, soup.leaf, soup.rgb,
                                  "cpu")
    return dict(heights=heights, soup=soup, full=full,
                hf=dict(hf=(tiles, offs, rgb), terrain_node=0))


def _toward_ridge():
    return max((float(tcam.camera_basis(y, 0.0)[0, 2]), y)
               for y in np.linspace(-np.pi, np.pi, 64))[1]


def test_horizon_cull_frames_exact(ridge512):
    """With the heightmap the view also drops ground hidden behind the
    ridge; frames at the build pose and at a pose translated by 0.9 of
    the (occlusion-tightened) budget equal the full soup's."""
    W, H = 64, 40
    yaw = _toward_ridge()
    act = tact.ActiveSoup(ridge512["full"], W, H,
                          heights=ridge512["heights"])
    assert act._hmin2 is not None and act._pool == 4
    budget = act._trans_budget() * 0.9
    poses = [tcam.Camera(pos=(50.0, 40.0, 256.0), yaw=yaw, pitch=0.0),
             tcam.Camera(pos=(50.0 + budget, 40.0, 256.0), yaw=yaw,
                         pitch=0.0)]
    rows = act.active(poses[0].pos, poses[0].basis())
    m = len(ridge512["soup"])
    frustum = tact.ActiveSoup(ridge512["full"], W, H)
    frustum.active(poses[0].pos, poses[0].basis())
    assert act.n_active < 0.7 * frustum.n_active, (act.n_active,
                                                   frustum.n_active, m)
    for cam in poses:
        assert act.active(cam.pos, cam.basis()) is rows
        _assert_same(_frame(rows, cam, 9, W, H, **ridge512["hf"]),
                     _frame(ridge512["full"], cam, 9, W, H, **ridge512["hf"]),
                     cam.pos)


def test_n_active_against_jax_cull(ridge512):
    """The port's _cull keeps as many boxes as JAX's on the same soup,
    heightmap and pose, within N_ACTIVE_BUDGET of the soup."""
    W, H = 64, 40
    yaw = _toward_ridge()
    soup = ridge512["soup"]
    m = len(soup)
    for pos, y, pitch in (((50.0, 40.0, 256.0), yaw, 0.0),
                          ((60.0, 30.0, 100.0), yaw + 0.4, -0.1),
                          ((256.0, 60.0, 256.0), 2.0, 0.3)):
        cam = tcam.Camera(pos=pos, yaw=y, pitch=pitch)
        act = tact.ActiveSoup(ridge512["full"], W, H,
                              heights=ridge512["heights"])
        act.active(cam.pos, cam.basis())
        jsoup = jact.ActiveSoup(soup, W, H, cap=m,
                                heights=ridge512["heights"])
        jsoup.active(np.asarray(pos, np.float32),
                     np.asarray(jcam.camera_basis(y, pitch)))
        assert 0 < act.n_active < m
        assert abs(act.n_active - jsoup.n_active) <= N_ACTIVE_BUDGET * m, (
            pos, act.n_active, jsoup.n_active, m)


@pytest.mark.parametrize("pose", [((50.0, 40.0, 256.0), 0.0, 0.0),
                                  ((60.0, 30.0, 100.0), 0.4, -0.1)])
def test_view_jittered_batch_primaries_equal(ridge512, pose):
    """The main path's primaries: a batch of two seeds' jittered camera
    rays, binned on the horizon-culled view, resolve to the full soup's
    in every output, lane for lane (the exact frame at batch form)."""
    from voxtracer_torch.kernels import integrator as tint

    W, H = 48, 32
    pos, dyaw, pitch = pose
    cam = tcam.Camera(pos=pos, yaw=_toward_ridge() + dyaw, pitch=pitch)
    op = np.asarray(cam.pos, np.float32)
    basis = cam.basis()
    d = torch.stack([tint._primary(op, basis, s, W, H, "cpu")[1]
                     for s in (3, 11)])
    act = tact.ActiveSoup(ridge512["full"], W, H,
                          heights=ridge512["heights"])
    rows = act.active(cam.pos, basis)
    assert 0 < act.n_active < len(ridge512["soup"])
    _assert_same(_frame(rows, cam, 9, W, H, ray_dirs=d, **ridge512["hf"]),
                 _frame(ridge512["full"], cam, 9, W, H, ray_dirs=d,
                        **ridge512["hf"]), pos)
