"""Port vs JAX: multi-device rendering (voxtracer_torch/dist, the banded
render_sample and raster_cast) against voxtracer/dist on the same numpy
inputs. The conftest gives JAX 8 virtual CPU devices; the port shards
over ``["cpu"] * 8``. Worlds, cameras and sizes are tests/test_dist.py's
(16^3 at 32x16, 2 bounces, 8 fog steps).

Within the port every sharded result is held by bits: the sample step to
the serial mesh-order sum, the tile step (even and with a remainder band)
to the full frame, a banded cast to the full frame's rows, the envelope
as call args to none, the culled view as call args to the same view
closed over. Against the JAX package the port is held to its path-sample
budget (tests/test_torch_integrator.py: at most 0.5% of the values beyond
1e-3, means within 1e-3 relative, here of the values not so budgeted:
``_budget``): the jittered camera ray that XLA fuses into FMAs (ROADMAP
C).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.core.spectra import build_wl_to_rgb_lut
from voxtracer.dist.mesh import make_mesh as jmake_mesh
from voxtracer.dist.shard import replicate_world as jreplicate_world
from voxtracer.dist.shard import sample_sharded_step as jsample_step
from voxtracer.dist.shard import tile_sharded_step as jtile_step
from voxtracer.kernels.raster import pack_box_attr
from voxtracer.world.boxes import extract_boxes as jextract
from voxtracer.world.svo import from_dense as jfrom_dense
from voxtracer_torch.app import cli as tcli
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.dist import mesh as tmesh
from voxtracer_torch.dist import multihost, shard
from voxtracer_torch.kernels import heightfield as thf
from voxtracer_torch.kernels import integrator as tint
from voxtracer_torch.kernels import raster as traster
from voxtracer_torch.render import driver as tdrv
from voxtracer_torch.world import boxes as tboxes
from voxtracer_torch.world import svo as tsvo
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)
W, H = 32, 16
KW = dict(max_bounces=2, fog_steps=8)
FRAC, MEAN_REL = 5e-3, 1e-3  # tests/test_torch_integrator.py's budget
LUT = build_wl_to_rgb_lut(256)
CPU8 = ["cpu"] * 8
TILE_SEED = np.array([9, 8, 7], np.uint32)


def _budget(img, want):
    """The port's path-sample budget against the JAX package: at most
    FRAC of the values beyond 1e-3, and the means of the other values
    within MEAN_REL. The class is XLA's CPU code against the port's
    op-by-op rounding (tests/test_torch_integrator.py's docstring: FMA
    contraction, XLA's own cos/sin/exp/log); a path it moves by an ulp can
    graze an edge and take another bounce. At 32x16 one such pixel alone
    moves the whole image's mean by about 1e-3 (3 pixels of 8 samples in
    the ``random`` world; 10 when the port's square root was torch's
    float32 one, one ulp off in one lane in six on some CPU builds), so the
    means leave out the values the first part already budgets; a shift of
    every pixel still fails."""
    img, want = np.asarray(img), np.asarray(want)
    assert img.shape == want.shape and np.isfinite(img).all()
    near = np.abs(img - want) <= 1e-3
    assert 1.0 - near.mean() <= FRAC, \
        f"{1.0 - near.mean():.4%} of values beyond 1e-3"
    assert abs(img[near].mean() / want[near].mean() - 1.0) <= MEAN_REL


def _cam():
    return tcam.Camera(pos=(8.0, 6.0, 8.0), yaw=0.3, pitch=0.4)


def _sun():
    sun = np.asarray([0.3, 0.9, 0.3], np.float32)
    return (sun / np.linalg.norm(sun)).astype(np.float32)


def _scene(kind):
    """tests/test_dist.py's worlds: ``plane`` (_world), ``soup`` (the
    plane and a block, _world_soup) and ``random`` (the soup-primaries
    test's 15% random fill); the JAX device world, and its soup as numpy
    (None for the plane)."""
    n = 16
    if kind == "random":
        rng = np.random.default_rng(3)
        solid = rng.random((n, n, n)) < 0.15
        rgb = rng.random((n, n, n, 3)).astype(np.float32)
        rgb[~solid] = 0
    else:
        solid = np.zeros((n, n, n), bool)
        solid[:, :2, :] = True
        if kind == "soup":
            solid[5:8, 2:5, 6:9] = True
        rgb = np.zeros((n, n, n, 3), np.float32)
        rgb[solid] = 0.5
    dev = jfrom_dense(solid, rgb).serialize()
    return dev, (None if kind == "plane" else jextract(dev))


class _Both:
    """One world in both packages: the port's tensors and the JAX step
    arguments replicated over the JAX mesh."""

    def __init__(self, kind):
        self.dev, soup = _scene(kind)
        d = self.dev
        self.w = tsvo.upload(d.table, d.root, d.height, "cpu")
        self.lut = torch.from_numpy(LUT)
        self.soup = None if soup is None else traster.soup_to_device(
            soup.lo, soup.size, soup.leaf, soup.rgb, "cpu")
        self.jsoup = None if soup is None else (
            jnp.asarray(soup.lo), jnp.asarray(soup.size),
            jnp.asarray(pack_box_attr(soup)))

    def port_args(self, cam):
        return (np.asarray(cam.pos, np.float32), cam.basis(),
                torch.from_numpy(_sun()))

    def single(self, seed, h=H, **kw):
        cam = _cam()
        return tint.render_sample(self.w.table, self.w.root, self.w.height,
                                  self.lut, *self.port_args(cam)[:2],
                                  torch.from_numpy(_sun()), seed, W, h,
                                  soup=self.soup, **kw, **KW)

    def port_step(self, make, h=H, mesh=None):
        mesh = mesh or tmesh.make_mesh(devices=CPU8)
        table, lut, *soup = shard.replicate_world(mesh, self.w.table,
                                                  self.lut, self.soup)
        assert table.on("cpu") is self.w.table  # one device: no copy
        return make(mesh, table, self.w.root, self.w.height, lut, W, h,
                    soup=soup[0] if soup else None, **KW)

    def jax_step(self, make, h=H):
        d = self.dev
        mesh = jmake_mesh(8)
        table = jnp.asarray(d.table.view(np.int32))
        if self.jsoup is None:
            table_r, lut_r = jreplicate_world(mesh, table, jnp.asarray(LUT))
            soup_r = None
        else:
            table_r, lut_r, soup_r = jreplicate_world(
                mesh, table, jnp.asarray(LUT), self.jsoup)
        cam = jcam.Camera(pos=(8.0, 6.0, 8.0), yaw=0.3, pitch=0.4)
        step = make(mesh, table_r, np.int32(d.root), d.height, lut_r, W, h,
                    soup=soup_r, **KW)
        args = (np.asarray(cam.pos, np.float32), cam.basis(),
                jnp.asarray(_sun()))
        return step, args


def _seeds(kind):
    if kind == "random":
        rows = [[i + 5, 2 * i + 3, 3 * i + 7] for i in range(8)]
    else:
        rows = [[i + 1, 2 * i + 1, 3 * i + 1] for i in range(8)]
    return np.asarray(rows, np.uint32)


@pytest.mark.parametrize("kind", ["plane", "random"])
def test_sample_sharded_equals_serial_sum_and_jax(kind):
    """The sample step is the serial mesh-order sum by bits (``random``:
    rasterized primaries on every shard), and JAX's step within the
    budget."""
    b = _Both(kind)
    seeds = _seeds(kind)
    step = b.port_step(shard.sample_sharded_step)
    out = step(seeds, *b.port_args(_cam()))
    serial = b.single(seeds[0])
    for s in seeds[1:]:
        serial = serial + b.single(s)
    assert torch.equal(out, serial)
    jstep, jargs = b.jax_step(jsample_step)
    _budget(out.numpy(), jstep(jnp.asarray(seeds), *jargs))


@pytest.mark.parametrize("kind,h", [("plane", 16), ("plane", 13),
                                    ("soup", 16), ("soup", 13)])
def test_tile_sharded_equals_full_frame(kind, h):
    """Each shard's band of ceil(h / 8) rows, the remainder band padded:
    the cropped frame is the full frame by bits (with a soup every band
    rasterizes its tile-aligned rows against the full-frame bins); JAX's
    tile step within the budget."""
    b = _Both(kind)
    step = b.port_step(shard.tile_sharded_step, h)
    assert step.out_rows == 16
    out = step(TILE_SEED, *b.port_args(_cam()))
    assert out.shape == (16, W, 3)
    assert torch.equal(out[:h], b.single(TILE_SEED, h))
    if kind == "soup" and h == 13:
        return  # the JAX tests shard no soup over a remainder band
    jstep, jargs = b.jax_step(jtile_step, h)
    _budget(out[:h].numpy(), np.asarray(jstep(jnp.asarray(TILE_SEED),
                                              *jargs))[:h])


def test_tile_sharding_a_soup_that_cannot_pad_raises():
    """16 rows over 3 shards pad to 18, past the 16-row tiled frame: with
    a soup that is the JAX package's ValueError; without one the padded
    rows are traced and cropped, equal to the full frame by bits."""
    b = _Both("soup")
    with pytest.raises(ValueError, match="use sample sharding"):
        b.port_step(shard.tile_sharded_step,
                    mesh=tmesh.make_mesh(devices=["cpu"] * 3))
    p = _Both("plane")
    step = p.port_step(shard.tile_sharded_step,
                       mesh=tmesh.make_mesh(devices=["cpu"] * 3))
    assert step.out_rows == 18
    out = step(TILE_SEED, *p.port_args(_cam()))
    assert torch.equal(out[:H], p.single(TILE_SEED))


@pytest.fixture(scope="module")
def terrain():
    """A 64^3 terrain world of the port with its soup and heightfield
    pack."""
    space = tgen.generate(log2_size=6, verbose=False, device="cpu")
    dev = space.serialize()
    soup = tboxes.extract_boxes(dev)
    tiles, offs, _ = thf.build_height_mips(np.asarray(space.heights),
                                           device="cpu")
    return dict(
        space=space, w=tsvo.upload(dev.table, dev.root, dev.height, "cpu"),
        soup=traster.soup_to_device(soup.lo, soup.size, soup.leaf, soup.rgb,
                                    "cpu"),
        hf=(tiles, offs, torch.tensor(space.terrain_rgb,
                                      dtype=torch.float32)))


TERRAIN_CAM = dict(pos=(30.0, 34.0, 12.0), yaw=0.9, pitch=-0.3)
TW_, TH_ = 40, 45  # 45 rows: the bottom tile row is ragged


@pytest.mark.parametrize("fallback", ["svo", "hf"])
@pytest.mark.parametrize("row0,rows", [(13, 6), (40, 5)])
def test_banded_raster_cast_exact_equals_full_rows(terrain, monkeypatch,
                                                   fallback, row0, rows):
    """Starved bins (2 candidates, widen rounds of 1, 1 and 2 records)
    leave tiles open in every band, so the fallback runs with the frame's
    tile ids and the band's rows. The band that starts mid-tile (row 13)
    and the one at the bottom edge (its tile-aligned run holds rows past
    the frame) give the full frame's rows in every output, by bits."""
    monkeypatch.setattr(traster, "WIDEN_K", (1, 1, 2))
    w = terrain["w"]
    cam = tcam.Camera(**TERRAIN_CAM)
    op = np.asarray(cam.pos, np.float32)
    _, d, _ = tint._primary(op, cam.basis(), TILE_SEED, TW_, TH_, "cpu")
    bins = traster.raster_bins(*terrain["soup"], op, cam.basis(), w.height,
                               TW_, TH_, cand_k=2, jittered=True)
    kw = dict(table=w.table, root=w.root, bins=bins, want_voxel=True,
              hf=terrain["hf"] if fallback == "hf" else None)
    full = traster.raster_cast_exact(*terrain["soup"], op, cam.basis(),
                                     w.height, TW_, TH_, ray_dirs=d, **kw)
    r0a, rp, off = tint._aligned_band(row0, rows, TH_)
    assert off > 0 and r0a % traster.TILE == 0
    _, db, _ = tint._primary(op, cam.basis(), TILE_SEED, TW_, TH_, "cpu",
                             r0a, rp)
    band = traster.raster_cast_exact(*terrain["soup"], op, cam.basis(),
                                     w.height, TW_, TH_, ray_dirs=db,
                                     band_row0=r0a, band_rows=rp, **kw)
    assert band["n_fallback"] > 0 and band["hit"].shape == (rp, TW_)
    assert (band["fb_tiles"] >= r0a // traster.TILE * 5).all()
    n = min(rp, TH_ - r0a)
    for f in ("hit", "t", "normal", "rgb", "node", "voxel"):
        assert torch.equal(band[f][:n], full[f][r0a:r0a + n]), f


@pytest.mark.parametrize("engine", ["soup", "hf_env"])
def test_render_sample_band_equals_full_rows(terrain, monkeypatch, engine):
    """``render_sample(row0=, rows=)`` seeds and maps every pixel by its
    row in the whole frame: bands starting mid-tile and at the bottom
    edge (rows past it included) are the full frame's rows by bits, with
    rasterized primaries (starved, so the K4 fallback runs) and with the
    envelope-resumed heightfield primaries."""
    monkeypatch.setattr(traster, "WIDEN_K", (1, 1, 2))
    w = terrain["w"]
    cam = tcam.Camera(**TERRAIN_CAM)
    op = np.asarray(cam.pos, np.float32)
    tiles, offs, trgb = terrain["hf"]
    kw = dict(hf_mips=tiles, hf_offsets=offs, terrain_rgb=trgb, **KW)
    if engine == "soup":
        kw.update(soup=terrain["soup"], soup_bins=traster.raster_bins(
            *terrain["soup"], op, cam.basis(), w.height, TW_, TH_, cand_k=2,
            jittered=True))
    else:
        from voxtracer_torch.kernels import skyline

        levels = skyline.sky_levels_from_hf(tiles, offs, w.height)
        env = skyline.build_skyline_env_device(levels, np.asarray(
            cam.pos, np.float64), bins=512, K=64, ratio=8)
        kw.update(hf_sky_env=(env["E"], env["d0"], env["g"], env["K"],
                              env["S"]))
    args = (w.table, w.root, w.height, torch.from_numpy(LUT), op,
            cam.basis(), torch.from_numpy(_sun()), TILE_SEED, TW_, TH_)
    full = tint.render_sample(*args, **kw)
    for row0, rows in ((13, 6), (40, 5), (41, 7)):
        band = tint.render_sample(*args, row0=row0, rows=rows, **kw)
        n = min(rows, TH_ - row0)
        assert band.shape == (rows, TW_, 3)
        assert torch.equal(band[:n], full[row0:row0 + n])


@pytest.fixture(scope="module")
def hf_only():
    """A 32^3 terrain Renderer in hf-only mode (``HF_FRAME_SIZE`` lowered
    for the test), its heightfield pack and the pose's envelope."""
    space = tgen.generate(log2_size=5, verbose=False, device="cpu")
    r = tdrv.Renderer(space.serialize(), W, H, seed=0, device="cpu", **KW)
    r.HF_FRAME_SIZE = 32
    cam = tcam.Camera(pos=(12.0, 14.0, 6.0), yaw=0.4, pitch=0.5)
    assert r._hf_only()
    return r, cam, r._get_sky_env(cam)


def test_hf_only_steps_with_and_without_envelope(hf_only):
    """The hf-only sharded steps with the envelope ``(E, d0, g, K, S)`` as
    call args equal the same steps without it, by bits (the JAX dryrun's
    out5 == out4, out7 == out7p), and the serial sum and the full frame;
    7 shards pad 16 rows to 21."""
    r, cam, env = hf_only
    tiles, offs, trgb = r._get_hf()
    w = r.world
    kw = dict(hf_mips=tiles, hf_offsets=offs, terrain_rgb=trgb, **KW)
    args = (np.asarray(cam.pos, np.float32), cam.basis(),
            torch.from_numpy(_sun()))
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    env_r = tuple(shard.replicate(mesh, a) if torch.is_tensor(a) else a
                  for a in env)
    seeds = _seeds("plane")[:4]
    step = shard.sample_sharded_step(mesh, w.table, w.root, w.height, r.lut,
                                     W, H, **kw)
    with_env, plain = step(seeds, *args, *env_r), step(seeds, *args)

    def single(seed, **band):
        return tint.render_sample(w.table, w.root, w.height, r.lut, *args,
                                  seed, W, H, hf_sky_env=env, **band, **kw)

    serial = single(seeds[0])
    for s in seeds[1:]:
        serial = serial + single(s)
    assert torch.equal(with_env, plain) and torch.equal(with_env, serial)
    full = single(TILE_SEED)
    for n in (4, 7):
        tstep = shard.tile_sharded_step(
            tmesh.make_mesh(devices=["cpu"] * n), w.table, w.root, w.height,
            r.lut, W, H, **kw)
        assert tstep.out_rows == {4: 16, 7: 21}[n]
        out = tstep(TILE_SEED, *args, *env)
        assert torch.equal(out, tstep(TILE_SEED, *args))
        assert torch.equal(out[:H], full)


@pytest.mark.parametrize("make", [shard.sample_sharded_step,
                                  shard.tile_sharded_step])
def test_dynamic_soup_view_equals_closed_over(terrain, make):
    """``dynamic_soup``: the pose's culled view (world/active.ActiveSoup)
    as three call args gives the step that closes over the same view, by
    bits; a view given as a Replicated passes without a copy."""
    from voxtracer_torch.world.active import ActiveSoup

    w = terrain["w"]
    cam = tcam.Camera(**TERRAIN_CAM)
    op = np.asarray(cam.pos, np.float32)
    view = ActiveSoup(terrain["soup"], W, H,
                      heights=terrain["space"].heights).active(op,
                                                               cam.basis())
    mesh = tmesh.make_mesh(devices=["cpu"] * 4)
    kw = dict(hf_mips=terrain["hf"][0], hf_offsets=terrain["hf"][1],
              terrain_rgb=terrain["hf"][2], **KW)
    dyn = make(mesh, w.table, w.root, w.height, torch.from_numpy(LUT), W, H,
               dynamic_soup=True, **kw)
    closed = make(mesh, w.table, w.root, w.height, torch.from_numpy(LUT), W,
                  H, soup=view, **kw)
    lead = _seeds("plane")[:4] if make is shard.sample_sharded_step \
        else TILE_SEED
    args = (lead, op, cam.basis(), torch.from_numpy(_sun()))
    want = closed(*args)
    assert torch.equal(dyn(*args, *view), want)
    view_r = shard.replicate(mesh, view)
    assert view_r.on("cpu")[0] is view[0]
    assert torch.equal(dyn(*args, *(shard.Replicated(
        {d: view_r.on(d)[i] for d in mesh.distinct}) for i in range(3))),
        want)
    with pytest.raises(ValueError, match="replaces"):
        make(mesh, w.table, w.root, w.height, torch.from_numpy(LUT), W, H,
             soup=view, dynamic_soup=True, **kw)


def test_renderer_devices_matches_single_samples_and_jax():
    """``Renderer(devices=["cpu"] * 8).sample()`` adds 8 samples: its
    first step equals 8 single ``sample()`` calls with the same host seeds
    by bits (the buffer starts at 0, the sum is in mesh order), a second
    one within the JAX tests' tolerance (rtol 1e-5, atol 1e-4), and JAX's
    ``Renderer(devices=8)`` with the same seed within the budget."""
    from voxtracer.render.driver import Renderer as JRenderer

    dev, _ = _scene("plane")
    cam = _cam()
    sun = np.array([0.3, 1.0, 0.2])
    r8 = tdrv.Renderer(dev, W, H, seed=11, devices=CPU8, **KW)
    r1 = tdrv.Renderer(dev, W, H, seed=11, device="cpu", **KW)
    assert r8.mesh.size == 8 and r8.device == torch.device("cpu")
    r8.sample(cam, sun)
    for _ in range(8):
        r1.sample(cam, sun)
    assert r8.acc.samples == r1.acc.samples == 8
    assert torch.equal(r8.acc.buffer, r1.acc.buffer)
    # the port's Renderer casts this heightmap-less world's primaries on
    # the SVO; so does the JAX one told not to rasterize them
    j8 = JRenderer(dev, W, H, seed=11, devices=8, use_soup=False, **KW)
    j8.sample(jcam.Camera(pos=cam.pos, yaw=cam.yaw, pitch=cam.pitch), sun)
    assert j8.acc.samples == 8
    _budget(r8.acc.buffer.numpy(), j8.acc.buffer)
    r8.sample(cam, sun)
    for _ in range(8):
        r1.sample(cam, sun)
    assert r8.acc.samples == 16
    assert torch.allclose(r8.acc.buffer, r1.acc.buffer, rtol=1e-5,
                          atol=1e-4)


def test_renderer_devices_rebuilds_its_step_after_edits():
    """The sharded step closes over the world: ``apply_edits`` drops it,
    and the next step (rasterized primaries, heightfield casts, the
    pose's bins per device) equals a single-device Renderer edited the
    same way, by bits; ``update_space`` drops it too."""
    sun = np.array([0.8, 10.2743, 3.7])
    cam = tcam.Camera(pos=(12.0, 14.0, 6.0), yaw=0.4, pitch=0.5)
    rs = []
    for devices in (["cpu"] * 3, None):
        space = tgen.generate(log2_size=5, verbose=False, device="cpu")
        r = tdrv.Renderer(space.serialize(), W, H, seed=2, device="cpu",
                          devices=devices, **KW)
        rs.append((space, r))
    (s3, r3), (s1, r1) = rs
    r3.sample(cam, sun)
    for _ in range(3):
        r1.sample(cam, sun)
    assert torch.equal(r3.acc.buffer, r1.acc.buffer)
    first = r3._dist_step
    assert first is not None and r3._dist_soup is not None and r3._dist_hf
    for space, r in rs:
        p = (12, int(space.heights[12, 6]) - 1, 6)
        space.set(p, None)
        r.apply_edits(space, edits=[p])
    assert r3._dist_step is None
    r3.sample(cam, sun)
    for _ in range(3):
        r1.sample(cam, sun)
    assert r3._dist_step is not first
    assert r3.acc.samples == r1.acc.samples == 3
    assert torch.equal(r3.acc.buffer, r1.acc.buffer)
    r3.update_space(s3.serialize())
    assert r3._dist_step is None


def test_make_mesh_and_multihost_init_without_a_card(monkeypatch):
    """Without a card a mesh of cards raises (never a smaller mesh), and
    so do ``Renderer(devices=3)`` and the CLI's ``--devices 3``; a CPU
    mesh takes repeats; ``multihost.init`` is a no-op for one process."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for n in (3, None):
        with pytest.raises(RuntimeError, match="CUDA"):
            tmesh.make_mesh(n)
    with pytest.raises(RuntimeError, match="CUDA"):
        tdrv.Renderer(_scene("plane")[0], W, H, devices=3)
    args = tcli.build_parser().parse_args(["render", "--devices", "3"])
    assert args.devices == 3 and tcli._devices(args, "cuda") == 3
    assert tcli._devices(args, "cpu") == ["cpu"] * 3
    mesh = tmesh.make_mesh(devices=["cpu"] * 3)
    assert mesh.size == 3 and mesh.distinct == (torch.device("cpu"),)
    assert mesh.global_size == 3 and multihost.local_rows(mesh) == [0, 1, 2]
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert multihost.init() is False
    assert multihost.init("127.0.0.1:1", world_size=1, rank=0) is False
    assert not torch.distributed.is_initialized()
    with pytest.raises(ValueError, match="one seed row"):
        multihost.global_seeds(mesh, np.zeros((2, 3), np.uint32))


@pytest.mark.parametrize("cmd", ["render", "headless"])
def test_cli_devices_on_the_cpu(tmp_path, monkeypatch, cmd):
    """``render --mode path --devices 8`` and ``headless --devices 8``
    with the CLI's device turned to the CPU, as the session tests run it:
    8 shards on ["cpu"] * 8."""
    monkeypatch.setattr(tcli, "_device", lambda: "cpu")
    monkeypatch.chdir(tmp_path)
    common = ["--log2-size", "4", "--width", "16", "--height", "8",
              "--max-bounces", "2", "--fog-steps", "8", "--devices", "8"]
    if cmd == "render":
        tcli.main(["render", *common, "--mode", "path", "--spp", "8",
                   "--out", "dist.png"])
        assert (tmp_path / "dist.png").exists()
    else:
        tcli.main(["headless", *common, "--frame-samples", "8",
                   "--max-frames", "1", "--frames-dir", "frames"])
        assert [p.name for p in (tmp_path / "frames").glob("*.exr")] \
            == ["0000-000.exr"]
