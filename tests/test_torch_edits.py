"""Port vs JAX: point edits (voxtracer_torch/world/svo.py and native.py
serialize_delta, world/boxes.py SoupPatcher and the instance extractor,
render/driver.py Renderer.apply_edits, _apply_hf_edits and _hf_bounds),
case by case as tests/test_incremental.py, tests/test_hf_edit.py and
tests/test_boxes_native.py hold the JAX package.

Both packages see the same edits. Python spaces are built by the same
sequence of interning calls in both, so their slot numbers, deltas and
patched soups agree bit for bit; native spaces run the same C++. The
Renderer's decisions (heightfield-exact or bounds, the box list, the
re-derived heights) are held to the JAX Renderer's after the same batch.
Radiance is held to a Renderer built fresh on the edited world: bit for
bit where both run the same engines, else up to the edge-graze budget of
the JAX tests (4 pixels, 8 for the spread-out session). The port's table
grows to the space's capacity exactly (no recompiles to avoid, so no 64k
steps): its rows equal a full serialize's; JAX's padded table agrees on
those rows.
"""

import dataclasses

import numpy as np
import pytest
import torch

from voxtracer.render import driver as jdrv
from voxtracer.world import boxes as jboxes
from voxtracer.world import native as jnative
from voxtracer.world import svo as jsvo
from voxtracer.world import worldgen as jgen
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.kernels import raster as trs
from voxtracer_torch.render import driver as tdrv
from voxtracer_torch.world import boxes as tboxes
from voxtracer_torch.world import native as tnative
from voxtracer_torch.world import svo as tsvo
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)
SUN = np.array([0.5, 0.8, 0.33])


def _build(space, solid, rgb):
    """A dense grid into ``space`` by interning calls in a fixed order, so
    either package's SvoSpace gets the same slots."""
    def rec(x, y, z, s):
        if s == 1:
            return space.create_block(tuple(float(c) for c in rgb[x, y, z])) \
                if solid[x, y, z] else None
        h = s // 2
        return space.create_children([
            rec(x + (i & 1) * h, y + ((i >> 1) & 1) * h, z + ((i >> 2) & 1) * h,
                h) for i in range(8)])
    space.set_root(rec(0, 0, 0, solid.shape[0]))
    return space


def _pair(solid, rgb):
    return (_build(tsvo.SvoSpace(), solid, rgb),
            _build(jsvo.SvoSpace(), solid, rgb))


def _tiny_world(n=8):
    rng = np.random.default_rng(7)
    return rng.random((n, n, n)) < 0.3, \
        rng.random((n, n, n, 3)).astype(np.float32)


def _edit_script(space, n):
    """tests/test_incremental.py's: deletes, new colours (new slots), an
    overwrite, a no-op and the clear of a placed voxel."""
    space.set((0, 0, 0), None)
    space.set((1, 2, 3), (0.125, 0.25, 0.5))
    space.set((n - 1, n - 1, n - 1), (1.0, 1.0, 1.0))
    space.set((1, 2, 3), (0.9, 0.1, 0.1))
    space.set((4, 4, 4), None)
    space.set((4, 4, 4), None)  # no-op on empty
    space.set((n - 1, n - 1, n - 1), None)


def _apply_delta(base, delta):
    rows, vals, solid, root, height, cap = delta
    table, sld = base.table.copy(), base.solid_leaf.copy()
    if cap > len(table):
        table = np.concatenate(
            [table, np.full((cap - len(table), 8), tsvo.EMPTY, np.uint32)])
        sld = np.concatenate([sld, np.full(cap - len(sld), -1, np.int32)])
    table[rows] = vals
    sld[rows] = solid
    return table, sld, root


def _assert_delta(space, jspace, base, script):
    script(space)
    script(jspace)
    delta, jdelta = space.serialize_delta(), jspace.serialize_delta()
    assert delta is not None and len(delta[0]) > 0
    for a, b in zip(delta, jdelta):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    table, solid, root = _apply_delta(base, delta)
    full = space.serialize()
    assert np.array_equal(table, full.table)
    assert np.array_equal(solid, full.solid_leaf)
    assert root == full.root
    assert len(space.serialize_delta()[0]) == 0  # drained
    return table


def test_python_delta_matches_full_serialize():
    n = 8
    space, jspace = _pair(*_tiny_world(n))
    assert space.serialize_delta() is None  # no baseline yet
    base = space.serialize()
    jspace.serialize()
    assert np.array_equal(base.table, jspace.serialize().table)
    space.serialize()
    assert len(space.serialize_delta()[0]) == 0
    _assert_delta(space, jspace, base, lambda s: _edit_script(s, n))
    assert (space.set_calls, space.edit_count, space.edited) == \
        (jspace.set_calls, jspace.edit_count, jspace.edited)
    assert space.set_calls == 7 and space.edited


def test_delta_capacity_growth():
    solid = np.zeros((4, 4, 4), bool)
    solid[0, 0, 0] = True
    space, jspace = _pair(solid, np.full((4, 4, 4, 3), 0.5, np.float32))
    base = space.serialize()
    jspace.serialize()

    def script(s):  # new colours: leaf slots past the baseline capacity
        for i in range(12):
            s.set((i % 4, (i // 4) % 4, 3), (0.01 * i, 0.5, 0.5))

    table = _assert_delta(space, jspace, base, script)
    assert len(table) > len(base.table)


@pytest.mark.skipif(not tnative.available(), reason="needs g++")
def test_native_delta_matches_full_serialize():
    n = 8
    heights = np.random.default_rng(3).integers(0, n, (n, n)).astype(np.uint32)
    space, jspace = tnative.NativeSvoSpace(), jnative.NativeSvoSpace()
    for s in (space, jspace):
        s.build_terrain(heights, rgb=(0.3, 0.6, 0.2))
    assert space.serialize_delta() is None
    base = space.serialize()
    jspace.serialize()
    _assert_delta(space, jspace, base, lambda s: _edit_script(s, n))
    assert (space.edit_count, space.edited) == (7, True)


def _frame(soup_t, space, cam, W=48, H=40):
    dd = space.serialize()
    w = tsvo.upload(dd.table, dd.root, dd.height, "cpu")
    r = trs.raster_cast_exact(*soup_t, np.asarray(cam.pos, np.float32),
                              cam.basis(), dd.height, W, H, table=w.table,
                              root=w.root)
    return {k: r[k] for k in ("hit", "t", "normal", "rgb")}


@pytest.mark.parametrize("index_tile", [16, 4])
def test_soup_patch_matches_rebuild(index_tile, monkeypatch):
    """tests/test_incremental.py:149: after each edit the patched soup's
    exact raster frame equals a fresh extraction's; the patcher's arrays
    equal JAX's patcher's on the same edits. With index tiles of 4
    columns most boxes span tiles (the rows scanned every edit)."""
    monkeypatch.setattr(tboxes.SoupPatcher, "INDEX_TILE", index_tile)
    n = 16
    solid = np.zeros((n, n, n), bool)
    solid[:, :3, :] = True
    solid[4:8, 3:6, 4:8] = True
    rgb = np.broadcast_to(np.asarray([0.5, 0.4, 0.3], np.float32),
                          (n, n, n, 3)).copy()
    rgb[4:8, 3:6, 4:8] = [0.2, 0.6, 0.2]
    space, jspace = _pair(solid, rgb)
    patcher = tboxes.SoupPatcher(tboxes.extract_boxes(space.serialize()),
                                 "cpu", overlay=512)
    jpatcher = jboxes.SoupPatcher(jboxes.extract_boxes(jspace.serialize()),
                                  overlay=512)
    # looking down at the slab (the reference test's pitch -0.55 looks up,
    # where there is nothing to hit)
    cam = tcam.Camera(pos=(n * 1.4, n * 1.1, n * 1.5), yaw=np.pi + 0.7,
                      pitch=0.55)
    for p, val in [((5, 5, 5), None), ((5, 8, 5), (1.0, 1.0, 1.0)),
                   ((4, 5, 4), (0.9, 0.1, 0.1)), ((8, 2, 8), None),
                   ((5, 4, 5), None)]:
        for s in (space, jspace):
            s.set(p, val)
        assert patcher.apply([p], space) and jpatcher.apply([p], jspace)
        assert patcher.n_used == jpatcher.n_used
        for f in ("lo", "size", "leaf"):
            assert np.array_equal(getattr(patcher, f), getattr(jpatcher, f))
        got = _frame(patcher.device_soup, space, cam)
        fresh = tboxes.extract_boxes(space.serialize())
        want = _frame(trs.soup_to_device(fresh.lo, fresh.size, fresh.leaf,
                                         fresh.rgb, "cpu"), space, cam)
        for k in got:
            assert torch.equal(got[k], want[k]), (p, k)
    assert bool(got["hit"].any())


def test_renderer_apply_edits_matches_rebuild():
    """tests/test_incremental.py:118 on the port: the device table after
    apply_edits equals a full serialize row for row (grown exactly; JAX's
    table agrees on these rows), and the next sample equals a fresh
    Renderer's."""
    n = 8
    space, jspace = _pair(*_tiny_world(n))
    r = tdrv.Renderer(space.serialize(), 16, 12, max_bounces=2, fog_steps=4,
                      seed=11, device="cpu")
    jr = jdrv.Renderer(jspace.serialize(), 16, 12, max_bounces=2,
                       fog_steps=4, seed=11)
    for s in (space, jspace):
        _edit_script(s, n)
    r.apply_edits(space)
    jr.apply_edits(jspace)
    full = space.serialize()
    cap = full.table.shape[0]
    table = r.world.table.numpy()
    assert np.array_equal(table[:cap], full.table.view(np.int32))
    assert (table[cap:] == -1).all()
    assert np.array_equal(r._solid_leaf[:cap], full.solid_leaf)
    assert r.world.root == (full.root if full.root != tsvo.EMPTY else -1)
    assert np.array_equal(np.asarray(jr.table)[:cap], table[:cap])

    r2 = tdrv.Renderer(full, 16, 12, max_bounces=2, fog_steps=4, seed=11,
                       device="cpu")
    cam = tcam.Camera(pos=(4.0, 6.0, -3.0), yaw=0.1, pitch=-0.4)
    sun = np.array([0.3, 0.8, 0.5])
    r.sample(cam, sun)
    r2.sample(cam, sun)
    assert torch.equal(r.acc.buffer, r2.acc.buffer)


def _worlds(log2=6):
    """The same terrain in both packages (each its own space)."""
    space = tgen.generate(log2_size=log2, verbose=False, device="cpu")
    jspace = jgen.generate(log2_size=log2, verbose=False)
    assert np.array_equal(np.asarray(space.heights), np.asarray(jspace.heights))
    return space, jspace


def _site(space):
    h0 = np.asarray(space.heights)
    cx, cz = np.unravel_index(np.argmax(h0[8:56, 8:56]), (48, 48))
    cx, cz = int(cx) + 8, int(cz) + 8
    top = int(h0[cx, cz])
    # looking down at the site (the reference tests' pitch -0.45 looks up)
    cam = tcam.Camera(pos=(cx - 14.0, top + 9.0, cz - 10.0), yaw=0.65,
                      pitch=0.45)
    return cx, cz, top, cam


def _pair_renderers(space, jspace, W=32, H=24):
    r = tdrv.Renderer(space.serialize(), W, H, max_bounces=3, fog_steps=8,
                      seed=5, device="cpu")
    jr = jdrv.Renderer(jspace.serialize(), W, H, max_bounces=3, fog_steps=8,
                       seed=5)
    return r, jr


def _edit(r, jr, space, jspace, edits, val):
    for s in (space, jspace):
        for p in edits:
            s.set(p, val)
    r.apply_edits(space, edits=edits)
    jr.apply_edits(jspace, edits=edits)
    assert space.heights_exact == jspace.heights_exact
    assert np.array_equal(np.asarray(space.heights),
                          np.asarray(jspace.heights))
    assert (r._hf_bounds() is None) == (jr._hf_bounds() is None)
    assert (r._edit_bounds is None) == (jr._edit_bounds is None)
    if r._edit_bounds is not None:
        assert len(r._edit_bounds) == len(jr._edit_bounds)
        for a, b in zip(r._edit_bounds, jr._edit_bounds):
            assert np.array_equal(a, b)


def _unresolved(r, cam):
    """Rays the rasterized preview of ``r`` leaves unresolved (its open
    tiles are not re-cast), where two soups' previews may differ."""
    soup = r._get_soup()
    if soup is None:
        return 0
    res = trs.raster_cast(*soup, np.asarray(cam.pos, np.float32), cam.basis(),
                          r.world.height, r.width, r.height,
                          bins=r._get_soup_bins(cam, soup))
    return int(res["fb_need"].sum())


def _fresh_equal(r, space, cam, budget=0, preview=False):
    """r's next sample equals a Renderer built fresh on the edited world,
    same seeds, up to ``budget`` pixels; so does the preview, up to the
    rays either rasterized preview leaves unresolved."""
    r2 = tdrv.Renderer(space.serialize(), r.width, r.height,
                       max_bounces=r.max_bounces, fog_steps=r.fog_steps,
                       seed=5, device="cpu")
    r.host_rng.seed(77)
    r2.host_rng.seed(77)
    r.acc.invalidate()
    r.sample(cam, SUN)
    r2.sample(cam, SUN)
    bad = int((r.acc.buffer != r2.acc.buffer).any(-1).sum())
    assert bad <= budget, f"{bad} pixels diverge"
    assert float(r.acc.buffer.sum()) > 0
    if preview:
        a, b = r.preview_frame(cam, SUN), r2.preview_frame(cam, SUN)
        assert int((a != b).any(-1).sum()) <= budget + _unresolved(r, cam) \
            + _unresolved(r2, cam)
    return r2


def test_edit_session_keeps_hf_engine():
    """tests/test_incremental.py:214: a dig and a placed block keep the
    soup (patched) and the heightfield engine (with a bounds box); a
    fresh Renderer of the edited world has no exact heightmap, so it runs
    the SVO engine on the instance soup."""
    space, jspace = _worlds()
    cx, cz, top, cam = _site(space)
    r, jr = _pair_renderers(space, jspace)
    r.sample(cam, SUN)  # the soup exists before the edit: it is patched
    assert r._soup is not None
    edits = [(cx, top - 1, cz), (cx, top + 1, cz)]
    for s in (space, jspace):
        s.set(edits[0], None)
        s.set(edits[1], (1.0, 1.0, 1.0))
    r.apply_edits(space, edits=edits)
    jr.apply_edits(jspace, edits=edits)
    assert r.soup_world and r._soup is not None
    assert r._get_hf()[0] is not None and r._hf_bounds() is not None
    assert jr._get_hf()[0] is not None and jr._hf_bounds() is not None
    r2 = _fresh_equal(r, space, cam, budget=4, preview=True)
    assert r2._get_hf()[0] is None and r2.soup_world


def test_edit_bounds_cutoff_disables_hf():
    """tests/test_incremental.py:255: two distant floating blocks stay
    two boxes with the engine on; one batch spanning most of the world's
    edge turns the engine off."""
    space, jspace = _worlds()
    h0 = np.asarray(space.heights)
    r, jr = _pair_renderers(space, jspace, 16, 12)
    assert r._get_hf()[0] is not None
    red = (0.9, 0.2, 0.1)
    for p in ((5, min(int(h0[5, 5]) + 2, 62), 5),
              (60, min(int(h0[60, 60]) + 2, 62), 60)):
        _edit(r, jr, space, jspace, [p], red)
        assert r._get_hf()[0] is not None and r._hf_bounds() is not None
    assert len(r._edit_bounds) == 2
    wide = [(2, min(int(h0[2, 2]) + 2, 62), 2),
            (61, min(int(h0[61, 61]) + 2, 62), 61)]
    _edit(r, jr, space, jspace, wide, red)
    assert r._hf_bounds() is None and r._get_hf()[0] is None
    assert jr._get_hf()[0] is None


def test_top_voxel_edits_keep_pure_hf():
    """tests/test_hf_edit.py:76: top-voxel deletes and placements keep
    the heightmap exact, the pack patched, no bounds: the samples equal a
    fresh Renderer's bit for bit."""
    space, jspace = _worlds()
    cx, cz, top, cam = _site(space)
    r, jr = _pair_renderers(space, jspace)
    r.sample(cam, SUN)
    trgb = space.terrain_rgb
    _edit(r, jr, space, jspace, [(cx, top - 1, cz)], None)
    assert space.heights_exact and r._hf_bounds() is None
    assert int(space.heights[cx, cz]) == top - 1
    _edit(r, jr, space, jspace, [(cx, top - 3, cz), (cx, top - 2, cz)], None)
    assert int(space.heights[cx, cz]) == top - 3
    _edit(r, jr, space, jspace, [(cx, top - 3, cz), (cx, top - 2, cz)], trgb)
    assert int(space.heights[cx, cz]) == top - 1
    assert space.heights_exact and r._hf_bounds() is None
    assert r._get_hf()[0] is not None
    _fresh_equal(r, space, cam, preview=True)


@pytest.mark.parametrize("case", ["floating", "hole"])
def test_non_hf_edits_fall_to_bounds(case):
    """tests/test_hf_edit.py:125 and :157: a floating coloured block, or
    a hole under the top, is no heightfield: a bounds box, the engine
    kept; a later top-voxel delete stays on the bounds path."""
    space, jspace = _worlds()
    cx, cz, top, cam = _site(space)
    r, jr = _pair_renderers(space, jspace)
    if case == "floating":
        _edit(r, jr, space, jspace, [(cx, top + 3, cz)], (0.9, 0.1, 0.2))
    else:
        _edit(r, jr, space, jspace, [(cx, top - 3, cz)], None)
    assert not space.heights_exact and r._hf_bounds() is not None
    assert r._get_hf()[0] is not None
    _edit(r, jr, space, jspace, [(cx + 1, top - 1, cz)], None)
    assert not space.heights_exact and r._hf_bounds() is not None
    _fresh_equal(r, space, cam, budget=4)


def test_spread_out_session_keeps_hf():
    """tests/test_hf_edit.py:174: 30 distant blocks, one batch each: the
    list caps at EDIT_BOXES, the engine stays, radiance as fresh."""
    space, jspace = _worlds()
    h0 = np.asarray(space.heights)
    r, jr = _pair_renderers(space, jspace)
    rng = np.random.default_rng(11)
    for _ in range(30):
        x, z = int(rng.integers(2, 62)), int(rng.integers(2, 62))
        _edit(r, jr, space, jspace, [(x, min(int(h0[x, z]) + 2, 62), z)],
              (0.2, 0.4, 0.8))
    assert r._get_hf()[0] is not None and r._hf_bounds() is not None
    assert len(r._edit_bounds) <= r.EDIT_BOXES
    cam = tcam.Camera(pos=(20.0, float(h0.max()) + 8.0, 14.0), yaw=0.8,
                      pitch=0.35)
    _fresh_equal(r, space, cam, budget=8)


def test_hf_only_edit_patches_sky_pack(monkeypatch):
    """tests/test_hf_edit.py:199: in hf-only mode an exact edit patches
    the envelope's pyramid (equal to a rebuild), drops the pose's table,
    and the next preview equals a fresh Renderer's bit for bit."""
    from voxtracer_torch.kernels import skyline as tsky

    monkeypatch.setattr(tdrv.Renderer, "HF_FRAME_SIZE", 32)
    space, jspace = _worlds()
    cx, cz, top, cam = _site(space)
    r = tdrv.Renderer(space.serialize(), 48, 32, max_bounces=3, fog_steps=8,
                      seed=5, device="cpu")
    assert r.preview_frame(cam, SUN) is not None and r._sky_env is not None
    assert r._sky_mips is not None
    e = (cx, top - 1, cz)
    space.set(e, None)
    r.apply_edits(space, edits=[e])
    assert space.heights_exact and r._sky_mips is not None
    assert r._sky_env is None
    full = tsky.sky_levels_from_hf(*r._get_hf()[:2], 6)
    for a, b in zip(r._sky_mips["coarse"], full["coarse"]):
        assert torch.equal(a, b)
    img = r.preview_frame(cam, SUN)
    r2 = tdrv.Renderer(space.serialize(), 48, 32, max_bounces=3, fog_steps=8,
                       seed=5, device="cpu")
    assert torch.equal(img, r2.preview_frame(cam, SUN))


def test_hf_only_overhang_preview_env_resumed(monkeypatch):
    """tests/test_hf_edit.py:227: with a bounds-tracked block the hybrid
    preview's pre-edit walk resumes from the envelope, bit for bit the
    un-resumed preview; the placed block shows."""
    monkeypatch.setattr(tdrv.Renderer, "HF_FRAME_SIZE", 32)
    space, _ = _worlds()
    cx, cz, top, cam = _site(space)
    r = tdrv.Renderer(space.serialize(), 48, 32, max_bounces=3, fog_steps=8,
                      seed=5, device="cpu")
    e = (cx, top + 3, cz)
    space.set(e, (1.0, 1.0, 1.0))
    r.apply_edits(space, edits=[e])
    assert r._hf_bounds() is not None and r._get_sky_env(cam) is not None
    img_env = r.preview_frame(cam, SUN)
    monkeypatch.setattr(tdrv.Renderer, "_get_sky_env", lambda self, c: None)
    img_plain = r.preview_frame(cam, SUN)
    assert torch.equal(img_env, img_plain) and float(img_env.max()) > 0


def _native_terrain(mod, n, seed=0, edits=0):
    heights = np.random.default_rng(seed).integers(0, n + 1, (n, n))
    space = mod.NativeSvoSpace()
    space.build_terrain(heights.astype(np.uint32), rgb=(0.3, 0.55, 0.25))
    rng = np.random.default_rng(seed + 1)
    for _ in range(edits):
        p = tuple(int(c) for c in rng.integers(0, n, 3))
        if rng.random() < 0.4:
            space.set(p, None)
        else:
            space.set(p, tuple(np.round(rng.random(3), 2)))
    return space


def _rows(soup):
    rows = np.concatenate([soup.lo, soup.size, soup.leaf[:, None]], axis=1)
    return rows[np.lexsort(rows.T[::-1])]


@pytest.mark.skipif(not tnative.available(), reason="needs g++")
@pytest.mark.parametrize("n,edits,kw", [
    (16, 0, {}), (32, 40, {}), (64, 0, {}), (32, 0, dict(cull_enclosed=False)),
    (32, 0, dict(max_strip=4)), (32, 0, dict(max_size=4))])
def test_native_extractor_matches_python(n, edits, kw):
    """tests/test_boxes_native.py: the native extractor equals the
    port's Python pipeline box for box (compared as sorted rows), and
    JAX's extraction of the same C++ world."""
    dev = _native_terrain(tnative, n, seed=n, edits=edits).serialize()
    got = tboxes.extract_boxes(dev, **kw)
    py = tboxes.extract_boxes(dataclasses.replace(dev, space=None), **kw)
    want = jboxes.extract_boxes(
        _native_terrain(jnative, n, seed=n, edits=edits).serialize(), **kw)
    assert len(got) > 0
    assert np.array_equal(_rows(got), _rows(py))
    assert np.array_equal(_rows(got), _rows(want))
    assert np.array_equal(got.rgb[np.lexsort(got.lo.T)],
                          py.rgb[np.lexsort(py.lo.T)])


@pytest.mark.skipif(not tnative.available(), reason="needs g++")
def test_native_extractor_empty_world():
    assert len(tboxes.extract_boxes(tnative.NativeSvoSpace().serialize())) == 0
