"""Port: the native (C++) SVO builder through the port's own ctypes
loader (voxtracer_torch/world/native.py), against the port's Python
builder and the JAX package's ``NativeSvoSpace``.

Contracts. Native against Python builder: the same octree node for node
(the slot numbering differs, so the tables are compared after numbering
the reachable nodes depth first from the root). Native against the JAX
package's native space (one C++ source, two loaders): the serialized
tables bitwise equal. Needs g++; skips without it.
"""

import numpy as np
import pytest
import torch

from voxtracer.world import native as jnative
from voxtracer.world import worldgen as jgen
from voxtracer_torch.kernels import traverse as ttr
from voxtracer_torch.world import boxes as tboxes
from voxtracer_torch.world import native as tnative
from voxtracer_torch.world import svo as tsvo
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def have_native():
    if not tnative.available():
        pytest.skip("needs g++ to build native/svo_native.cpp")


def _canonical(dev):
    """The tree reachable from the root as a table whose slots are
    numbered depth first in child order; leaves keep their colour bits."""
    table = np.asarray(dev.table).view(np.uint32)
    if dev.root == tsvo.EMPTY:
        return np.zeros((0, 8), np.uint32)
    index, rows = {}, []

    def visit(slot, level):
        key = (slot, level)
        if key in index:
            return index[key]
        index[key] = len(rows)
        rows.append(None)
        me = index[key]
        if level == 0:
            rows[me] = table[slot].copy()
        else:
            rows[me] = np.array(
                [tsvo.EMPTY if c == tsvo.EMPTY else visit(int(c), level - 1)
                 for c in table[slot]], np.uint32)
        return me

    visit(int(dev.root), dev.height)
    return np.stack(rows)


@pytest.mark.parametrize("log2", [5, 6, 7])
def test_native_builder_is_node_identical_to_python(have_native, log2):
    py = tgen.generate(log2, verbose=False, backend="python", device="cpu")
    nat = tgen.generate(log2, verbose=False, backend="native", device="cpu")
    assert isinstance(nat, tnative.NativeSvoSpace)
    assert np.array_equal(py.heights, nat.heights)
    assert nat.heights_exact and nat.terrain_rgb == py.terrain_rgb
    a, b = py.serialize(), nat.serialize()
    assert (a.height, b.height) == (log2, log2)
    assert np.array_equal(_canonical(a), _canonical(b))
    # every node of either table is reachable or a spare solid cube
    assert abs(py.num_nodes() - nat.num_nodes()) <= log2
    assert nat.capacity() == len(b.table) and nat.mem_usage() > 0
    assert b.space is nat


@pytest.mark.parametrize("log2", [5, 7])
def test_native_table_equals_the_jax_loader(have_native, log2):
    if not jnative.available():
        pytest.skip("the JAX package's native library is unavailable")
    h = jgen.heightmap(log2)
    want = jnative.NativeSvoSpace()
    want.build_terrain(h)
    got = tnative.NativeSvoSpace()
    got.build_terrain(h)
    a, b = want.serialize(), got.serialize()
    assert np.array_equal(a.table, b.table)
    assert (a.root, a.height) == (b.root, b.height)
    for sp in (want, got):
        sp.set((3, 20, 5), (1.0, 0.5, 0.25))
        sp.set((3, 0, 5), None)
    a, b = want.serialize(), got.serialize()
    assert np.array_equal(a.table, b.table) and a.root == b.root


def test_native_point_queries_and_edits(have_native):
    space = tgen.generate(5, verbose=False, backend="native", device="cpu")
    x, z = (int(v) for v in np.argwhere(space.heights >= 2)[0])
    top = int(space.heights[x, z])
    assert space.get((x, top - 1, z)) == (0.5, 0.5, 0.5)
    assert space.get((x, top, z)) is None
    assert space.leaf_at((x, top, z)) is None
    leaf = space.leaf_at((x, 0, z))
    dev = space.serialize()
    assert leaf == tboxes.terrain_leaf_id(dev)
    assert np.array_equal(dev.table[leaf, :3].view(np.float32),
                          np.float32([0.5, 0.5, 0.5]))
    space.set((x, top, z), (1.0, 1.0, 1.0))
    assert space.get((x, top, z)) == (1.0, 1.0, 1.0)
    assert space.heights_exact is False
    space.set((x, top, z), None)
    assert space.get((x, top, z)) is None
    with pytest.raises(ValueError):
        space.set((32, 0, 0), None)
    assert space.root is not None and space.height() == 5


def test_native_world_casts_like_the_python_world(have_native, rng):
    py = tgen.generate(6, verbose=False, backend="python",
                       device="cpu").serialize()
    nat = tgen.generate(6, verbose=False, backend="native",
                        device="cpu").serialize()
    start = torch.from_numpy(
        (rng.random((2048, 3)) * 80 - 8).astype(np.float32))
    d = rng.normal(size=(2048, 3)).astype(np.float32)
    d = torch.from_numpy(d / np.linalg.norm(d, axis=-1, keepdims=True))
    out = []
    for dev in (py, nat):
        w = tsvo.upload(dev.table, dev.root, dev.height, "cpu")
        r = ttr.svo_raycast(w.table, w.root, w.height, start, d)
        out.append((r, ttr.leaf_rgb(w.table, r["node"])))
    for k in ("hit", "t", "normal", "voxel"):
        assert torch.equal(out[0][0][k], out[1][0][k]), k
    assert torch.equal(out[0][1], out[1][1]) and out[0][0]["hit"].any()


def test_generate_backends(have_native):
    assert isinstance(tgen.generate(5, verbose=False, device="cpu"),
                      tnative.NativeSvoSpace)  # auto takes the native one
    assert isinstance(tgen.generate(5, verbose=False, backend="python",
                                    device="cpu"), tsvo.SvoSpace)
    with pytest.raises(ValueError, match="backend"):
        tgen.generate(5, verbose=False, backend="rust", device="cpu")
    with pytest.raises(ValueError, match="power of two"):
        tnative.NativeSvoSpace().build_terrain(np.zeros((6, 6), np.uint32))


def test_no_compiler_raises_and_auto_takes_python(monkeypatch, tmp_path):
    """Asking for the native builder without g++ raises; nothing is
    loaded from anywhere else. ``auto`` then builds with Python."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(tnative.shutil, "which", lambda name: None)
    assert not tnative.available()
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tgen.generate(5, verbose=False, backend="native", device="cpu")
    assert isinstance(tgen.generate(5, verbose=False, device="cpu"),
                      tsvo.SvoSpace)
    assert not list(tmp_path.iterdir())
