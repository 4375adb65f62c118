"""Port vs JAX: terrain heights, the octree builder and the device upload
(voxtracer_torch/world against voxtracer/world)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.world import noise as jnoise
from voxtracer.world import worldgen as jgen
from voxtracer.world.svo import from_dense
from voxtracer_torch.world import noise as tnoise
from voxtracer_torch.world import svo as tsvo
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)


def test_noise_matches(rng):
    x = (rng.random(4096, np.float32) * 200 - 100).astype(np.float32)
    y = (rng.random(4096, np.float32) * 200 - 100).astype(np.float32)
    assert np.array_equal(
        np.asarray(jnoise.simplex2(jnp.asarray(x), jnp.asarray(y), 7)),
        tnoise.simplex2(torch.from_numpy(x), torch.from_numpy(y), 7).numpy())
    # XLA fuses the fBm octave sum into FMAs: last-place differences only
    want = np.asarray(jnoise.fbm2(jnp.asarray(x), jnp.asarray(y), seed=3))
    got = tnoise.fbm2(torch.from_numpy(x), torch.from_numpy(y), seed=3).numpy()
    assert np.abs(want - got).max() <= 4e-7


@pytest.mark.parametrize("log2", [6, 8])
def test_heights_equal(log2):
    """Equal column heights; the contract allows at most 0.1% of columns
    off by 1 (a last-place noise difference at a floor() boundary), and
    none is off at these sizes."""
    want = jgen.heightmap(log2)
    got = tgen.heightmap(log2, device="cpu")
    assert got.dtype == np.uint32 and got.shape == want.shape
    off = want.astype(np.int64) - got
    assert np.abs(off).max() <= 1
    assert (off != 0).mean() <= 1e-3
    assert (off == 0).all()


def test_build_octree_node_identical():
    h = jgen.heightmap(7)
    want = jgen.build_octree(*jgen.minmax_pyramid(h)).serialize()
    got = tgen.build_octree(*tgen.minmax_pyramid(h)).serialize()
    assert np.array_equal(want.table, got.table)
    assert (want.root, want.height) == (got.root, got.height)


def test_generate_matches_jax_python_builder():
    want = jgen.generate(log2_size=6, verbose=False, backend="python")
    got = tgen.generate(log2_size=6, verbose=False, backend="python",
                        device="cpu")
    assert np.array_equal(want.serialize().table, got.serialize().table)


def test_upload_of_jax_world_equals_own_table():
    space = jgen.generate(log2_size=5, verbose=False, backend="python")
    jdev = space.serialize()
    tdev = tgen.generate(log2_size=5, verbose=False, backend="python",
                        device="cpu").serialize()
    a = tsvo.upload(jdev.table, jdev.root, jdev.height, "cpu")
    b = tsvo.upload(tdev.table, tdev.root, tdev.height, "cpu")
    assert a.table.dtype == torch.int32 and a.table.shape == (len(jdev.table), 8)
    assert torch.equal(a.table, b.table)
    assert (a.root, a.height) == (b.root, b.height) == (jdev.root, jdev.height)
    assert int((a.table == -1).sum()) == int((jdev.table == tsvo.EMPTY).sum())


def test_upload_empty_world_root():
    dev = from_dense(np.zeros((4, 4, 4), bool),
                     np.zeros((4, 4, 4, 3), np.float32)).serialize()
    assert dev.root == tsvo.EMPTY
    assert tsvo.upload(dev.table, dev.root, 2, "cpu").root == -1


def test_point_edits_match_jax_space():
    """The port's SvoSpace copy: path-copying set/get as the JAX space."""
    from voxtracer.world.svo import SvoSpace as JSpace

    spaces = [JSpace(), tsvo.SvoSpace()]
    for sp in spaces:
        leaf = sp.create_block((0.5, 0.5, 0.5))
        sp.set_root(sp.create_children([leaf] * 8))
    edits = [((0, 0, 0), None), ((1, 1, 0), (1.0, 1.0, 1.0)),
             ((1, 1, 0), (1.0, 1.0, 1.0)), ((0, 1, 1), None)]
    for p, rgb in edits:
        for sp in spaces:
            sp.set(p, rgb)
    a, b = (sp.serialize() for sp in spaces)
    assert np.array_equal(a.table, b.table) and a.root == b.root
    assert spaces[1].get((1, 1, 0)) == (1.0, 1.0, 1.0)
    assert spaces[1].get((0, 0, 0)) is None
    with pytest.raises(ValueError):
        spaces[1].set((2, 0, 0), None)
