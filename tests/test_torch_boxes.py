"""Port vs JAX: the terrain box soup (voxtracer_torch/world/boxes.py
against voxtracer/world/boxes.py), the heightmap that worldgen keeps on
the space, the instance soup of worlds that are not unedited terrain,
and the worlds that have no soup."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch

from voxtracer.world import boxes as jboxes
from voxtracer.world import worldgen as jgen
from voxtracer.world.svo import from_dense
from voxtracer_torch.world import boxes as tboxes
from voxtracer_torch.world import worldgen as tgen

torch.set_num_threads(2)


@pytest.mark.parametrize("log2", [6, 8])
def test_extract_boxes_terrain_equals_jax(log2):
    heights = jgen.heightmap(log2)
    rgb = np.float32([0.5, 0.5, 0.5])
    want = jboxes.extract_boxes_terrain(heights, 3, rgb)
    got = tboxes.extract_boxes_terrain(heights, 3, rgb)
    assert len(got) == len(want) > 0 and got.height == want.height == log2
    for f in ("lo", "size", "leaf", "rgb"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype and np.array_equal(a, b), f


def test_extract_boxes_of_generated_worlds_equal():
    """The port's world and the JAX package's, each through its own
    extract_boxes: the same soup and the same terrain leaf slot."""
    tdev = tgen.generate(log2_size=6, verbose=False, device="cpu").serialize()
    jdev = jgen.generate(log2_size=6, verbose=False,
                         backend="python").serialize()
    assert tboxes.terrain_leaf_id(tdev) == jboxes.terrain_leaf_id(jdev)
    assert tboxes.terrain_leaf_id(jdev) == jboxes.terrain_leaf_id(jdev)
    got, want = tboxes.extract_boxes(tdev), jboxes.extract_boxes(jdev)
    for f in ("lo", "size", "leaf", "rgb"):
        assert np.array_equal(getattr(got, f), getattr(want, f)), f


def test_generate_keeps_heights_and_backref():
    space = tgen.generate(log2_size=5, verbose=False, device="cpu")
    assert np.array_equal(space.heights, jgen.heightmap(5))
    assert space.heights.dtype == np.uint32
    assert space.terrain_rgb == (0.5, 0.5, 0.5) and space.heights_exact
    dev = space.serialize()
    assert dev.space is space
    assert tboxes.terrain_heights(dev) is space.heights


def test_worlds_without_soup_raise():
    """An edited world and a from_dense world carry no exact heightmap
    (terrain_heights says so up front): their soup is the octree's
    instances, the JAX package's box for box. A table without solid
    leaves (a checkpoint's) has no soup: extract_boxes raises."""
    space = tgen.generate(log2_size=5, verbose=False, device="cpu")
    space.set((3, 30, 3), (1.0, 1.0, 1.0))
    rng = np.random.default_rng(5)
    solid = rng.random((16, 16, 16)) < 0.2
    dense = from_dense(solid, np.full((16, 16, 16, 3), 0.5, np.float32))
    for dev in (space.serialize(), dense.serialize()):
        assert tboxes.terrain_heights(dev) is None
        got, want = tboxes.extract_boxes(dev), jboxes.extract_boxes(dev)
        assert len(got) > 0
        for f in ("lo", "size", "leaf", "rgb"):
            assert np.array_equal(getattr(got, f), getattr(want, f)), f
        bare = SimpleNamespace(table=dev.table, root=dev.root,
                               height=dev.height)
        with pytest.raises(ValueError):
            tboxes.extract_boxes(bare)
