"""Port vs JAX: the pcg3d RNG (voxtracer_torch/core/rng.py against
voxtracer/core/rng.py). States and draws must be equal bit for bit."""

import random

import jax.numpy as jnp
import numpy as np
import torch

from voxtracer.core import rng as jrng
from voxtracer_torch.core import rng as trng

torch.set_num_threads(2)


def _states(rng, n):
    near_top = (2**32 - 1 - rng.integers(0, 1 << 20, (n, 3))).astype(np.uint32)
    edges = np.array([[0, 0, 0], [2**32 - 1] * 3, [1, 2**31, 2**31 - 1]],
                     np.uint32)
    rand = rng.integers(0, 2**32, (n, 3), dtype=np.uint32)
    return np.concatenate([edges, near_top, rand])


def test_pcg3d_and_random3_bit_equal(rng):
    st = _states(rng, 4096)
    js, ts = jnp.asarray(st), trng.to_state(st)
    for _ in range(5):  # chained steps stay equal
        js, jf = jrng.random3(js)
        ts, tf = trng.random3(ts)
        assert np.array_equal(np.asarray(js).astype(np.int64), ts.numpy())
        assert np.array_equal(np.asarray(jf), tf.numpy())
    assert ts.dtype == torch.int64 and int(ts.min()) >= 0 \
        and int(ts.max()) < 2**32


def test_seed_pixels_bit_equal():
    seed = np.array([101, 202, 2**32 - 7], np.uint32)
    py, px = np.meshgrid(np.arange(37, dtype=np.int32),
                         np.arange(53, dtype=np.int32), indexing="ij")
    want = jrng.seed_pixels(seed, jnp.asarray(px), jnp.asarray(py))
    got = trng.seed_pixels(seed, torch.from_numpy(px), torch.from_numpy(py))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())


def test_host_frame_seed_equal():
    a, b = random.Random(5), random.Random(5)
    for _ in range(3):
        assert np.array_equal(jrng.host_frame_seed(a), trng.host_frame_seed(b))
