"""Port vs JAX: the planet/fog cast (voxtracer_torch/kernels/atmosphere.py
on the plain version of kernel K1 against voxtracer/kernels/atmosphere.py,
with backend="jnp" and with backend="pallas" in interpret mode).

State and hit must be equal; t and normal are held to the bounds of
tests/test_pallas_fog.py: a scatter point may drift by about one march
segment when a last-place difference in exp() (XLA's vs PyTorch's)
accumulates through the free-path consumption.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

from voxtracer.kernels import atmosphere as jatm
from voxtracer_torch.core import rng as trng
from voxtracer_torch.kernels import atmosphere as tatm
from voxtracer_torch.kernels import fog as tfog

torch.set_num_threads(2)


@pytest.fixture
def interpret_pallas(monkeypatch):
    orig = pl.pallas_call
    monkeypatch.setattr(
        pl, "pallas_call", lambda *a, **k: orig(*a, **{**k, "interpret": True})
    )


def _inputs(rng, B):
    state = rng.integers(0, 2**32, (B, 3), dtype=np.uint32)
    start = rng.random((B, 3), np.float32) * 1000
    d = rng.normal(size=(B, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=-1, keepdims=True)
    dens = np.full((B,), 5e-5, np.float32)
    return state, start, d, dens


def _compare(r1, s1, s2, r2, n_steps):
    assert np.array_equal(np.asarray(s1).astype(np.int64), s2.numpy())
    assert np.array_equal(np.asarray(r1["hit"]), r2["hit"].numpy())
    assert np.allclose(np.asarray(r1["rgba"]), r2["rgba"].numpy())
    t1, t2 = np.asarray(r1["t"]), r2["t"].numpy()
    seg = 1.35e6 / n_steps
    assert np.abs(t1 - t2).max() < 1.5 * seg
    hits = np.asarray(r1["hit"])
    close = np.abs(t1 - t2)[hits] / np.maximum(t1[hits], 1.0)
    assert np.quantile(close, 0.95) < 0.01
    assert np.allclose(np.asarray(r1["normal"]), r2["normal"].numpy(),
                       atol=1e-4)


@pytest.mark.parametrize("backend", ["jnp", "pallas"])
def test_raycast_planet_matches_jax(backend, rng, request):
    if backend == "pallas":
        request.getfixturevalue("interpret_pallas")
    state, start, d, dens = _inputs(rng, 2048)
    s1, r1 = jatm.raycast_planet(jnp.asarray(state), jnp.asarray(start),
                                 jnp.asarray(d), jnp.asarray(dens),
                                 n_steps=32, backend=backend)
    s2, r2 = tatm.raycast_planet(trng.to_state(state), torch.from_numpy(start),
                                 torch.from_numpy(d), torch.from_numpy(dens),
                                 n_steps=32)
    _compare(r1, s1, s2, r2, 32)
    assert r2["hit"].any() and not r2["hit"].all()


def test_fog_march_ragged_sizes(rng):
    """Batches that fill no tile round-trip (tests/test_pallas_fog.py:52)."""
    for B in (1, 100, 1000):
        start = torch.from_numpy(rng.random((B, 3), np.float32) * 100)
        d = torch.zeros((B, 3))
        d[:, 1] = 1.0
        code, t = tfog.fog_march(start, d, torch.zeros(B), torch.ones(B),
                                 n_steps=8)
        assert code.shape == (B,) and t.shape == (B,)
        assert code.dtype == torch.int32 and (code == 0).all()


@pytest.mark.parametrize("B,steps", [(1, 8), (100, 16), (1000, 64)])
def test_fog_march_plain_active_masks_lanes(rng, B, steps):
    """With a lane mask, the plain march equals the unmasked march on the
    active lanes and gives code 0 and t 0.0 on the others."""
    _, start, d, _ = _inputs(rng, B)
    dens = rng.random(B, np.float32) * 1e-4
    y0 = -np.log(1 - rng.random(B, np.float32)).astype(np.float32)
    args = [torch.from_numpy(a) for a in (start, d, dens, y0)]
    active = torch.from_numpy(rng.random(B) < 0.5)
    code, t = tfog.fog_march(*args, n_steps=steps)
    code_m, t_m = tfog.fog_march(*args, n_steps=steps, active=active)
    assert code_m.dtype == torch.int32 and t_m.dtype == torch.float32
    assert torch.equal(code_m[active], code[active])
    assert torch.equal(t_m[active], t[active])
    assert (code_m[~active] == 0).all()
    assert (t_m[~active] == 0.0).all() and not t_m[~active].signbit().any()


def test_raycast_planet_active_masks_march_not_draws(rng):
    """Masked raycast_planet: the same state as unmasked (every lane draws
    its 3 values), the unmasked result on active lanes, misses elsewhere."""
    state, start, d, dens = _inputs(rng, 2048)
    args = (torch.from_numpy(start), torch.from_numpy(d),
            torch.from_numpy(dens))
    active = torch.from_numpy(rng.random(2048) < 0.3)
    s1, r1 = tatm.raycast_planet(trng.to_state(state), *args, n_steps=32)
    s2, r2 = tatm.raycast_planet(trng.to_state(state), *args, n_steps=32,
                                 active=active)
    assert torch.equal(s1, s2)
    for key in ("hit", "t", "rgba", "normal"):
        assert torch.equal(r2[key][active], r1[key][active]), key
    assert not r2["hit"][~active].any() and (r2["t"][~active] == 0).all()
    assert r1["hit"][~active].any()  # the mask hid real hits


def test_fog_march_codes_match_pallas(rng, interpret_pallas):
    from voxtracer.kernels.pallas.fog import fog_march

    B = 1000
    _, start, d, _ = _inputs(rng, B)
    dens = rng.random(B, np.float32) * 1e-4
    y0 = -np.log(1 - rng.random(B, np.float32)).astype(np.float32)
    c1, t1 = fog_march(jnp.asarray(start), jnp.asarray(d), jnp.asarray(dens),
                       jnp.asarray(y0), n_steps=16)
    c2, t2 = tfog.fog_march(*(torch.from_numpy(a) for a in (start, d, dens, y0)),
                            n_steps=16)
    assert np.array_equal(np.asarray(c1), c2.numpy())
    assert np.abs(np.asarray(t1) - t2.numpy()).max() < 1.5 * 1.35e6 / 16


def test_planet_surface_hit():
    start = torch.tensor([[0.0, 1000.0, 0.0]])
    d = torch.tensor([[0.0, -1.0, 0.0]])
    _, r = tatm.raycast_planet(torch.tensor([[1, 2, 3]]), start, d,
                               torch.tensor([0.0]), n_steps=8)
    assert bool(r["hit"][0]) and abs(float(r["t"][0]) - 1000.0) < 1.0
    assert np.allclose(r["rgba"][0].numpy(), [0.25, 0.25, 0.25, 0.0])
    assert np.allclose(r["normal"][0].numpy(), [0, 1, 0], atol=1e-4)


def test_transmittance_to_escape_matches_jax():
    start = np.array([[0.0, 100.0, 0.0], [0.0, 500.0, 0.0], [0.0, 10.0, 0.0]],
                     np.float32)
    d = np.array([[0.0, 0.2, 0.9797959], [0.6, 0.1, 0.7937254],
                  [0.0, -1.0, 0.0]], np.float32)
    dens = np.array([3e-5, 5e-5, 5e-5], np.float32)
    want = np.asarray(jatm.transmittance_to_escape(
        jnp.asarray(start), jnp.asarray(d), jnp.asarray(dens), n_steps=512))
    got = tatm.transmittance_to_escape(
        torch.from_numpy(start), torch.from_numpy(d), torch.from_numpy(dens),
        n_steps=512).numpy()
    assert got[2] == 0.0  # straight down: the planet
    assert np.allclose(want, got, rtol=1e-5, atol=1e-6)


def test_scatter_rate_matches_transmittance(rng):
    """Monte-Carlo scatter rate ~= 1 - analytic escape probability."""
    n = 4096
    start = torch.tensor([0.0, 100.0, 0.0]).expand(n, 3)
    d = torch.tensor([0.0, 0.2, 0.9797958971]).expand(n, 3)
    dens = torch.full((n,), 3.0e-5)
    state = trng.to_state(rng.integers(0, 2**32, (n, 3), dtype=np.uint32))
    _, r = tatm.raycast_planet(state, start, d, dens, n_steps=64)
    escape = float(tatm.transmittance_to_escape(start[:1], d[:1], dens[:1],
                                                n_steps=2048)[0])
    assert abs(float(r["hit"].float().mean()) - (1.0 - escape)) < 0.03
