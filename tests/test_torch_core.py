"""Port vs JAX: camera, sampling, spectra and colour (voxtracer_torch/core
against voxtracer/core), from the same numpy inputs.

Tolerances, in ulp of 1.0 (ULP1 = 2^-23) for unit vectors: XLA fuses
``a*b + c`` into one FMA on the CPU and its sin/cos/exp differ from
PyTorch's in the last place, while the port rounds every op on its own
(as the CUDA kernels do, built with --fmad=false). RNG states and every
integer output are equal bit for bit.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import camera as jcam
from voxtracer.core import color as jcolor
from voxtracer.core import sampling as jsamp
from voxtracer.core import spectra as jspec
from voxtracer_torch.core import camera as tcam
from voxtracer_torch.core import color as tcolor
from voxtracer_torch.core import rng as trng
from voxtracer_torch.core import sampling as tsamp
from voxtracer_torch.core import spectra as tspec
from voxtracer_torch.core import vecmath as tvec

torch.set_num_threads(2)
ULP1 = float(np.spacing(np.float32(1.0)))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_camera_rays_within_2ulp():
    cam = tcam.DEFAULT_POSE
    jc = jcam.Camera(pos=cam.pos, yaw=cam.yaw, pitch=cam.pitch)
    assert np.array_equal(np.asarray(jc.basis()), cam.basis().numpy())
    py, px = np.meshgrid(np.arange(48, dtype=np.int32),
                         np.arange(85, dtype=np.int32), indexing="ij")
    ld_j = jcam.pixel_ndc(jnp.asarray(px), jnp.asarray(py), 85, 48)
    ld_t = tcam.pixel_ndc(torch.from_numpy(px), torch.from_numpy(py), 85, 48)
    assert np.array_equal(np.asarray(ld_j), ld_t.numpy())
    jitter = np.random.default_rng(3).random((48, 85, 2), np.float32)
    d_j = jcam.ray_directions(jc.basis(), ld_j, jitter=jnp.asarray(jitter),
                              height=48)
    d_t = tcam.ray_directions(cam.basis(), ld_t,
                              jitter=torch.from_numpy(jitter), height=48)
    assert np.abs(np.asarray(d_j) - d_t.numpy()).max() <= 2 * ULP1
    o_j, g_j = jcam.generate_rays(jc, 85, 48)
    o_t, g_t = tcam.generate_rays(cam, 85, 48)
    assert np.array_equal(np.asarray(o_j), o_t.numpy())
    assert np.abs(np.asarray(g_j) - g_t.numpy()).max() <= 2 * ULP1


def test_vecmath_matches(rng):
    a, b = _unit(rng, 512), _unit(rng, 512)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    assert np.abs(tvec.dot(ta, tb).numpy() - (a * b).sum(-1)).max() <= 2 * ULP1
    assert np.abs(tvec.cross(ta, tb).numpy() - np.cross(a, b)).max() \
        <= 2 * ULP1
    assert np.array_equal(tvec.to_bits(ta < 0).numpy(),
                          (a[:, 0] < 0) | (a[:, 1] < 0) << 1
                          | (a[:, 2] < 0) << 2)
    x = torch.tensor([3.0, 7.0, 1e-3])
    assert torch.equal(tvec.div(x, 3.0), x / torch.tensor(3.0))
    assert torch.equal(tvec.rdiv(3.0, x), torch.tensor(3.0) / x)


def test_sample_sun_within_2ulp(rng):
    st = rng.integers(0, 2**32, (4096, 3), dtype=np.uint32)
    sun = _unit(rng, 1)[0]
    s_j, d_j = jsamp.sample_sun(jnp.asarray(st), jnp.asarray(sun))
    s_t, d_t = tsamp.sample_sun(trng.to_state(st), torch.from_numpy(sun))
    assert np.array_equal(np.asarray(s_j).astype(np.int64), s_t.numpy())
    assert np.abs(np.asarray(d_j) - d_t.numpy()).max() <= 2 * ULP1


def test_cos_hemisphere_within_tolerance(rng):
    """Same draws; directions within 2 ulp on >= 97% of components. The
    rest come from the two amplifiers in the sampler: normalize(cross(r,
    n)) when r is nearly parallel to n, and sqrt(1 - |disk|^2) near the
    disk's rim; they stay under 64 ulp of 1."""
    st = rng.integers(0, 2**32, (4096, 3), dtype=np.uint32)
    n = _unit(rng, 4096)
    s_j, d_j = jsamp.cos_hemisphere(jnp.asarray(st), jnp.asarray(n))
    s_t, d_t = tsamp.cos_hemisphere(trng.to_state(st), torch.from_numpy(n))
    assert np.array_equal(np.asarray(s_j).astype(np.int64), s_t.numpy())
    diff = np.abs(np.asarray(d_j) - d_t.numpy())
    assert (diff > 2 * ULP1).mean() < 0.03
    assert diff.max() <= 64 * ULP1


def test_lut_and_fog_density_equal(rng):
    for size in (256, 2048):
        assert np.array_equal(jspec.build_wl_to_rgb_lut(size),
                              tspec.build_wl_to_rgb_lut(size))
    lut = jspec.build_wl_to_rgb_lut(256)
    wl = rng.random(8192, np.float32)
    assert np.array_equal(
        np.asarray(jspec.sample_lut(jnp.asarray(lut), jnp.asarray(wl))),
        tspec.sample_lut(torch.from_numpy(lut), torch.from_numpy(wl)).numpy())
    want = np.asarray(jspec.fog_density(jnp.asarray(wl)))
    got = tspec.fog_density(torch.from_numpy(wl)).numpy()
    assert np.isfinite(got).all()
    assert (np.abs(want - got) <= 2 * np.spacing(want)).all()


def test_spectral_throughput_within_2ulp_of_exp(rng):
    """1/((w+1)^3 (e^x - 1)), x = 0.1/(w+1): one ulp of difference in
    e^x between XLA and PyTorch is amplified by e^x/(e^x - 1) (11-21x)
    in the subtraction, so the bound is 2 ulp of e^x carried through it."""
    lut = jspec.build_wl_to_rgb_lut(256)
    wl = rng.random(8192, np.float32)
    want = np.asarray(jspec.spectral_throughput(jnp.asarray(lut),
                                                jnp.asarray(wl)))
    got = tspec.spectral_throughput(torch.from_numpy(lut),
                                    torch.from_numpy(wl)).numpy()
    ex = np.exp(0.1 / (wl.astype(np.float64) + 1.0))
    rtol = 2 * ULP1 * ex / (ex - 1.0) + 4 * ULP1
    assert (np.abs(want - got) <= rtol[:, None] * np.abs(want) + 1e-30).all()


@pytest.mark.parametrize("fn", ["srgb_encode", "tonemap_to_u8"])
def test_color_matches(fn, rng):
    x = (rng.random((64, 3), np.float32) * 1.2).astype(np.float32)
    want = np.asarray(getattr(jcolor, fn)(jnp.asarray(x)))
    got = getattr(tcolor, fn)(torch.from_numpy(x)).numpy()
    if fn == "tonemap_to_u8":
        assert np.array_equal(want, got)
    else:
        assert np.abs(want - got).max() <= 2 * ULP1


def test_sqrt_correctly_rounded(rng):
    """``vecmath.sqrt`` is the correctly rounded float32 root (the JAX
    package's ``jnp.sqrt``, and the card's) on every CPU build; some CPU
    builds of torch return a float32 ``torch.sqrt`` one ulp off in about
    one lane in six. The float64 root rounded once is the reference."""
    x = np.concatenate([rng.random(20000, np.float32) * np.float32(10),
                        rng.random(20000, np.float32) * np.float32(3e4),
                        np.float32([0.0, 1.0, 4.0, 2.0, 1e-30, 3.4e38])])
    want = np.sqrt(x.astype(np.float64)).astype(np.float32)
    got = tvec.sqrt(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    assert np.array_equal(got.view(np.uint32), want.view(np.uint32))
    assert np.array_equal(got, np.asarray(jnp.sqrt(jnp.asarray(x))))
