"""Port vs JAX: the small public helpers of core/, world/svo.py and
utils/profiling.py that the main path does not call (uniform hemisphere
sampling and the two pdfs, the CIE LUT, the sRGB decode, vdot/length/
vec3, the SVO node accessors, ``timed``), from the same seeded numpy
inputs.

Tolerances, in ulp of 1.0 (ULP1 = 2^-23) as in tests/test_torch_core.py:
XLA fuses ``a*b + c`` into one FMA on the CPU and its sin/cos differ
from PyTorch's in the last place; RNG states, LUTs, node ids and leaf
colours are equal bit for bit.
"""

import re

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from voxtracer.core import color as jcolor
from voxtracer.core import sampling as jsamp
from voxtracer.core import spectra as jspec
from voxtracer.core import vecmath as jvec
from voxtracer.utils import profiling as jprof
from voxtracer.world import svo as jsvo
from voxtracer_torch.core import color as tcolor
from voxtracer_torch.core import rng as trng
from voxtracer_torch.core import sampling as tsamp
from voxtracer_torch.core import spectra as tspec
from voxtracer_torch.core import vecmath as tvec
from voxtracer_torch.utils import profiling as tprof
from voxtracer_torch.world import svo as tsvo

torch.set_num_threads(2)
ULP1 = float(np.spacing(np.float32(1.0)))


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return v / np.linalg.norm(v, axis=-1, keepdims=True)


def test_uniform_hemisphere_within_tolerance(rng):
    """Same draws; directions within 2 ulp on >= 97% of components, all
    within 64 ulp: the sampler has cos_hemisphere's amplifier,
    normalize(cross(r, n)) when r is nearly parallel to n."""
    st = rng.integers(0, 2**32, (4096, 3), dtype=np.uint32)
    n = _unit(rng, 4096)
    s_j, d_j = jsamp.uniform_hemisphere(jnp.asarray(st), jnp.asarray(n))
    s_t, d_t = tsamp.uniform_hemisphere(trng.to_state(st),
                                        torch.from_numpy(n))
    assert np.array_equal(np.asarray(s_j).astype(np.int64), s_t.numpy())
    diff = np.abs(np.asarray(d_j) - d_t.numpy())
    assert (diff > 2 * ULP1).mean() < 0.03
    assert diff.max() <= 64 * ULP1
    # a unit direction in the hemisphere of n
    d = d_t.numpy().astype(np.float64)
    assert np.abs(np.linalg.norm(d, axis=-1) - 1.0).max() < 1e-5
    assert ((d * n).sum(-1) >= -1e-6).all()


def test_cos_hemisphere_pdf_within_2ulp(rng):
    n, d = _unit(rng, 4096), _unit(rng, 4096)
    want = np.asarray(jsamp.cos_hemisphere_pdf(jnp.asarray(n),
                                               jnp.asarray(d)))
    got = tsamp.cos_hemisphere_pdf(torch.from_numpy(n),
                                   torch.from_numpy(d)).numpy()
    assert got.dtype == np.float32 and got.shape == (4096,)
    assert np.abs(want - got).max() <= 2 * ULP1
    assert (got[(n * d).sum(-1) < -4 * ULP1] == 0).all()


def _cone_edge_dirs(sun, n):
    """Unit directions at angles from ``sun`` that straddle the sun
    cone's edge: (1 +- 1e-2) of its angular radius, alternately (a few
    ulp of COS_SUN_RADIUS inside and outside)."""
    a = np.cross(sun, [0.0, 0.0, 1.0])
    a /= np.linalg.norm(a)
    b = np.cross(sun, a)
    phi = np.linspace(0.0, 2 * np.pi, n, endpoint=False)
    th = jsamp.SUN_ANGULAR_RADIUS * np.where(np.arange(n) % 2, 1 + 1e-2,
                                             1 - 1e-2)
    d = (np.cos(th)[:, None] * sun + np.sin(th)[:, None]
         * (np.cos(phi)[:, None] * a + np.sin(phi)[:, None] * b))
    return d.astype(np.float32)


def test_sun_pdf_equal_off_the_cone_edge(rng):
    """Equal by bits on every lane whose dot(d, sun) is more than 2 ulp
    from COS_SUN_RADIUS (there the FMA of XLA's dot may decide the other
    side). Directions from sample_sun, random ones, and ones straddling
    the edge, so both values occur."""
    sun = _unit(rng, 1)[0]
    st = rng.integers(0, 2**32, (2048, 3), dtype=np.uint32)
    _, d_sun = tsamp.sample_sun(trng.to_state(st), torch.from_numpy(sun))
    d = np.concatenate([d_sun.numpy(), _unit(rng, 2048),
                        _cone_edge_dirs(sun.astype(np.float64), 512)])
    want = np.asarray(jsamp.sun_pdf(jnp.asarray(d), jnp.asarray(sun)))
    got = tsamp.sun_pdf(torch.from_numpy(d), torch.from_numpy(sun)).numpy()
    assert got.dtype == want.dtype == np.float32
    cos = (d.astype(np.float64) * sun).sum(-1)
    far = np.abs(cos - np.float32(tsamp.COS_SUN_RADIUS)) > 2 * ULP1
    assert far.mean() > 0.9
    assert np.array_equal(want[far].view(np.uint32),
                          got[far].view(np.uint32))
    inside = np.float32(1.0 / (1.0 - tsamp.COS_SUN_RADIUS))
    assert (got[far] == inside).sum() > 2048 and (got[far] == 0).sum() > 2048


def test_cie_lut_equal():
    wl = np.linspace(350.0, 850.0, 1001)
    assert np.array_equal(jspec.cie_xyz(wl), tspec.cie_xyz(wl))
    for size in (512, tspec.LUT_SIZE):
        want = jspec.build_wl_to_rgb_lut_cie(size)
        got = tspec.build_wl_to_rgb_lut_cie(size)
        assert got.dtype == np.float32 and got.shape == (size, 3)
        assert np.array_equal(want.view(np.uint32), got.view(np.uint32))
        assert got.max() == 1.0 and got.min() >= 0.0


def test_srgb_decode_matches_and_round_trips(rng):
    v = np.concatenate([np.linspace(0, 1, 256, dtype=np.float32),
                        rng.random(4096, np.float32)])
    want = np.asarray(jcolor.srgb_decode(jnp.asarray(v)))
    got = tcolor.srgb_decode(torch.from_numpy(v)).numpy()
    assert got.dtype == np.float32
    assert (np.abs(got - want) <= 1e-6 * np.abs(want)).all()
    # tests/test_film.py's round trip, on the port's encode and decode
    lin = np.linspace(0, 1, 256, dtype=np.float32)
    enc = tcolor.srgb_encode(torch.from_numpy(lin))
    assert np.allclose(tcolor.srgb_decode(enc).numpy(), lin, atol=1e-5)
    assert np.allclose(tcolor.srgb_encode(torch.tensor(0.002)).numpy(),
                       0.02584, atol=1e-4)
    assert np.allclose(tcolor.srgb_encode(torch.tensor(0.5)).numpy(),
                       0.7353569, atol=1e-5)


def test_vdot_and_length(rng):
    a = rng.normal(size=(2048, 3)).astype(np.float32)
    b = _unit(rng, 2048)
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    vd = tvec.vdot(ta, tb)
    want = np.asarray(jvec.vdot(jnp.asarray(a), jnp.asarray(b)))
    assert vd.shape == want.shape == (2048, 1)
    assert np.abs(vd.numpy() - want).max() <= 2 * ULP1 * np.abs(a).max()
    ln = tvec.length(ta)
    # the correctly rounded root of the port's own sum (vecmath.sqrt)
    ss = tvec.dot(ta, ta).numpy().astype(np.float64)
    assert np.array_equal(ln.numpy(), np.sqrt(ss).astype(np.float32))
    want = np.asarray(jvec.length(jnp.asarray(a)))
    assert (np.abs(ln.numpy() - want) <= 2 * np.spacing(want)).all()


def test_vec3_equal_and_device():
    xs = np.linspace(-3, 3, 7).astype(np.float32)
    cases = [(1.0, 2, -3.5), (xs, xs * 2, xs - 1)]
    for x, y, z in cases:
        want = np.asarray(jvec.vec3(x, y, z))
        got = tvec.vec3(*(torch.from_numpy(c) if isinstance(c, np.ndarray)
                          else c for c in (x, y, z)))
        assert got.dtype == torch.float32 and got.shape == want.shape
        assert np.array_equal(got.numpy().view(np.uint32),
                              want.view(np.uint32))
    # numbers go to `device`; a tensor component keeps its device
    assert tvec.vec3(1.0, 2.0, 3.0, device="meta").device.type == "meta"
    m = torch.zeros((), device="meta")
    assert tvec.vec3(m, 1.0, 2.0).device.type == "meta"
    assert tvec.vec3(1, 2, 3, dtype=torch.float64).dtype == torch.float64


def _walk(space, nid, out):
    """Preorder (id, cell) from ``nid`` through unwrap_children and
    get_node; leaf colours as float32 bit patterns."""
    kind, payload = space.get_node(nid)
    if kind == "block":
        out.append((nid, kind, tuple(np.float32(payload).view(np.uint32))))
        return
    assert space.unwrap_children(nid) == payload
    out.append((nid, kind, payload))
    for c in payload:
        if c is not None:
            _walk(space, c, out)


def test_svo_node_accessors_match(rng):
    """tests/test_svo.py's accessor test on both packages, after the
    same random point edits: the same tree from root_node(), the same
    leaf colours by bits, and nodes() holds every live node once."""
    n = 16
    solid = rng.random((n, n, n)) < 0.1
    rgb = rng.random((n, n, n, 3)).astype(np.float32)
    rgb[~solid] = 0
    js, ts = jsvo.from_dense(solid, rgb), tsvo.from_dense(solid, rgb)
    for _ in range(200):
        p = tuple(int(v) for v in rng.integers(0, n, 3))
        c = None if rng.random() < 0.4 else tuple(
            np.float32(v) for v in rng.random(3))
        js.set(p, c)
        ts.set(p, c)
    walks = []
    for space in (js, ts):
        root = space.root_node()
        assert root is not None and space.get_node(root)[0] == "children"
        out = []
        _walk(space, root, out)
        walks.append(out)
        assert sum(1 for _ in space.nodes()) == space.num_nodes()
        assert {k for _, (k, _) in space.nodes()} == {"block", "children"}
    assert walks[0] == walks[1]
    assert list(js.nodes()) == list(ts.nodes())
    dead = next((i for i in range(ts.capacity())
                 if ts._kind[i] is None), None)
    assert dead is not None  # the edits freed a slot
    with pytest.raises(ValueError):
        ts.get_node(dead)
    leaf = next(i for i, (k, _) in ts.nodes() if k == "block")
    with pytest.raises(ValueError):
        ts.unwrap_children(leaf)


@pytest.mark.parametrize("sync", [True, False])
def test_timed_logs_in_the_jax_format(sync):
    """``label: N.NNNs`` as the JAX package logs it; sync=True works
    without a card (CUDA is not initialised on the CPU)."""
    lines = {}
    for name, mod in (("jax", jprof), ("torch", tprof)):
        logged = []
        with mod.timed("frame", log=logged.append, sync=sync):
            torch.ones(64).sum()
        lines[name] = logged
    for logged in lines.values():
        assert len(logged) == 1
        assert re.fullmatch(r"frame: \d+\.\d{3}s", logged[0]), logged
    assert not torch.cuda.is_initialized()
