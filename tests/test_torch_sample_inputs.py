"""How a one-card ``Renderer.sample``'s small inputs reach the device
(``render/driver.py``: ``_sun``, ``_args``, ``_seeds``): the sun once a
sun value, the pose once a pose, the frame seed every sample, each
copied without blocking the host.

On the CPU: the ``inputs.staged.*`` / ``inputs.reused.*`` counters while
the profiler records, none without it, and the accumulation equal by
bits to ``render_sample`` called with every input on the host and the
same seeds. On a card (the tests taking ``cuda`` skip without one): a
warmed hf-only Renderer samples at a held pose, and with the sun changed
between samples, under ``torch.cuda.set_sync_debug_mode("error")``
without a host sync, and each sample's radiance and the accumulation
equal, by bits, ``render_sample`` with host inputs and a
``torch.cuda.synchronize()`` after each call. Run there from the
repository root:
    python -m pytest tests/test_torch_sample_inputs.py -q --noconftest
"""

import random

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from voxtracer_torch.core import camera as vcam
from voxtracer_torch.core import rng as vrng
from voxtracer_torch.kernels import integrator
from voxtracer_torch.render import driver
from voxtracer_torch.utils import profiling
from voxtracer_torch.world import worldgen

torch.set_num_threads(2)
W, H = 32, 16
KW = dict(max_bounces=2, fog_steps=4)
SEED = 11
SUN = np.array([0.8, 10.2743, 3.7])
SUN_STEP = driver.rotate_sun(SUN / np.linalg.norm(SUN))
SUN_WARM = driver.rotate_sun(SUN / np.linalg.norm(SUN), -driver.DAY_STEP)
CAM_A = vcam.Camera(pos=(12.0, 14.0, 6.0), yaw=0.4, pitch=0.5)
CAM_B = vcam.Camera(pos=(13.0, 14.0, 6.0), yaw=0.5, pitch=0.4)


def _renderer(device, monkeypatch):
    """An hf-only Renderer on the 32^3 terrain (``HF_FRAME_SIZE`` lowered
    to it): the main path's engine, the envelope serving the primaries."""
    monkeypatch.setattr(driver.Renderer, "HF_FRAME_SIZE", 32)
    space = worldgen.generate(log2_size=5, verbose=False, device="cpu")
    r = driver.Renderer(space.serialize(), W, H, seed=SEED, device=device,
                        **KW)
    assert r._hf_only() and r._get_soup() is None
    return r


def _spy(monkeypatch):
    """Record every ``render_sample`` call of the Renderer: (keywords but
    the inputs, the radiance it returned)."""
    calls = []
    real = driver.render_sample

    def spy(table, root, height, lut, cam_pos, cam_basis, sun, seed, *a,
            **kw):
        out = real(table, root, height, lut, cam_pos, cam_basis, sun, seed,
                   *a, **kw)
        calls.append(((table, root, height, lut) + a, kw, out))
        return out

    monkeypatch.setattr(driver, "render_sample", spy)
    return calls


def _host_sample(call, cam, sun, seed, sync):
    """``render_sample`` in the host form: the pose, the sun and the seed
    given on the host, as the Renderer gave them before staging."""
    head, kw, _ = call
    unit = (sun / np.linalg.norm(sun)).astype(np.float32)
    out = integrator.render_sample(
        *head[:4], np.asarray(cam.pos, np.float32), cam.basis(),
        torch.from_numpy(unit).to(head[0].device), seed, *head[4:], **kw)
    if sync:
        torch.cuda.synchronize()
    return out


def _inputs():
    return {k: v for k, v in profiling.counts().items()
            if k.startswith("inputs.")}


def test_counts_and_bits_on_the_cpu(monkeypatch):
    """Two samples at one pose and sun stage the sun and the pose once
    and reuse them once, and stage two seeds; a sun step stages one more
    sun, a pose change one more pose; untraced nothing counts. The
    accumulation equals the host form's sum with the same seeds."""
    r = _renderer("cpu", monkeypatch)
    calls = _spy(monkeypatch)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        r.sample(CAM_A, SUN)
        r.sample(CAM_A, SUN)
    assert _inputs() == {"inputs.staged.sun": 1, "inputs.reused.sun": 1,
                         "inputs.staged.pose": 1, "inputs.reused.pose": 1,
                         "inputs.staged.seed": 2}
    r.sample(CAM_A, SUN)  # not profiled: not counted
    assert _inputs()["inputs.staged.seed"] == 2
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        r.sample(CAM_A, SUN_STEP)
        r.sample(CAM_B, SUN_STEP)
    assert _inputs() == {"inputs.staged.sun": 1, "inputs.reused.sun": 1,
                         "inputs.staged.pose": 1, "inputs.reused.pose": 1,
                         "inputs.staged.seed": 2}
    profiling.reset()
    host = random.Random(SEED)
    plan = [(CAM_A, SUN)] * 3 + [(CAM_A, SUN_STEP), (CAM_B, SUN_STEP)]
    want = None
    for call, (cam, sun) in zip(calls, plan):
        got = _host_sample(call, cam, sun, vrng.host_frame_seed(host), False)
        assert torch.equal(call[2], got)
        if cam is CAM_B:  # the pose changed: the accumulation restarted
            want = got
    assert len(calls) == 5 and r.acc.samples == 1
    assert torch.equal(r.acc.buffer, want)
    # the device copies are the host values, and the seed is int64
    sun_unit, sun_t = r._sun(SUN_STEP)
    assert torch.equal(sun_t, torch.from_numpy(sun_unit))
    pos, basis = r._args(CAM_B, None)[4:]
    assert torch.equal(basis, CAM_B.basis())
    assert torch.equal(pos, torch.tensor(CAM_B.pos, dtype=torch.float32))
    assert r._seeds().dtype == torch.int64


def test_a_soup_renderer_keeps_the_host_pose(monkeypatch):
    """With a soup the rasterizer reads the pose on the host: no pose is
    staged, and the sample equals a Renderer's without the soup."""
    space = worldgen.generate(log2_size=5, verbose=False, device="cpu")
    r = driver.Renderer(space.serialize(), W, H, seed=SEED, device="cpu",
                        **KW)
    s = driver.Renderer(space.serialize(), W, H, seed=SEED, device="cpu",
                        use_soup=False, **KW)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        r.sample(CAM_A, SUN)
        s.sample(CAM_A, SUN)
    c = _inputs()
    profiling.reset()
    assert r._soup is not None and r._pose_t is None
    pos, basis = r._args(CAM_A, r._get_soup())[4:]
    assert isinstance(pos, np.ndarray) and basis.device.type == "cpu"
    assert c["inputs.staged.pose"] == 1 and "inputs.reused.pose" not in c
    assert c["inputs.staged.seed"] == 2
    assert torch.equal(r.acc.buffer, s.acc.buffer)


# -- on a card --

@pytest.fixture(scope="module")
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the sync check runs on the card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("suns", ["held", "stepped"])
def test_samples_make_no_host_sync_and_equal_the_host_form(cuda, monkeypatch,
                                                           suns):
    """Four samples at a held pose under sync-debug "error" (the sun held,
    or stepped after the second), after a warm-up past the envelope's
    last tier under the sun a step before: nothing raises, and each
    radiance and the accumulation equal the host form's, synchronised
    after each call, by bits."""
    r = _renderer(cuda, monkeypatch)
    warm = 6  # the envelope's tiers (SKY_TIERS: first uses 0, 1, 4)
    for _ in range(warm):
        r.sample(CAM_A, SUN_WARM)
    torch.cuda.synchronize()
    calls = _spy(monkeypatch)
    plan = [SUN, SUN] + [SUN if suns == "held" else SUN_STEP] * 2
    torch.cuda.set_sync_debug_mode("error")
    try:
        for sun in plan:
            r.sample(CAM_A, sun)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    host = random.Random(SEED)
    for _ in range(warm):
        vrng.host_frame_seed(host)
    want = None
    for i, (call, sun) in enumerate(zip(calls, plan)):
        got = _host_sample(call, CAM_A, sun, vrng.host_frame_seed(host), True)
        assert torch.equal(call[2], got), i
        if i == 0 or (suns == "stepped" and i == 2):
            want = got.clone()  # the accumulation (re)starts
        else:
            want += got
    assert len(calls) == 4 and r.acc.samples == (4 if suns == "held" else 2)
    assert torch.equal(r.acc.buffer, want)
