"""The atmosphere march: CUDA kernel K1 (csrc/fog_march.cu) and its plain
PyTorch version.

Counterpart of ``voxtracer/kernels/pallas/fog.py:fog_march``. The
wrapper takes the kernel for CUDA tensors and the plain version for CPU
tensors; there is no fallback between them.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from voxtracer_torch.core.vecmath import div, sqrt
from voxtracer_torch.kernels import build
from voxtracer_torch.utils import profiling

PLANET_RADIUS = 6371000.0  # raytrace.wgsl:262
FOG_HALFLIFE = 10400.0 / math.log(2.0)  # raytrace.wgsl:263
FOG_RADIUS = PLANET_RADIUS + 10.0 * FOG_HALFLIFE  # raytrace.wgsl:264
FOG_FACTOR = math.log(2.0) / FOG_HALFLIFE  # raytrace.wgsl:265

# float32 constants, each folded in double and rounded once (what JAX's
# weak typing does with the same Python expressions)
_F32 = lambda v: float(np.float32(v))  # noqa: E731
PLANET_R_F = _F32(PLANET_RADIUS)
PLANET_R2_F = _F32(PLANET_RADIUS * PLANET_RADIUS)
FOG_R2_F = _F32(FOG_RADIUS * FOG_RADIUS)
FOG_FACTOR_F = _F32(FOG_FACTOR)

MAX_STEPS = 256  # the kernel's shared table of segment fractions
# lane fetch (csrc/lanes.cuh): percent of the lanes split evenly among
# the warps up front, lanes per later claim, idle threads of a warp that
# make it refill (measured on the card, PERF.md)
STATIC_PCT, CHUNK, REFILL = 90, 32, 8

# the work of K1's last launch, counted on the card (an int64 tensor
# there, read by chip_smoke for the kernel's bound): the marches the
# scatter-free test (csrc/fog_walk.cuh) settled, and the segments marched
last_work = None


def fog_march(start, direction, density, y0, n_steps: int = 64,
              active=None):
    """March B rays through the atmosphere.

    start/direction: (B, 3) float32; density/y0: (B,) float32; active:
    optional (B,) bool lane mask (inactive lanes are not marched).
    Returns (code (B,) int32 [0 miss / 1 planet / 2 fog], t (B,) float32);
    an inactive lane gets code 0 and t 0.
    """
    global last_work
    if start.device.type == "cpu":
        return fog_march_plain(start, direction, density, y0, n_steps, active)
    if start.device.type != "cuda":
        raise ValueError(f"fog_march: unsupported device {start.device}")
    if not 0 <= n_steps <= MAX_STEPS:
        raise ValueError(f"fog_march: n_steps {n_steps} outside 0..{MAX_STEPS}")
    B = start.shape[0]
    if B > build.MAX_LANES:
        raise ValueError(f"fog_march: {B} lanes > {build.MAX_LANES}")
    checks = [("start", start, (B, 3), torch.float32),
              ("direction", direction, (B, 3), torch.float32),
              ("density", density, (B,), torch.float32),
              ("y0", y0, (B,), torch.float32)]
    if active is not None:
        checks.append(("active", active, (B,), torch.bool))
    for name, x, shape, dtype in checks:
        if x.device != start.device or x.dtype != dtype \
                or tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"fog_march: {name} must be a contiguous {dtype} "
                             f"{shape} tensor on {start.device}, got "
                             f"{x.dtype} {tuple(x.shape)} on {x.device}")
    code = torch.empty((B,), dtype=torch.int32, device=start.device)
    t = torch.empty((B,), dtype=torch.float32, device=start.device)
    if B == 0:
        return code, t
    lib = build.library()
    # one zeroed buffer: the lane fetch's int32 counter in its first word,
    # then the work counts
    zeroed = torch.zeros((3,), dtype=torch.int64, device=start.device)
    with torch.cuda.device(start.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.voxt_fog_march(
            start.data_ptr(), direction.data_ptr(), density.data_ptr(),
            y0.data_ptr(), None if active is None else active.data_ptr(),
            code.data_ptr(), t.data_ptr(), B, int(n_steps), PLANET_R_F,
            PLANET_R2_F, FOG_R2_F, FOG_FACTOR_F, zeroed.data_ptr(), STATIC_PCT,
            CHUNK, REFILL, zeroed[1:].data_ptr(), stream)
    build.check(err, "fog_march")
    profiling.count("launches.fog_march")
    last_work = zeroed[1:]
    return code, t


def _sphere_span(start, direction):
    """Shell entry/exit (t0, t1 clipped at the planet), valid and surf
    masks, and the planet-centred origin; shared with
    ``atmosphere.transmittance_to_escape``."""
    px, py, pz = start[..., 0], start[..., 1], start[..., 2]
    dx, dy, dz = direction[..., 0], direction[..., 1], direction[..., 2]
    pyr = py + PLANET_RADIUS
    pp = px * px + pyr * pyr + pz * pz
    b = 2.0 * (px * dx + pyr * dy + pz * dz)
    c = pp - FOG_RADIUS * FOG_RADIUS
    det = b * b - 4.0 * c
    sq = sqrt(torch.clamp_min(det, 0.0))
    t0 = torch.clamp_min((-b - sq) / 2.0, 0.0)
    t1 = (-b + sq) / 2.0
    valid = (det >= 0.0) & (t1 >= 0.0)

    c_pl = pp - PLANET_RADIUS * PLANET_RADIUS
    det_pl = b * b - 4.0 * c_pl
    sq_pl = sqrt(torch.clamp_min(det_pl, 0.0))
    t0_pl = (-b - sq_pl) / 2.0
    surf = valid & (det_pl >= 0.0) & (t0_pl > 0.0)
    t1 = torch.where(surf, t0_pl, t1)
    return t0, t1, valid, surf, (px, pyr, pz)


def _segment(i: int, n: int, t0, t1):
    """Segment i of n, marched from the far end: (t_s0, t_s1)."""
    a1 = np.float32(i + 1) / np.float32(n)
    a0 = np.float32(i) / np.float32(n)
    t_s0 = float(a0) * t0 + float(np.float32(1.0) - a0) * t1
    t_s1 = float(a1) * t0 + float(np.float32(1.0) - a1) * t1
    return t_s0, t_s1


def _altitude(p, direction, t):
    px, pyr, pz = p
    sx = px + direction[..., 0] * t
    sy = pyr + direction[..., 1] * t
    sz = pz + direction[..., 2] * t
    return sqrt(sx * sx + sy * sy + sz * sz) - PLANET_RADIUS


def fog_march_plain(start, direction, density, y0, n_steps: int = 64,
                    active=None):
    """Plain PyTorch version of K1, on any device, same arithmetic; marches
    every lane and zeroes the inactive ones."""
    t0, t1, valid, surf, p = _sphere_span(start, direction)
    density_scaled = div(t1 - t0, float(n_steps)) * density
    y = y0
    found = torch.zeros_like(valid)
    t_sc = torch.zeros_like(t1)
    for i in range(n_steps):
        t_s0, t_s1 = _segment(i, n_steps, t0, t1)
        alt = _altitude(p, direction, t_s1)
        d_seg = density_scaled * torch.exp(-alt * FOG_FACTOR)
        scatter = ~found & (y < d_seg)
        frac = torch.where(d_seg > 0, y / torch.clamp_min(d_seg, 1e-30), 0.0)
        t_new = frac * t_s0 + (1.0 - frac) * t_s1
        t_sc = torch.where(scatter, t_new, t_sc)
        found = found | scatter
        y = torch.where(found, y, y - d_seg)
    found = found & valid
    code = torch.where(found, 2, torch.where(surf, 1, 0)).to(torch.int32)
    t = torch.where(found, t_sc, torch.where(surf, t1, 0.0))
    if active is not None:
        code = torch.where(active, code, 0).to(torch.int32)
        t = torch.where(active, t, 0.0)
    return code, t
