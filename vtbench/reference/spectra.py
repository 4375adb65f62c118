"""Frozen copy of the port's plain arithmetic, ``voxtracer_torch/core/spectra.py``, kept
beside the reference so that it imports nothing of the program.

Spectral pipeline: wavelength -> linear-sRGB LUT and path weights.

The LUT is built in numpy by the same knot model as
``voxtracer/core/spectra.py`` (a piecewise-linear fit of the reference's
wavelength ramp, fragment.rs:78-147), so both packages hold the same
table bit for bit. ``sample_lut``, ``spectral_throughput`` and
``fog_density`` keep the JAX expression order (raytrace.wgsl:330-336).
"""

from __future__ import annotations

import numpy as np
import torch

from vtbench.reference.vecmath import rdiv

LUT_SIZE = 2048
WL_MIN_NM = 400.0
WL_MAX_NM = 800.0

# (wavelength_nm, sRGB value) knots per channel of the reference ramp.
_RAMP_KNOTS_SRGB = dict(
    r=[(400.1, 0.0000), (564.9, 0.0000), (567.9, 0.0353), (580.7, 0.2510),
       (596.1, 0.4824), (632.5, 0.9922), (765.0, 0.9922), (780.2, 0.6627),
       (799.9, 0.2000)],
    g=[(400.1, 0.0000), (461.8, 0.0118), (497.6, 0.4471), (548.0, 1.0000),
       (636.6, 1.0000), (708.9, 0.4431), (759.4, 0.0118), (799.9, 0.0000)],
    b=[(400.1, 0.4157), (410.5, 0.5255), (437.3, 1.0000), (459.7, 1.0000),
       (507.7, 0.4745), (528.1, 0.2353), (544.8, 0.0196), (548.0, 0.0000),
       (799.9, 0.0000)],
)


def _srgb_decode_np(v):
    v = np.asarray(v, np.float64)
    return np.where(v <= 0.04045, v / 12.92, ((v + 0.055) / 1.055) ** 2.4)


def build_wl_to_rgb_lut(size: int = LUT_SIZE) -> np.ndarray:
    """(size, 3) float32 linear-sRGB LUT; entry i is the wavelength at
    normalized coordinate (i + 0.5)/size, decoded from sRGB before any
    filtering (fragment.rs:94-106)."""
    u = (np.arange(size) + 0.5) / size
    wl = WL_MIN_NM + u * (WL_MAX_NM - WL_MIN_NM)
    srgb = np.stack(
        [
            np.interp(wl, [k[0] for k in _RAMP_KNOTS_SRGB[c]],
                      [k[1] for k in _RAMP_KNOTS_SRGB[c]])
            for c in ("r", "g", "b")
        ],
        axis=-1,
    )
    return _srgb_decode_np(srgb).astype(np.float32)


def sample_lut(lut, u):
    """Linear-filtered LUT sample at normalized coordinate u in [0, 1),
    clamp-to-edge, texel i centred at (i + 0.5)/N."""
    n = lut.shape[0]
    pos = u * float(n) - 0.5
    i0 = torch.clamp(torch.floor(pos), 0, n - 1).to(torch.int64)
    i1 = torch.clamp(i0 + 1, 0, n - 1)
    frac = torch.clamp(pos - i0.to(torch.float32), 0.0, 1.0)[..., None]
    return lut[i0] * (1.0 - frac) + lut[i1] * frac


def spectral_throughput(lut, wavelength):
    """Initial path throughput for normalized wavelength in [0, 1): LUT
    colour x 1/((w+1)^3 (e^{0.1/(w+1)} - 1)) x tint (1.0, 0.8, 1.0)."""
    wp1 = wavelength + 1.0
    wlp1_cubed = wp1 * wp1 * wp1
    planck = rdiv(1.0, wlp1_cubed * (torch.exp(rdiv(0.1, wp1)) - 1.0))
    # made where it is used (no copy from the host, so no sync on a card)
    tint = torch.where(torch.arange(3, device=wavelength.device) == 1,
                       0.8, 1.0).to(torch.float32)
    return sample_lut(lut, wavelength) * planck[..., None] * tint


def fog_density(wavelength):
    """Rayleigh-like sea-level fog density for normalized wavelength:
    lambda = w*400nm + 400nm; 8.3468e-5 / (7.512e25 * lambda^4). The
    product stays in float32 range only when taken left to right."""
    wl = wavelength * 400.0e-9 + 400.0e-9
    return rdiv(8.346829234302236e-05, 7.512000000000001e25 * wl * wl * wl * wl)
