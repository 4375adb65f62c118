"""Colour transfer functions: the exact sRGB transfer of the reference
(main.rs:352-361), its inverse, and the 8-bit tonemap of the film
output."""

from __future__ import annotations

import torch

from voxtracer_torch.core.vecmath import div


def srgb_encode(v):
    """Linear -> sRGB (exact piecewise transfer)."""
    v = torch.as_tensor(v)
    lo = v * 12.92
    hi = torch.pow(torch.clamp_min(v, 1e-12), 1.0 / 2.4) * 1.055 - 0.055
    return torch.where(v < 0.0031308, lo, hi)


def srgb_decode(v):
    """sRGB -> linear (inverse of srgb_encode)."""
    v = torch.as_tensor(v)
    lo = div(v, 12.92)
    hi = torch.pow(div(v + 0.055, 1.055), 2.4)
    return torch.where(v < 0.04045, lo, hi)


def tonemap_to_u8(linear_rgb):
    """Linear radiance -> 8-bit sRGB, clipped."""
    enc = srgb_encode(torch.clamp(torch.as_tensor(linear_rgb), 0.0, 1.0))
    return torch.clamp(enc * 255.0 + 0.5, 0.0, 255.0).to(torch.uint8)
