"""Frozen copy of the port's plain arithmetic, ``voxtracer_torch/core/vecmath.py``, kept
beside the reference so that it imports nothing of the program.

Small vector-math helpers over trailing-axis-3 float32 tensors.

Sums over the three components are written out left to right, so the
rounding is the same on every device: a reduction kernel is free to
choose its own order.

Division by a constant goes through ``div``/``rdiv``: PyTorch computes
``x / c`` for a Python number c as ``x * (1/c)`` on a card, and ``c / x``
as ``x.reciprocal() * c`` everywhere, each two roundings where the JAX
package and the CUDA kernels do one correctly rounded division.

Square roots go through ``sqrt``: some CPU builds of PyTorch return a
float32 ``torch.sqrt`` that is one ulp off in about one lane in six (the
JAX package's and the card's are correctly rounded).
"""

from __future__ import annotations

import torch

EPS = 1.0e-6  # direction clamp epsilon (reference: raytrace.wgsl:53)


def div(x: torch.Tensor, c: float) -> torch.Tensor:
    """x / c as one correctly rounded division on every device."""
    return torch.div(x, torch.full((), c, dtype=x.dtype, device=x.device))


def rdiv(c: float, x: torch.Tensor) -> torch.Tensor:
    """c / x as one correctly rounded division on every device."""
    return torch.div(torch.full((), c, dtype=x.dtype, device=x.device), x)


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float32 square root on every device. On the CPU
    it is taken in float64 and rounded once: the float64 root lies at
    least 8 of its ulps from any float32 tie, so a float64 root a few
    ulps off still rounds to the correct float32."""
    if x.is_cuda:
        return torch.sqrt(x)
    return torch.sqrt(x.to(torch.float64)).to(x.dtype)


def dot(a, b):
    """Batched dot product over the trailing axis, keepdims=False."""
    return a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1] + a[..., 2] * b[..., 2]


def cross(a, b):
    ax, ay, az = a[..., 0], a[..., 1], a[..., 2]
    bx, by, bz = b[..., 0], b[..., 1], b[..., 2]
    return torch.stack([ay * bz - az * by, az * bx - ax * bz,
                        ax * by - ay * bx], dim=-1)


def length(a):
    return sqrt(dot(a, a))


def normalize(a):
    return a / length(a)[..., None]


def hmax(a):
    """Horizontal max over the trailing axis (reference: raytrace.wgsl:56-58)."""
    return torch.amax(a, dim=-1)


def hmin(a):
    """Horizontal min over the trailing axis (reference: raytrace.wgsl:60-62)."""
    return torch.amin(a, dim=-1)
