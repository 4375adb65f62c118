"""Frozen copy of the port's plain arithmetic, ``voxtracer_torch/core/sampling.py``, kept
beside the reference so that it imports nothing of the program.

Monte-Carlo direction sampling over the pcg3d state (core.rng).

Same samplers, constants and draw order as ``voxtracer/core/sampling.py``
(raytrace.wgsl:202-260): every sampler consumes its draws whatever the
lane masks say, so a lane's random sequence does not depend on its
neighbours.
"""

from __future__ import annotations

import math

import torch

from vtbench.reference import rng as vrng
from vtbench.reference.vecmath import cross, dot, normalize, sqrt

PI = math.pi
SUN_ANGULAR_RADIUS = 0.535 * PI / 180.0  # raytrace.wgsl:237
COS_SUN_RADIUS = math.cos(SUN_ANGULAR_RADIUS)
SUN_WEIGHT = 1.0 - COS_SUN_RADIUS  # solid angle / 2pi (raytrace.wgsl:252)
SUN_COLOR = 10000.0  # raytrace.wgsl:239


def random_disk(state, n):
    """Uniform unit-disk sample in the tangent plane of n (two draws)."""
    state, rand = vrng.random3(state)
    r = sqrt(rand[..., 0])
    angle = rand[..., 1] * 2.0 * PI
    px = r * torch.cos(angle)
    py = r * torch.sin(angle)
    state, rand2 = vrng.random3(state)
    bitangent = normalize(cross(rand2, n))
    tangent = cross(bitangent, n)
    return state, tangent * px[..., None] + bitangent * py[..., None]


def cos_hemisphere(state, n):
    """Cosine-weighted hemisphere direction around n."""
    state, disk = random_disk(state, n)
    d2 = dot(disk, disk)[..., None]
    return state, disk + n * sqrt(torch.clamp_min(1.0 - d2, 0.0))


def sample_sun(state, sun):
    """Uniform direction within the sun cone around unit vector ``sun``."""
    state, rand = vrng.random3(state)
    z = rand[..., 0] * (1.0 - COS_SUN_RADIUS) + COS_SUN_RADIUS
    angle = rand[..., 1] * 2.0 * PI
    s = sqrt(torch.clamp_min(1.0 - z * z, 0.0))
    px = torch.cos(angle) * s
    py = torch.sin(angle) * s
    state, rand2 = vrng.random3(state)
    bitangent = normalize(cross(rand2, sun))
    tangent = cross(bitangent, sun)
    return state, (
        tangent * px[..., None] + bitangent * py[..., None] + sun * z[..., None]
    )


def brdf(outgoing, incoming, normal):
    """Lambertian BRDF, constant 1/pi (raytrace.wgsl:233-235)."""
    del outgoing, incoming, normal
    return 1.0 / PI
