"""Frozen copy of the port's plain arithmetic, ``voxtracer_torch/core/camera.py``, kept
beside the reference so that it imports nothing of the program.

Camera model: yaw/pitch fly camera and per-pixel ray generation.

Conventions as ``voxtracer/core/camera.py``: basis ``Ry(yaw) @ Rx(pitch)``
with camera-space forward +Z; pixel (x, y) maps to
``normalize((2(x+.5) - w)/h, -(2(y+.5) - h)/h, 1)``; sub-pixel jitter is
uniform over the pixel footprint ``2/h`` (raytrace.wgsl:419-425).

Ray directions need full float32 arithmetic: TF32 would move a hit by up
to half a voxel at world-scale distances. The 3x3 product is written out
elementwise, so neither TF32 nor a fused multiply-add can touch it, and
the module also switches TF32 off for any float32 matmul or convolution
on the card.
"""

from __future__ import annotations

import numpy as np
import torch

from vtbench.reference.vecmath import div, normalize

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False


def camera_basis(yaw, pitch, device="cpu"):
    """3x3 float32 rotation whose columns are the camera right/up/forward
    axes. Every entry is one product of sines and cosines, so the result
    does not depend on the order of a matmul."""
    yaw = torch.as_tensor(yaw, dtype=torch.float32)
    pitch = torch.as_tensor(pitch, dtype=torch.float32)
    cy, sy = torch.cos(yaw), torch.sin(yaw)
    cp, sp = torch.cos(pitch), torch.sin(pitch)
    zero = torch.zeros_like(cy)
    basis = torch.stack([
        torch.stack([cy, sy * sp, sy * cp]),
        torch.stack([zero, cp, -sp]),
        torch.stack([-sy, cy * sp, cy * cp]),
    ])
    return basis.to(device)


def pixel_ndc(px, py, width, height):
    """Screen coordinates ld = 2*(pixel_centre - vp/2)/vp.y, shape (..., 2)."""
    w = float(np.float32(width))
    h = float(np.float32(height))
    lx = div(2.0 * (px.to(torch.float32) + 0.5) - w, h)
    ly = div(2.0 * (py.to(torch.float32) + 0.5) - h, h)
    return torch.stack([lx, ly], dim=-1)


def ray_directions(basis, ld, jitter=None, height=None):
    """World-space unit ray directions for screen coords ``ld`` (..., 2).

    ``jitter``: optional uniform [0, 1) (..., 2) sub-pixel offsets; the
    jittered coordinate is ``ld + (jitter - 0.5) * 2/height``.
    """
    if jitter is not None:
        px_size = float(np.float32(2.0) / np.float32(height))
        ld = ld + (jitter - 0.5) * px_size
    d_cam = torch.stack([ld[..., 0], -ld[..., 1], torch.ones_like(ld[..., 0])],
                        dim=-1)
    d_cam = normalize(d_cam)
    b = basis.to(device=d_cam.device, dtype=torch.float32)
    # d_cam @ basis.T, summed left to right
    return (d_cam[..., 0:1] * b[:, 0] + d_cam[..., 1:2] * b[:, 1]
            + d_cam[..., 2:3] * b[:, 2])
