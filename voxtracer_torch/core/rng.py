"""Counter-free PCG3D random number generation on int64 tensors.

The state is a ``(..., 3)`` int64 tensor holding uint32 values in
``[0, 2^32)``. PyTorch on the CPU has no uint32 add or right shift, so
every add and multiply runs in int64 and is masked back to 32 bits: the
low 32 bits of a wrapped int64 product are exact, so the sequence is bit
for bit the one ``voxtracer/core/rng.py`` draws in uint32.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFFFFFF
_MUL = 1664525
_ADD = 1013904223


def pcg3d(state: torch.Tensor) -> torch.Tensor:
    """One PCG3D step. state: (..., 3) int64 in [0, 2^32)."""
    v = (state * _MUL + _ADD) & MASK
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    x = (x + y * z) & MASK
    y = (y + x * z) & MASK
    z = (z + y * x) & MASK
    x = x ^ (x >> 16)
    y = y ^ (y >> 16)
    z = z ^ (z >> 16)
    x = (x + y * z) & MASK
    y = (y + x * z) & MASK
    z = (z + y * x) & MASK
    return torch.stack([x, y, z], dim=-1)


def random3(state: torch.Tensor):
    """Advance the RNG; return (new_state, (..., 3) float32 in [0, 1)),
    the top 16 bits over 65536."""
    v = pcg3d(state)
    return v, (v >> 16).to(torch.float32) / 65536.0


def seed_pixels(frame_seed, px: torch.Tensor, py: torch.Tensor):
    """Per-pixel state: the (3,) frame seed XOR the bit patterns of the
    pixel-centre floats (x + 0.5, y + 0.5, 0.0). ``frame_seed``: three
    uint32 values, or their int64 tensor already on the pixels' device
    (read there, nothing copied from the host)."""
    fx = (px.to(torch.float32) + 0.5).view(torch.int32).to(torch.int64) & MASK
    fy = (py.to(torch.float32) + 0.5).view(torch.int32).to(torch.int64) & MASK
    pix = torch.stack([fx, fy, torch.zeros_like(fx)], dim=-1)
    if isinstance(frame_seed, torch.Tensor):
        if frame_seed.device != px.device or frame_seed.dtype != torch.int64:
            raise ValueError("seed_pixels: a tensor seed must be int64 on "
                             f"{px.device}")
        return frame_seed ^ pix
    seed = torch.as_tensor(np.asarray(frame_seed, np.uint32).astype(np.int64),
                           device=px.device)
    return seed ^ pix


def host_frame_seed(py_rng):
    """Draw a (3,) uint32 frame seed from a host ``random.Random``."""
    return np.array([py_rng.getrandbits(32) for _ in range(3)], dtype=np.uint32)


def to_state(a) -> torch.Tensor:
    """uint32 numpy array -> int64 state tensor (for callers holding
    states made by numpy or by the JAX package)."""
    return torch.from_numpy(np.asarray(a, np.uint32).astype(np.int64))
