"""Progressive sample accumulation with reset-on-change.

The reference accumulates 1 sample/pixel/frame into an f32 texture and
resets whenever the camera pose, sun, world or viewport changes
(fragment.rs:322-415). Here the buffer is a tensor on the render device;
``add`` adds a sample into it IN PLACE (no second buffer, no host round
trip), and the mean crosses to the host only at save points.
"""

from __future__ import annotations

import numpy as np
import torch


class Accumulator:
    def __init__(self, width: int, height: int, device="cpu"):
        self.width = width
        self.height = height
        self.device = torch.device(device)
        self.buffer = torch.zeros((height, width, 3), dtype=torch.float32,
                                  device=self.device)
        self.samples = 0
        self._key = None

    def _state_key(self, cam_pos, yaw, pitch, sun):
        return (
            tuple(np.round(np.asarray(cam_pos, np.float64), 9)),
            round(float(yaw), 9),
            round(float(pitch), 9),
            tuple(np.round(np.asarray(sun, np.float64), 9)),
        )

    def begin_sample(self, cam_pos, yaw, pitch, sun) -> bool:
        """Reset if the render state changed (fragment.rs:331-354).
        Returns True when a reset happened."""
        key = self._state_key(cam_pos, yaw, pitch, sun)
        if key != self._key:
            self._key = key
            self.buffer.zero_()
            self.samples = 0
            return True
        return False

    def invalidate(self):
        """Force a reset on the next begin_sample (world edits)."""
        self._key = None

    def add(self, radiance, samples: int = 1):
        """Add a radiance sum of ``samples`` samples, in place."""
        self.buffer += radiance
        self.samples += samples

    def mean(self) -> np.ndarray:
        """Host copy of the averaged radiance."""
        n = max(self.samples, 1)
        return self.buffer.cpu().numpy() / n
