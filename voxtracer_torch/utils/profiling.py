"""Frame statistics and section timing (``voxtracer/utils/profiling.py``'s
``FrameTimer`` and ``timed``).

The reference's only instrumentation is a frame-time ring buffer and
stdout throughput prints (main.rs:45, 72-77, 125-130). ``FrameTimer`` is
that ring buffer (250 frames, like main.rs:45) plus derived Mrays/s;
``timed`` is a wall-clock section timer that waits for the card's
outstanding work. Device traces come from ``torch.profiler``.
"""

from __future__ import annotations

import contextlib
import time
from collections import deque

import torch


class FrameTimer:
    """Ring-buffer frame statistics (reference: 250-frame window)."""

    def __init__(self, window: int = 250):
        self.times = deque(maxlen=window)
        self.last = time.monotonic()
        self.frames = 0

    def tick(self) -> float:
        now = time.monotonic()
        dt = now - self.last
        self.last = now
        self.times.append(dt)
        self.frames += 1
        return dt

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    def mrays_per_sec(self, rays_per_frame: int) -> float:
        return self.fps * rays_per_frame / 1e6


@contextlib.contextmanager
def timed(label: str, log=print, sync=True):
    """Wall-clock a section and log ``label: N.NNNs``. With ``sync`` it
    first waits for the work queued on the card, when CUDA is
    initialised in this process (a CPU-only run has nothing to wait for)."""
    t0 = time.monotonic()
    yield
    if sync and torch.cuda.is_initialized():
        torch.cuda.synchronize()
    log(f"{label}: {time.monotonic() - t0:.3f}s")
