"""Frame statistics, section timing, the port's spans and its counters
(``voxtracer/utils/profiling.py``'s ``FrameTimer`` and ``timed``).

The reference's only instrumentation is a frame-time ring buffer and
stdout throughput prints (main.rs:45, 72-77, 125-130). ``FrameTimer`` is
that ring buffer (250 frames, like main.rs:45) plus derived Mrays/s;
``timed`` is a wall-clock section timer that waits for the card's
outstanding work. Device traces come from ``torch.profiler``.

``span(name)`` names a layer of the port inside a trace: while the
autograd profiler records it is ``record_function(name)``, a
``user_annotation`` event on the profiler's own clock beside the card's
kernels and copies, its parent the span open around it on its thread;
otherwise it is one shared null context. The port's spans are named
``vt:<layer>``.

The counter registry (``count``, ``hold``, ``counts``, ``reset``) keeps
the port's counts under one lock, so no thread loses an increment:
every kernel launch counts ``launches.<kernel>``, and while the profiler
records K9 holds each call's per-bounce queue lengths, summed on the host
only when the registry is read. Inside ``recording()`` a thread's counts
go to a dict of its own instead, and its holds are dropped: a CUDA
graph's capture launches nothing, and each replay counts what the
capture recorded (``dist/shard.py``).
"""

from __future__ import annotations

import contextlib
import functools
import threading
import time
from collections import deque

import torch

_NO_SPAN = contextlib.nullcontext()


def span(name: str):
    """A context that names ``name`` in the profiler's trace while it
    records, else the one shared null context (``with span("vt:x"):``)."""
    if torch.autograd._profiler_enabled():
        return torch.autograd.profiler.record_function(name)
    return _NO_SPAN


def spanned(name: str):
    """Decorate a function so that each call runs in ``span(name)``."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return call
    return wrap


class Counters:
    """Named counts under one lock. ``hold`` keeps a device tensor to be
    counted at the next read (no host read where it is held)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._counts: dict[str, int] = {}
        self._held: list[tuple[str, tuple, torch.Tensor]] = []
        self._local = threading.local()  # .sink: recording()'s dict

    def count(self, name: str, n: int = 1):
        sink = getattr(self._local, "sink", None)
        if sink is not None:
            sink[name] = sink.get(name, 0) + n
            return
        with self._lock:
            self._counts[name] = self._counts.get(name, 0) + n

    def hold(self, prefix: str, names, values: torch.Tensor):
        """While the profiler records: count ``values`` (..., len(names))
        at the next read as ``<prefix>.<name>``, each column summed over
        the other axes, and one ``<prefix>.calls``. Otherwise nothing."""
        if not torch.autograd._profiler_enabled() \
                or getattr(self._local, "sink", None) is not None:
            return
        with self._lock:
            self._held.append((prefix, tuple(names), values))

    @contextlib.contextmanager
    def recording(self):
        """Divert this thread's counts into the yielded dict, and drop its
        holds, until the block ends."""
        self._local.sink = sink = {}
        try:
            yield sink
        finally:
            self._local.sink = None

    def counts(self) -> dict:
        """A snapshot of every count; the held tensors are read to the
        host here, added and released."""
        with self._lock:
            for prefix, names, values in self._held:
                col = values.to("cpu", torch.int64) \
                    .reshape(-1, len(names)).sum(0).tolist()
                for name, v in zip(names + ("calls",), col + [1]):
                    key = f"{prefix}.{name}"
                    self._counts[key] = self._counts.get(key, 0) + v
            self._held.clear()
            return dict(self._counts)

    def reset(self):
        """Zero every count and drop the held tensors."""
        with self._lock:
            self._counts.clear()
            self._held.clear()


COUNTERS = Counters()  # the port's registry, one a process
count = COUNTERS.count
hold = COUNTERS.hold
counts = COUNTERS.counts
reset = COUNTERS.reset
recording = COUNTERS.recording


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
