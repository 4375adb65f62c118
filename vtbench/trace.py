"""Tracing for ``--trace 1`` runs: ``torch.profiler`` over a steady slice
of the window, ``record_function`` spans from the benchmark's own files
around the calls into the program's layers, and the reduction of the
profiler's Chrome trace to intervals that the metric readers read.

Device activity is the profiler's ``kernel``, ``gpu_memcpy`` and
``gpu_memset`` events; its busy time is the union of their intervals,
per card. A span is a ``user_annotation`` on the host; the device work
of a span is the device activity that starts inside it (every span ends
synchronised, so nothing of the span runs after it).
"""

from __future__ import annotations

import contextlib
import json
import os
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

WINDOW = "vtb:window"


@contextlib.contextmanager
def nullspan():
    yield


class Tracer:
    """Profiles ``count`` requests after the first ``skip`` of the
    window: samples of a headless run (``wrap_samples``), actions of a
    session (``before_action``)."""

    def __init__(self, skip: int, count: int, device_type: str):
        self.skip, self.count = skip, count
        self.cuda = device_type == "cuda"
        self.prof = None
        self.window = None
        self.done = False
        self.n = 0  # requests (a headless run's samples) profiled

    def _start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.cuda:
            acts.append(ProfilerActivity.CUDA)
            torch.cuda.synchronize()
        self.prof = profile(activities=acts)
        self.prof.start()
        self.window = torch.autograd.profiler.record_function(WINDOW)
        self.window.__enter__()

    def _stop(self):
        import torch

        if self.cuda:
            torch.cuda.synchronize()
        self.window.__exit__(None, None, None)
        self.prof.stop()
        self.done = True

    def active(self) -> bool:
        return self.prof is not None and not self.done

    def span(self, name):
        if not self.active():
            return nullspan()
        import torch

        return torch.autograd.profiler.record_function(name)

    def before_action(self, i):
        """Called before action ``i`` of the window (None: it ended)."""
        if i is None:
            if self.active():
                self._stop()
            return
        if i == self.skip and self.prof is None:
            self._start()
        elif i == self.skip + self.count and self.active():
            self._stop()
        if self.active():
            self.n += 1

    def wrap_samples(self, renderer):
        """Profile the renderer's sample calls (``sample``, and
        ``sample_batch`` where a headless batch traces several)
        ``skip`` .. ``skip + count - 1`` of the window, each in a span;
        ``n`` counts the samples they trace."""
        self.n_calls = 0
        mesh = renderer.mesh

        def wrap(inner, samples):
            def call(*a, **k):
                i = self.n_calls
                self.n_calls += 1
                if i == self.skip and self.prof is None:
                    self._start()
                elif i == self.skip + self.count and self.active():
                    self._stop()
                if not self.active():
                    return inner(*a, **k)
                self.n += samples(a)
                with self.span("vtb:sample"):
                    return inner(*a, **k)
            return call

        renderer.sample = wrap(renderer.sample,
                               lambda a: 1 if mesh is None else mesh.size)
        renderer.sample_batch = wrap(renderer.sample_batch, lambda a: a[2])

    def unwrap(self, renderer):
        if self.active():
            self._stop()
        renderer.__dict__.pop("sample", None)
        renderer.__dict__.pop("sample_batch", None)

    def export(self):
        """The trace's events, reduced (``Events``), or None when nothing
        was profiled. The Chrome trace goes to a file under TMPDIR that is
        deleted once read."""
        if self.prof is None:
            return None
        fd, path = tempfile.mkstemp(suffix=".json", prefix="vtbench-trace-")
        os.close(fd)
        try:
            self.prof.export_chrome_trace(path)
            raw = json.loads(Path(path).read_text())
        finally:
            os.unlink(path)
        return Events(raw.get("traceEvents", raw), self.n)


def _union(spans):
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy


class Events:
    """The profiled slice: device activity by card, host spans by name,
    times in microseconds of the trace's clock. ``requests``: the
    requests the slice profiled."""

    def __init__(self, events, requests: int):
        self.requests = requests
        self.device = {}  # card -> [(start, end, name, cat)]
        self.spans = {}  # span name -> [(start, end)]
        self.host = []  # (start, end, name) of host ops and spans
        for e in events:
            if e.get("ph") != "X" or "dur" not in e:
                continue
            cat = e.get("cat", "")
            a = float(e["ts"])
            b = a + float(e["dur"])
            if cat in DEVICE_CATS:
                card = int(e.get("args", {}).get("device", e.get("pid", 0)))
                self.device.setdefault(card, []).append(
                    (a, b, e.get("name", ""), cat))
            elif cat in ("user_annotation",):
                self.spans.setdefault(e["name"], []).append((a, b))
                self.host.append((a, b, e["name"]))
            elif cat in ("cpu_op", "cuda_runtime", "python_function"):
                self.host.append((a, b, e.get("name", "")))
        for v in self.device.values():
            v.sort()
        w = self.spans.get(WINDOW)
        self.window = (w[0][0], w[0][1]) if w else None

    @property
    def window_us(self) -> float:
        return 0.0 if self.window is None else self.window[1] - self.window[0]

    def in_window(self, card):
        a, b = self.window
        return [e for e in self.device.get(card, []) if a <= e[0] < b]

    def busy_us(self, card) -> float:
        a, b = self.window
        return _union((max(s, a), min(e, b)) for s, e, _, _ in
                      self.in_window(card))

    def cards(self):
        return sorted(self.device)

    def idle_share(self, cards: int) -> float | None:
        """Percent of the profiled slice in which a card ran nothing, the
        mean over the ``cards`` cards the run used (a card with no
        activity is idle throughout)."""
        if self.window is None or not self.device:
            return None
        busy = sum(self.busy_us(c) for c in self.cards())
        return 100.0 * (1.0 - busy / max(cards, len(self.device))
                        / self.window_us)

    def within(self, span_name, card=None):
        """For each span of this name: the device events that start in
        it (on ``card``, or on every card)."""
        cards = self.cards() if card is None else [card]
        out = []
        for a, b in self.spans.get(span_name, []):
            out.append([e for c in cards for e in self.device.get(c, [])
                        if a <= e[0] < b])
        return out

    def breakdown(self):
        """The device operations that took most time, and the longest idle
        gaps summed by what the host was doing (the innermost host op or
        span open at the gap's start), each the top 10, in seconds."""
        ops, gaps = {}, {}
        for c in self.cards():
            evs = self.in_window(c)
            for a, b, name, _ in evs:
                ops[name] = ops.get(name, 0.0) + (b - a) * 1e-6
            t, starts = self.window[0], []
            for a, b, _, _ in evs + [(self.window[1], self.window[1], "", "")]:
                if a > t:
                    starts.append((t, a - t))
                t = max(t, b)
            for (t, g), name in zip(starts, _hosts_at(self.host,
                                                      [s for s, _ in starts])):
                gaps[name] = gaps.get(name, 0.0) + g * 1e-6
        top = lambda d: [[k[:200], v] for k, v in sorted(  # noqa: E731
            d.items(), key=lambda kv: -kv[1])[:10]]
        return dict(device_ops=top(ops), idle_gaps=top(gaps))


def _hosts_at(host, times):
    """For each of the increasing ``times``: the innermost (latest begun)
    host interval open then, by one sweep."""
    host = sorted(host)
    out, stack, i = [], [], 0
    for t in times:
        while i < len(host) and host[i][0] <= t:
            stack.append(host[i])
            i += 1
        while stack and stack[-1][1] <= t:
            stack.pop()
        out.append(stack[-1][2] if stack else "(no host op)")
    return out


def union_us(events) -> float:
    """The union of the events' intervals, in microseconds."""
    return _union((a, b) for a, b, _, _ in events)


def is_k9(name: str) -> bool:
    """One of K9's stage kernels (``path_<stage>_kernel``)."""
    return "path_" in name and "_kernel" in name


def k9_us(groups) -> float:
    """The summed device time of K9's kernels in groups of events."""
    return sum(b - a for g in groups for a, b, name, cat in g
               if cat == "kernel" and is_k9(name))
