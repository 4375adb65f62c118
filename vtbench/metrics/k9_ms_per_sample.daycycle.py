"""``k9_ms_per_sample.daycycle``: the device time of the bounce loop K9
(its stage kernels ``path_*_kernel``, ``csrc/path_trace.cu``) per sample
of the headless loop, in ms, over the profiled samples."""

from vtbench import trace


def read(run):
    ev = run.events
    if ev is None or ev.window is None or not ev.requests:
        return None
    ms = trace.k9_us(ev.in_window(c) for c in ev.cards()) * 1e-3
    return ms / ev.requests if ms else None
