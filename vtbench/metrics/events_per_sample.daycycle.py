"""``events_per_sample.daycycle``: device events (kernels, copies, sets)
per ``Renderer.sample`` call of the headless loop, over the profiled
samples: how many launches and transfers one batch-1 sample costs."""


def read(run):
    ev = run.events
    if ev is None or ev.window is None or not ev.requests:
        return None
    n = sum(len(ev.in_window(c)) for c in ev.cards())
    return n / ev.requests if n else None
