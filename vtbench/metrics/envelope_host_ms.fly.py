"""``envelope_host_ms.fly``: the host time of a move's horizon-envelope
builds, in ms: the summed host length of the port's
``vt:sky_env.build.t<tier>`` spans (``Renderer._get_sky_env`` building a
tier's table, and the pyramid on first use) over the profiled moves,
both tiers a move takes (tier 0 at the preview, tier 1 at the sample).
Standard error gives the builds a move by tier and the device union of
the events that start in them."""

import sys

from vtbench import trace

BUILD = "vt:sky_env.build."


def read(run):
    ev = run.events
    if ev is None or not ev.requests:
        return None
    builds = {n: v for n, v in ev.spans.items() if n.startswith(BUILD)}
    if not builds:
        return None
    for name in sorted(builds):
        dev_ms = sum(trace.union_us(e) for e in ev.within(name)) * 1e-3
        host_ms = sum(b - a for a, b in builds[name]) * 1e-3
        n = len(builds[name]) / ev.requests
        print(f"envelope_host_ms: {name}: {n:.3f} builds a move, host "
              f"{host_ms / ev.requests:.4f} ms, device union "
              f"{dev_ms / ev.requests:.4f} ms a move", file=sys.stderr,
              flush=True)
    return sum(b - a for v in builds.values() for a, b in v) * 1e-3 \
        / ev.requests
