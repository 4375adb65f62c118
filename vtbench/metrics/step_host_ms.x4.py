"""``step_host_ms.x4``: the host length of a sample-sharded step's shards,
in ms: the port's ``vt:shards`` span (``dist/shard.py``, on the caller's
thread from starting the shard threads to the last join), the mean over
the profiled steps. Beside ``shard_host_ms.x4`` it says whether the
shards ran side by side (about one shard's time) or in turn (about the
shards' count times it). Standard error gives the spans against the
profiled steps (``vt:sample`` spans)."""

import sys


def read(run):
    ev = run.events
    if ev is None:
        return None
    shards = ev.spans.get("vt:shards", [])
    if not shards:
        return None
    steps = len(ev.spans.get("vt:sample", []))
    print(f"step_host_ms: {len(shards)} vt:shards spans, {steps} vt:sample "
          "spans", file=sys.stderr, flush=True)
    return sum(b - a for a, b in shards) * 1e-3 / len(shards)
