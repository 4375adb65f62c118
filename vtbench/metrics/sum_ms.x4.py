"""``sum_ms.x4``: the host length of a sample-sharded step's cross-card
sum, in ms: the port's ``vt:shard_sum`` span (``dist/shard.py``: the
shards' radiance copied onto the first card and added in mesh order),
the mean over the profiled steps. Standard error gives the device time
of the peer copies (the profiler's ``Memcpy PtoP`` events) a step, each
card's, over the profiled slice."""

import sys


def read(run):
    ev = run.events
    if ev is None:
        return None
    sums = ev.spans.get("vt:shard_sum", [])
    if not sums:
        return None
    for card in ev.cards():
        peer = [b - a for a, b, name, cat in ev.in_window(card)
                if cat == "gpu_memcpy" and "PtoP" in name]
        print(f"sum_ms: card {card}: {len(peer)} peer copies, "
              f"{sum(peer) * 1e-3 / len(sums):.4f} ms of device time a step",
              file=sys.stderr, flush=True)
    return sum(b - a for a, b in sums) * 1e-3 / len(sums)
