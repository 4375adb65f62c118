"""``shard_host_ms.x4``: the host time of one shard's call in a
sample-sharded step, in ms: what it costs a shard thread to enqueue its
card's ``render_sample``. Read in this process after the window from the
port's counter registry, whose ``shard.host_us.<k>`` and
``shard.calls.<k>`` the threads of ``dist/shard.py:run_shards`` count for
the k-th card while the profiler records: the sum of the microseconds
over the sum of the calls. The run has the port loaded already; a port
without the registry or these counts gives nothing. Standard error gives
each card's value."""

import sys

PORT = "voxtracer_torch.utils.profiling"
HOST, CALLS = "shard.host_us.", "shard.calls."


def read(run):
    if run.events is None:
        return None
    counts = getattr(sys.modules.get(PORT), "counts", None)
    if counts is None:
        return None
    c = counts()
    cards = sorted(int(k[len(CALLS):]) for k in c if k.startswith(CALLS))
    calls = sum(c[f"{CALLS}{k}"] for k in cards)
    if not calls:
        return None
    for k in cards:
        n = c[f"{CALLS}{k}"]
        print(f"shard_host_ms: card {k}: {n} calls, "
              f"{c.get(f'{HOST}{k}', 0) * 1e-3 / max(n, 1):.4f} ms a call",
              file=sys.stderr, flush=True)
    return sum(c.get(f"{HOST}{k}", 0) for k in cards) * 1e-3 / calls
