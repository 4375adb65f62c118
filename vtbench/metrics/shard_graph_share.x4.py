"""``shard_graph_share.x4``: the share of a sample-sharded step's shard
calls that replayed a CUDA graph in the profiled slice, replays over
calls (1: every shard a replay; 0: every shard ran eagerly on its
thread). Read in this process after the window from the port's counter
registry, where ``dist/shard.py`` counts ``shard.graph_replays.<k>``
(0 for an eager call) beside ``shard.calls.<k>`` for the k-th card while
the profiler records. A port without the registry or the replay counts
gives nothing. Standard error gives each card's replays and captures."""

import sys

PORT = "voxtracer_torch.utils.profiling"
CALLS, REPLAYS = "shard.calls.", "shard.graph_replays."
CAPTURES = "shard.graph_captures."


def read(run):
    if run.events is None:
        return None
    counts = getattr(sys.modules.get(PORT), "counts", None)
    if counts is None:
        return None
    c = counts()
    cards = sorted(int(k[len(REPLAYS):]) for k in c if k.startswith(REPLAYS))
    calls = sum(c.get(f"{CALLS}{k}", 0) for k in cards)
    if not calls:
        return None
    for k in cards:
        print(f"shard_graph_share: card {k}: {c[f'{REPLAYS}{k}']} replays "
              f"of {c.get(f'{CALLS}{k}', 0)} calls, "
              f"{c.get(f'{CAPTURES}{k}', 0)} captures",
              file=sys.stderr, flush=True)
    return sum(c[f"{REPLAYS}{k}"] for k in cards) / calls
