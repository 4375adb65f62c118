"""``recast_lanes.edit``: the lanes the bounce loop K9 queued for its two
re-cast stages (``recast`` and ``shadow_recast``: the edited engine's SVO
re-casts of the lanes that can see an edit box), summed over bounces, a
profiled sample (a K9 call at batch 1). Read in this process after the
window from the port's counter registry, whose ``k9.queued.<queue>``
counts sum the per-bounce queue lengths K9 kept while the profiler
recorded (``k9.queued.calls``: the calls kept). The run has the port
loaded already; a port without the registry gives nothing. Standard
error gives every queue a sample."""

import sys

PORT = "voxtracer_torch.utils.profiling"
QUEUES = ("live", "march", "sun_march", "shadow", "recast", "shadow_recast")


def read(run):
    if run.events is None:
        return None
    counts = getattr(sys.modules.get(PORT), "counts", None)
    if counts is None:
        return None
    c = counts()
    calls = c.get("k9.queued.calls", 0)
    if not calls:
        return None
    per = {q: c.get(f"k9.queued.{q}", 0) / calls for q in QUEUES}
    spans = len(run.events.spans.get("vt:sample", []))
    print(f"recast_lanes: {calls} K9 calls kept, {spans} vt:sample spans; "
          "lanes queued a call: "
          + ", ".join(f"{q} {v:.1f}" for q, v in per.items()),
          file=sys.stderr, flush=True)
    return per["recast"] + per["shadow_recast"]
