"""``sample_sync_ms.daycycle``: the host's wait for the card inside a
headless sample, in ms: the host time of the synchronising CUDA runtime
calls (``cudaStreamSynchronize``, ``cudaDeviceSynchronize``,
``cudaEventSynchronize`` and the synchronous ``cudaMemcpy``) that start
inside the port's ``vt:sample`` span (``Renderer.sample``), the mean over
the profiled samples. Standard error gives each call's innermost ``vt:``
span, and the profiled samples beside the ``vt:sample`` spans."""

import sys

SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy")


def read(run):
    ev = run.events
    if ev is None:
        return None
    samples = ev.spans.get("vt:sample", [])
    if not samples:
        return None
    syncs = [(a, b, name) for a, b, name in ev.host if name in SYNC]
    spans = sorted((a, b, name) for name, v in ev.spans.items()
                   if name.startswith("vt:") for a, b in v)
    per = [0.0] * len(samples)
    where = {}
    for a, b, name in syncs:
        for i, (s, e) in enumerate(samples):
            if s <= a < e:
                per[i] += (min(b, e) - a) * 1e-3
                inner = max((x for x in spans if x[0] <= a < x[1]),
                            key=lambda x: x[0])[2]
                n, ms = where.get((name, inner), (0, 0.0))
                where[(name, inner)] = (n + 1, ms + (min(b, e) - a) * 1e-3)
    print(f"sample_sync_ms: {len(samples)} vt:sample spans, {ev.requests} "
          "profiled samples", file=sys.stderr, flush=True)
    for (name, inner), (n, ms) in sorted(where.items(),
                                         key=lambda kv: -kv[1][1]):
        print(f"sample_sync_ms: {name} under {inner}: {n} calls, "
              f"{ms / len(samples):.4f} ms a sample", file=sys.stderr,
              flush=True)
    return sum(per) / len(per)
