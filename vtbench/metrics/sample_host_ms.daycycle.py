"""``sample_host_ms.daycycle``: the host's own time in a headless sample,
in ms: the host length of the port's ``vt:sample`` span
(``Renderer.sample``) less the synchronising CUDA runtime calls that
start inside it (those ``sample_sync_ms.daycycle`` reads), the mean over
the profiled samples: what it costs the host to enqueue a sample."""

SYNC = ("cudaStreamSynchronize", "cudaDeviceSynchronize",
        "cudaEventSynchronize", "cudaMemcpy")


def read(run):
    ev = run.events
    if ev is None:
        return None
    samples = ev.spans.get("vt:sample", [])
    if not samples:
        return None
    syncs = [(a, b) for a, b, name in ev.host if name in SYNC]
    per = [(e - s - sum(min(b, e) - a for a, b in syncs if s <= a < e))
           * 1e-3 for s, e in samples]
    return sum(per) / len(per)
