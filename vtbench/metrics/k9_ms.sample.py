"""``k9_ms.sample``: the device time of the bounce loop K9 (its stage
kernels ``path_*_kernel``) per interactive ``Renderer.sample`` call
(batch 1), in ms: the mean over the profiled samples."""

from vtbench import trace


def read(run):
    if run.events is None:
        return None
    per = [trace.k9_us([e]) * 1e-3 for e in run.events.within("vtb:sample")]
    per = [p for p in per if p]
    return sum(per) / len(per) if per else None
