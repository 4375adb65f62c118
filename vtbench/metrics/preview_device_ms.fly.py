"""``preview_device_ms.fly``: the device time of a move's preview (the
horizon envelope's build at tier 0 and the frame cast, K4 resumed by
K5), the union of the device activity that starts inside the
benchmark's span around ``preview_frame`` and its copy to the host, in
ms: the median over the profiled moves."""

import statistics

from vtbench import trace


def read(run):
    if run.events is None:
        return None
    per = [trace.union_us(e) * 1e-3 for e in run.events.within("vtb:preview")]
    return statistics.median(per) if per else None
