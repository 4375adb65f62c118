"""``preview_events.fly``: device events (kernels, copies, sets) that
start inside the benchmark's span around a move's ``preview_frame``,
the mean over the profiled moves."""


def read(run):
    if run.events is None:
        return None
    per = [len(e) for e in run.events.within("vtb:preview")]
    return sum(per) / len(per) if per else None
