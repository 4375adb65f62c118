"""``device_idle.daycycle``: the share of the profiled slice of the window in which
the card ran nothing (no kernel, copy or set), in percent. From the
device trace: one minus the union of device-activity intervals over the
slice (``trace.Events.idle_share``)."""


def read(run):
    if run.events is None:
        return None
    return run.events.idle_share(run.chips)
