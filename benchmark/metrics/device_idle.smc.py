"""device_idle.smc: the share of the traced window in which no kernel, copy
or set ran on the device (1 - the union of device intervals / the window)."""

HEAD = "smc"


def read(run):
    if run.trace is None or run.head.name != HEAD or run.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.trace.union_s() / run.trace.window_s)
