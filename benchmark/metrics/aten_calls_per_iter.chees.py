"""aten_calls_per_iter.chees: host aten ops the profiler saw in the traced
window, over the ChEES iterations completed in it (the head loop's host
work an iteration)."""


def read(run):
    if run.trace is None or run.head.name != "chees" or not run.counters.get("iterations"):
        return None
    return run.trace.aten_calls / run.counters["iterations"]
