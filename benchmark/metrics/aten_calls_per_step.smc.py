"""aten_calls_per_step.smc: host aten ops the profiler saw in the traced
window, over the SMC temperature steps completed in it."""


def read(run):
    if run.trace is None or run.head.name != "smc" or not run.counters.get("steps"):
        return None
    return run.trace.aten_calls / run.counters["steps"]
