"""other_device_ms_per_step.smc: milliseconds of device activity a step
outside the mutation's trajectory kernel (the trans-d sweeps, resampling,
tempering, the likelihoods), the union of those intervals in the traced
window over the steps."""
from benchmark.core import KERNEL_SYMBOLS


def read(run):
    if run.trace is None or run.head.name != "smc" or not run.counters.get("steps"):
        return None
    symbol = KERNEL_SYMBOLS[run.kernel]
    return 1e3 * run.trace.union_s(lambda name: symbol not in name) / run.counters["steps"]
