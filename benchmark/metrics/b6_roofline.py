"""b6_roofline: kernel B6's share of its roofline in the traced window:
the least time its trajectories' operations (the frozen counters of
benchmark/opcount.py, over the real step counts and live stars) take at
the float32 peak, over the kernel's profiled time.  Silent where B6 did
not run."""
from benchmark.core import KERNEL_SYMBOLS
from benchmark.opcount import PEAK_FP32

LABEL = "B6"


def read(run):
    if run.trace is None or run.kernel != LABEL or not run.ops.get(LABEL):
        return None
    t = run.trace.kernel_s(KERNEL_SYMBOLS[LABEL])
    return None if t <= 0 else 100.0 * run.ops[LABEL] / (t * PEAK_FP32)
