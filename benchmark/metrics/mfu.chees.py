"""mfu.chees: the operations the algorithm needs in the traced window (every
trajectory by the frozen counters, and the work around them counted from
the plain reference's algorithm: benchmark/opcount.py), over the window's
seconds at the card's float32 peak, the precision the configurations
state."""
from benchmark.opcount import PEAK_FP32

HEAD = "chees"


def read(run):
    if run.trace is None or run.head.name != HEAD or not run.ops.get("step"):
        return None
    return 100.0 * run.ops["step"] / (run.window_s * PEAK_FP32)
