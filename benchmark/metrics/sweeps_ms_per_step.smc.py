"""sweeps_ms_per_step.smc: device milliseconds of the program's smc.sweeps
span (the trans-d sweeps) a temperature step, over the smc.step spans of
the traced window."""
from benchmark.program_trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "smc", "smc.step", "smc.sweeps", "device_ms")
