"""host_ms_per_step.smc: host milliseconds of the program's smc.step span a
temperature step (from the step's call to its return: the host's time to
issue the step, not the device's to run it), over the traced window's steps."""
from benchmark.program_trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "smc", "smc.step", "smc.step", "host_ms")
