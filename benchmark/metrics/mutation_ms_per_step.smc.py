"""mutation_ms_per_step.smc: device milliseconds of the program's smc.mutate
span (the mutations on their kernel, B4 or B6, and the step-size
controller) a temperature step, over the smc.step spans of the traced
window."""
from benchmark.program_trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "smc", "smc.step", "smc.mutate", "device_ms")
