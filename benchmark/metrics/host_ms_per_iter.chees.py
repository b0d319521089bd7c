"""host_ms_per_iter.chees: host milliseconds of the program's chees.iteration
span (from the draw to the stored draw: the host's time to issue an
iteration, not the device's to run it), over the traced window's iterations."""
from benchmark.program_trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "chees", "chees.iteration", "chees.iteration", "host_ms")
