"""relocate_ms_per_iter.chees: device milliseconds of the program's
chees.relocate span (the relocate sweep and the grad refresh) over the
chees.iteration spans of the traced window."""
from benchmark.program_trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "chees", "chees.iteration", "chees.relocate", "device_ms")
