"""tempering_ms_per_step.smc: device milliseconds of the program's smc.temper
span (the next delta-beta, the reweight, log Z, the resampling plan and the
gather of the resampled rows) a temperature step, over the smc.step spans
of the traced window."""
from benchmark.program_trace import ms_per_unit


def read(run):
    return ms_per_unit(run, "smc", "smc.step", "smc.temper", "device_ms")
