"""sweep_kernel_share.smc: the share of the trans-d moves kept in the traced
window that ran on the sweep kernel (the program's transdim.kernel_moves
over transdim.moves); None where the program counts no moves or has no
such counter."""
from benchmark.program_trace import record, share


def read(run):
    rec = record() if run.head.name == "smc" else None
    if rec is None or "transdim.kernel_moves" not in rec["counters"]:
        return None
    return share(run, "smc", "transdim.kernel_moves", "transdim.moves")
