"""transdim_accept.smc: the share of the trans-d moves kept in the traced
window that were accepted (the program's transdim.accepted over
transdim.moves)."""
from benchmark.program_trace import share


def read(run):
    return share(run, "smc", "transdim.accepted", "transdim.moves")
