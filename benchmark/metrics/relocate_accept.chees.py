"""relocate_accept.chees: the share of the relocate attempts in the traced
window that were accepted (the program's chees.relocations_accepted over
chees.relocations)."""
from benchmark.program_trace import share


def read(run):
    return share(run, "chees", "chees.relocations_accepted", "chees.relocations")
