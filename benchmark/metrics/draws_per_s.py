"""draws_per_s: chains x sampling iterations completed in the window, over
the window's seconds (host clock, the window closed by a device sync)."""


def read(run):
    draws = run.counters.get("draws")
    return None if draws is None else draws / run.window_s
