"""ess_per_s: the effective sample size of the total flux over all the
window's draws (every chain), over the window's seconds."""


def read(run):
    if run.counters.get("draws") is None:
        return None
    return run.ess() / run.window_s
