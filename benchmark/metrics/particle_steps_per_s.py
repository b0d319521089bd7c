"""particle_steps_per_s: particles x SMC temperature steps completed in the
window, over the window's seconds."""


def read(run):
    n = run.counters.get("particle_steps")
    return None if n is None else n / run.window_s
