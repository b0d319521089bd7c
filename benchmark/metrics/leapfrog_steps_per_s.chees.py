"""leapfrog_steps_per_s.chees: every chain's leapfrog steps in the window
(each iteration's real step count, ChEES's jittered length under its cap)
over the window's seconds.  Beside draws_per_s it leaves out how the
window's last block mixes long and short trajectories."""

HEAD = "chees"


def read(run):
    steps = run.counters.get("leapfrog_steps")
    if run.head.name != HEAD or not steps:
        return None
    return steps / run.window_s
