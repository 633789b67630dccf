"""gpoint_per_s: grid-point updates of the whole window (the global grid's
points times every job's steps) over the window's wall time on the host
clock, in billions a second: all the work over all the time."""


def read(summary):
    w = summary["window"]
    return w["points"] * w["steps"] / w["wall_s"] / 1e9
