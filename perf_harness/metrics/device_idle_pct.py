"""device_idle_pct: 1 - (device busy time a step, traced job) / (wall time a
step, untraced window), mean over cards, in percent.

The traced job is one more job of the window's shape (its steps, its
per-call work), so both sides a step carry the same share of each call's
set-up.  Busy time is the union of the card's traced events, plus the
mean stencil event for each launch the program counted that the trace
lost.  The wall a step comes from the untraced window, so the profiler's
own host cost does not read as idle.  None without a trace."""


def read(summary):
    t = summary["trace"]
    if not t or not t["cards"]:
        return None
    w = summary["window"]
    wall_step = w["wall_s"] / w["steps"]
    idle = []
    for c in t["cards"]:
        busy = c["busy_us"]
        lost = c["stencil_launches"] - c["stencil_events"]
        if lost > 0 and c["stencil_events"]:
            busy += lost * c["stencil_sum_us"] / c["stencil_events"]
        idle.append(1.0 - busy / 1e6 / t["steps"] / wall_step)
    return 100.0 * sum(idle) / len(idle)
