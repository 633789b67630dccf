"""loop_idle_pct: the card's idle share inside the program's timed loop,
in percent: 1 - (busy time inside the span ``climate.loop``) / (its
length), of the traced job, mean over cards.

Busy time is the union of the card's traced events clipped to the loop,
plus the mean stencil event for each launch the program counted that the
trace lost (as ``device_idle_pct`` does), since a lost event would read as
idle; a lost launch is put in the loop, where all but the warm-up pass's
launch lie.  Unlike ``device_idle_pct`` this leaves out the call's work
outside the loop.  None without the loop's span in the trace."""


def read(summary):
    t = summary["trace"]
    if not t:
        return None
    idle = []
    for c in t["cards"]:
        if not c["loop_us"]:
            continue
        busy = c["loop_busy_us"]
        lost = c["stencil_launches"] - c["stencil_events"]
        if lost > 0 and c["stencil_events"]:
            busy += lost * c["stencil_sum_us"] / c["stencil_events"]
        idle.append(1.0 - busy / c["loop_us"])
    return 100.0 * sum(idle) / len(idle) if idle else None
