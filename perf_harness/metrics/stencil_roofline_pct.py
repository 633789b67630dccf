"""stencil_roofline_pct: the least time the traced job's stencil work could
take, over the device time of the stencil kernel in it, summed over cards.

The work is the card's points times the job's steps (roofline.stencil_work),
never the program's pass schedule.  The kernel time is the mean duration of
the kernel's traced events times the launches the program counted, so
events the tracer loses do not raise the share.  None without a trace or
without a stencil event in it."""

import roofline


def read(summary):
    t = summary["trace"]
    if not t:
        return None
    least = spent = 0.0
    for c in t["cards"]:
        if not c["stencil_events"]:
            continue
        nbytes, flops = roofline.stencil_work(c["points"], t["steps"],
                                              int(summary["traffic"]["out_every"]),
                                              summary["config"]["precision"])
        least += roofline.bound_s(nbytes, flops, summary["config"]["precision"],
                                  summary["card"])[0]
        spent += c["stencil_sum_us"] / c["stencil_events"] * c["stencil_launches"] / 1e6
    return 100.0 * least / spent if spent else None
