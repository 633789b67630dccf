"""launch_host_us: K1's host time a launch, in microseconds: the program's
counter ``k1.host_ns`` (each launch's host time from the wrapper's entry to
the C call) over K1's launches counted meanwhile, summed over ranks.  Read
on each observed job of the window's shape (the calibration job and
``cell.REPEATS`` more, each without the profiler, which adds host time of
its own); the median of the jobs.  None with ``--trace 0``, or without a K1
launch (a CPU run, a cell whose passes are the mesh chunks')."""

import statistics


def read(summary):
    p = summary["program"]
    if not p:
        return None
    per_job = []
    for job in zip(*p["jobs"]):
        launches = sum(r["k1_launches"] for r in job)
        if launches:
            per_job.append(sum(r["counters"].get("k1.host_ns", 0) for r in job) / launches / 1e3)
    return statistics.median(per_job) if per_job else None
