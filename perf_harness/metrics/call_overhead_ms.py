"""call_overhead_ms: a job's call outside its timed loop, in milliseconds:
the program's span ``climate.call`` less its ``climate.loop`` (``prepare``,
the IC's statistics, capture, the warm-up pass, ``finish`` and what lies
between them).  Read on each of a rank's observed jobs of the window's
shape (the calibration job and ``cell.REPEATS`` more, each inside the
program's ``collect()`` without the profiler), whose median is the rank's;
the largest over ranks.  None without the program's spans (``--trace 0``)."""

import statistics


def read(summary):
    p = summary["program"]
    if not p:
        return None
    return 1e3 * max(statistics.median(r["spans_s"]["climate.call"] - r["spans_s"]["climate.loop"]
                                       for r in rank)
                     for rank in p["jobs"])
