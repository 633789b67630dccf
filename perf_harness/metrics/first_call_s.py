"""first_call_s: the process's first call of the program, the set-up's
warm-up job, on the program's span ``climate.call``, the largest over
ranks: the kernel library's build or load (``climate.library``, inside
it), the card's and the process group's first use, and the first capture.
It is the part of ``setup_s`` that the program's own first call spends.
None without the program's spans (``--trace 0``)."""


def read(summary):
    p = summary["program"]
    if not p:
        return None
    return max(r["spans_s"]["climate.call"] for r in p["warmup"])
