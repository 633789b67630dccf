"""The traffic generator: a cell's jobs, drawn from the seed.

A job is one integration a user submits: ``job_steps`` steps of the
configuration from a Gaussian hotspot whose amplitude, width and centre
the traffic file gives as ranges.  Every job of a cell has the same grid
and steps, so every seed asks for the same work and only the field
differs.  Job ``i`` of a stream depends only on the seed, the stream and
``i``, so the window's jobs are the same whatever their number.

Streams: the window's jobs, the set-up's calibration jobs and the traced
run's job are drawn apart, so that none repeats another.
"""

from __future__ import annotations

from typing import List

import numpy as np

from reference import Hotspot

STREAMS = {"window": 0, "setup": 1, "trace": 2}
IC_KEYS = ("A", "sigma_frac", "xc_frac", "yc_frac")


def hotspots(traffic: dict, seed: int, stream: str, count: int, first: int = 0) -> List[Hotspot]:
    """Jobs ``first`` .. ``first + count - 1`` of ``stream``: each a hotspot
    drawn uniformly from the traffic file's ``ic`` ranges."""
    ranges = traffic["ic"]
    out = []
    for i in range(first, first + count):
        rng = np.random.default_rng(np.random.SeedSequence(
            int(seed), spawn_key=(STREAMS[stream], i)))
        out.append(Hotspot(*(float(rng.uniform(*ranges[k])) for k in IC_KEYS)))
    return out


def job_count(seconds: float, job_wall_s: float) -> int:
    """Jobs that fill ``seconds`` at ``job_wall_s`` a job: at least one."""
    return max(1, int(round(seconds / job_wall_s)))
