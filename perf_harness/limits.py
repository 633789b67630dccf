#!/usr/bin/env python3
"""Readings that the limit of a cell's check is set from.

    python3 perf_harness/limits.py --workload <name> --seeds 1,2,3 [--precision bf16] [--steps N]

For each seed, the first job of the window that seed draws, run once
through the program in ``--precision`` (default the configuration's: the
sound runs, whose largest reading is the limit's lower end; ``bf16``, the
program's own lower-precision storage path: the control, whose smallest
reading is its upper end), compared with the plain reference as a run's
check compares it (its final field and, with the traffic's output on,
each record of its snapshot file; the largest gap of them all).  Every
seed in one process (one a rank), so set-up is paid once.  Prints one
line a seed and, last, a JSON object of the readings.  Needs the
card(s) the cell asks for; the benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(1, os.getcwd())

import cell  # noqa: E402
from layout import Layout  # noqa: E402
from ranks import Ranks  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--precision", default=None)
    ap.add_argument("--steps", type=int, default=None)
    a = ap.parse_args(argv)
    import torch

    layout = Layout(os.getcwd())
    w = layout.workload(a.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(w["chips"]):
        print(f"limits: the cell needs {w['chips']} CUDA card(s)", file=sys.stderr)
        return 3
    config = layout.config(w["config"])
    traffic = layout.traffic(w["traffic"])
    group = Ranks(int(config.get("layout", {}).get("ranks", 1)), config, traffic, 0)
    readings = {}
    try:
        for seed in (int(s) for s in a.seeds.split(",")):
            t0 = time.perf_counter()
            errs = group.do("probe", seed, a.precision, a.steps)
            readings[seed] = cell.worst([cell.worst(e) for e in errs])
            print(f"limits: seed {seed} precision {a.precision or config['precision']}"
                  f" max_err_rel {readings[seed]!r} ({time.perf_counter() - t0:.1f} s)",
                  flush=True)
        group.do("leave")
    finally:
        group.close()
    print(json.dumps({"workload": a.workload, "precision": a.precision or config["precision"],
                      "steps": a.steps or traffic["job_steps"], "readings": readings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
