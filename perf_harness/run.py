#!/usr/bin/env python3
"""Run one cell of the port's benchmark once and print its result line.

    python3 perf_harness/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``BENCHMARK.json``.  The cell's
configuration, traffic and metric readers are found by name
(:mod:`layout`); the run itself is :mod:`cell`'s phases.  The last line of
standard output is one JSON object: ``correct``, ``attempted``,
``failed``, ``metrics`` (the cell's end-to-end metrics with ``--trace 0``,
its per-layer metrics with ``--trace 1``), ``device``, with ``--trace 1``
a ``breakdown``, and last ``checks``, the compared numbers beside their
limits, which are also the last lines of standard error.  ``attempted``
counts each window job's final field and, with the traffic's output on,
each record slot of the last window job's snapshot file (:mod:`cell`).

The summary each metric reader gets:

* ``setup_s``: process start to the start of the window (rank 0's clock);
* ``window``: ``wall_s`` (the longest rank's), ``jobs``, ``steps`` (over
  all jobs), ``points`` (the global grid), ``lines`` (rank 0's program log
  of the window's calls);
* ``trace`` (None with ``--trace 0``): one job of the window's steps,
  traced after it: its ``wall_s``, ``steps``, and
  ``cards``, one :func:`trace.card_summary` a card with its ``rank``, the
  ``stencil_launches`` its rank counted and the ``points`` it holds;
* ``program`` (None with ``--trace 0``): what the program's own tracer
  recorded, each a list with one entry a rank: in the set-up's ``warmup``
  job and in the ``trace`` job one :func:`cell.observed` dict, and under
  ``jobs`` a list of them, of the calibration job and the
  :data:`cell.REPEATS` jobs observed before the traced one;
* ``config``, ``traffic``, ``card`` (the device's name).

Without a card, or with fewer than the cell asks for, it prints no result
and exits 3.  It never runs on the CPU in the card's place.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
if HERE not in sys.path:
    sys.path.insert(0, HERE)
ROOT = os.getcwd()
if ROOT not in sys.path:
    sys.path.insert(1, ROOT)

import cell  # noqa: E402
import jobs  # noqa: E402
import trace as tracing  # noqa: E402
from layout import Layout  # noqa: E402
from ranks import Ranks  # noqa: E402

# A rank that dies must not leave the others waiting in a barrier for the
# program's default ten minutes: a run has six.
SYNC_TIMEOUT_S = "120"


def _clean(x):
    """NaN and infinities as None, so the line is strict JSON."""
    if isinstance(x, float) and not math.isfinite(x):
        return None
    if isinstance(x, dict):
        return {k: _clean(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_clean(v) for v in x]
    return x


def run_cell(layout: Layout, workload: str, seed: int, seconds: float, traced: bool,
             kind: str = "cuda") -> dict:
    """Run the cell and return its result line as a dict.  Tests only:
    ``kind`` "cpu" runs the ranks on the CPU (gloo between them)."""
    w = layout.workload(workload)
    config = layout.config(w["config"])
    traffic = layout.traffic(w["traffic"])
    if traffic["config"] != w["config"]:
        raise ValueError(f"traffic {w['traffic']!r} is for {traffic['config']!r},"
                         f" the workload for {w['config']!r}")
    world = int(config.get("layout", {}).get("ranks", 1))
    group = Ranks(world, config, traffic, seed, kind)
    try:
        cal = group.do("setup", traced)[0]
        count = jobs.job_count(seconds, cal)
        print(f"setup: calibration job {cal:.6f} s -> {count} jobs in the window",
              file=sys.stderr)
        wins = group.do("window", count)
        setup_s = wins[0]["t0"] - T0
        t = time.perf_counter()
        traces = group.do("trace") if traced else None
        t_trace, t = time.perf_counter() - t, time.perf_counter()
        errs_by_rank = group.do("check")
        records = group.do("record_count")[0]
        print(f"phases: trace {t_trace:.3f} s, check {time.perf_counter() - t:.3f} s",
              file=sys.stderr)
        modules = sorted({m for ms in group.do("modules") for m in ms})
        group.do("leave")
    finally:
        group.close()
    modules = sorted(set(modules) | set(cell.banned_modules(list(sys.modules))))
    if modules:
        raise RuntimeError(f"the run loaded {modules}: the benchmark must not load JAX"
                           " or the JAX package")
    errs = [cell.worst(es) for es in zip(*errs_by_rank)]
    window = {"wall_s": max(r["wall_s"] for r in wins), "jobs": count,
              "steps": count * int(traffic["job_steps"]),
              "points": int(config["grid"]["nx"]) * int(config["grid"]["ny"]),
              "lines": wins[0]["lines"]}
    summary = {"setup_s": setup_s, "window": window, "trace": None, "program": None,
               "config": config, "traffic": traffic, "card": _card(kind)}
    print(f"window: {window['jobs']} jobs, {window['steps']} steps in {window['wall_s']:.6f} s"
          f" ({window['wall_s'] / window['steps'] * 1e6:.6f} us a step); setup {setup_s:.3f} s",
          file=sys.stderr)
    device = {"platform": "gpu" if kind == "cuda" else kind, "kind": summary["card"],
              "count": int(w["chips"]),
              "memory_peak_bytes": max(r["memory_peak"] for r in wins)}
    breakdown = None
    if traced:
        cards = [c for t in traces for c in t["cards"]]
        summary["trace"] = {"wall_s": max(t["wall_s"] for t in traces),
                            "steps": traces[0]["steps"], "cards": cards}
        summary["program"] = {job: [t["program"][job] for t in traces]
                              for job in ("warmup", "jobs", "trace")}
        busy = [c["busy_us"] / 1e6 for c in cards]
        device["busy_s"] = sum(busy) / len(busy) if busy else 0.0
        device["window_s"] = summary["trace"]["wall_s"]
        breakdown = tracing.breakdown(cards)
        print(f"trace: {summary['trace']['steps']} steps in {device['window_s']:.6f} s"
              f" ({device['window_s'] / summary['trace']['steps'] * 1e6:.6f} us a step),"
              f" busy {device['busy_s']:.6f} s a card; stencil events/launches by card "
              + ", ".join(f"{c['stencil_events']}/{c['stencil_launches']:g}" for c in cards),
              file=sys.stderr)
        for c in cards:
            print(f"trace: rank {c['rank']}: loop {c['loop_us']:.3f} us, busy"
                  f" {c['loop_busy_us']:.3f} us in it, {c['loop_stencil_events']} stencil"
                  f" events in it; idle by program span {c['span_gaps']}", file=sys.stderr)
        for job, ranks in summary["program"].items():
            for r, got in enumerate(ranks):
                for i, one in enumerate(got if job == "jobs" else [got]):
                    print(f"program: {job} {i} rank {r}: {one}", file=sys.stderr)
    metrics = layout.read(workload, "per_layer" if traced else "end_to_end", summary)
    limit = float(config["limits"]["max_err_rel"])
    steps = cell.record_steps(traffic)
    for i, e in enumerate(errs):
        what = (f"job {i}" if i < count else
                f"record {i - count} (step {steps[i - count]})" if i - count < len(steps) else
                f"record {i - count} (beyond the job's)")
        print(f"check: {what} max_err_rel {e!r} limit {limit!r}", file=sys.stderr)
    line = cell.result(summary, metrics, device, errs, limit, breakdown, records)
    if records is not None:
        print(f"check: records {records[0]} limit {records[1]}", file=sys.stderr)
    print(f"check: max_err_rel {line['checks']['max_err_rel']['value']!r} limit {limit!r}",
          file=sys.stderr)
    return line


def _card(kind: str) -> str:
    import torch

    return torch.cuda.get_device_name(0) if kind == "cuda" else kind


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)

    layout = Layout(ROOT)
    chips = int(layout.workload(a.workload)["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"run: the cell needs {chips} CUDA card(s); torch.cuda.is_available() is"
              f" {torch.cuda.is_available()}, device_count {torch.cuda.device_count()}",
              file=sys.stderr)
        return 3
    os.environ.setdefault("CLIMATE_SIM_SYNC_TIMEOUT_S", SYNC_TIMEOUT_S)
    line = run_cell(layout, a.workload, a.seed, a.seconds, bool(a.trace))
    print(json.dumps(_clean(line)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
