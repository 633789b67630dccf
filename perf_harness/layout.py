"""The benchmark's files, found by name from ``BENCHMARK.json``.

* ``configs/<config>.json``: a configuration (its path is the ``file`` of
  its entry in ``BENCHMARK.json``): grid, physics, time step, BCs,
  precision, layout (ranks and mesh), the limit of the check, and its
  ``source``, ``reduced`` and ``assumed``.
* ``traffic/<traffic>.json``: a cell's traffic: its configuration, the
  steps of a job (the window's and the traced job's) and of the warm-up,
  ``out_every``,
  output on or off, the chips and the ranges of the jobs' hotspots.
* ``metrics/<metric>.py``: one reader a metric, end-to-end or per-layer,
  with ``read(summary) -> float | None`` (the summary is set out in
  ``run.py``'s docstring).

Nothing here knows a cell, a configuration or a metric by name.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


class Layout:
    def __init__(self, root: str, harness: str = HERE):
        self.root, self.harness = root, harness
        with open(os.path.join(root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)

    def workload(self, name: str) -> dict:
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")

    def config(self, name: str) -> dict:
        for c in self.bench["configs"]:
            if c["name"] == name:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {name!r} in BENCHMARK.json")

    def traffic(self, name: str) -> dict:
        with open(os.path.join(self.harness, "traffic", f"{name}.json")) as f:
            return json.load(f)

    def metrics(self, workload: str, kind: str) -> List[dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports."""
        return [m for m in self.bench[kind]
                if "workloads" not in m or workload in m["workloads"]]

    def reader(self, metric: str) -> Callable[[dict], Optional[float]]:
        path = os.path.join(self.harness, "metrics", f"{metric}.py")
        mod_name = "perf_harness_metric_" + re.sub(r"[^A-Za-z0-9_]", "_", metric)
        spec = importlib.util.spec_from_file_location(mod_name, path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def read(self, workload: str, kind: str, summary: dict) -> Dict[str, dict]:
        """``{name: {"value", "unit"}}`` of each metric whose reader found
        something to read."""
        out = {}
        for m in self.metrics(workload, kind):
            value = self.reader(m["name"])(summary)
            if value is not None:
                out[m["name"]] = {"value": value, "unit": m["unit"]}
        return out
