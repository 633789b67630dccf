#!/usr/bin/env python3
"""Line-coverage gate of the PyTorch port (stdlib only, no coverage.py).

The port's counterpart of ``scripts/coverage_check.py``: ``sys.monitoring``
(PEP 669, Python 3.12+) records the lines executed under
``climate_sim_tpu_torch/`` while the port's tests (``tests/test_torch_*.py``
by default) run in this process; each module's executable lines come from
its code objects (``co_lines``).  Python processes the tests start (the
multi-process tests' ranks, the tools' fresh-process checks) are followed
as ``coverage.py`` follows them with ``COVERAGE_PROCESS_START``: a
``sitecustomize`` on their ``PYTHONPATH`` records their lines the same way
and writes them out when the process exits normally; a process that is
killed, or that leaves by ``os._exit``, adds nothing.

The port's tests compare it with the JAX package, so this gate needs JAX
and runs on a CPU machine with the test suite's environment; it is not
meant for the card.  Lines that only a card runs (CUDA streams, events
and devices in ``benchproto.py``, ``runtime/driver.py`` and
``runtime/distributed.py``) are reported as missed; ``chip_smoke.py`` runs
them.

Usage:
    JAX_PLATFORMS=cpu python scripts/torch_coverage_check.py [--show-missing]
        [--fail-under 90] [--target DIR ...] [pytest args...]

Exit codes: pytest's own when it fails; 2 when the total line coverage is
under --fail-under (default 90); else 0.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import sys
import tempfile
import textwrap
from collections import defaultdict
from typing import Dict, Iterable, List, Optional, Sequence, Set, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TARGET_DIRS = (os.path.join(REPO_ROOT, "climate_sim_tpu_torch"),)

TOOL_ID = sys.monitoring.COVERAGE_ID

# (path shown, executable lines, lines hit, percent, missed lines)
Row = Tuple[str, int, int, float, List[int]]

# The children's recorder: started from a ``sitecustomize`` that the gate
# puts first on PYTHONPATH, told where to write and what to record by two
# environment variables.  It takes tool id 3 (free for any tool), so that a
# gate run in a followed child still gets COVERAGE_ID.
CHILD_TOOL_ID = 3
CHILD_DIR_ENV = "TORCH_COVERAGE_CHILD_DIR"
CHILD_TARGETS_ENV = "TORCH_COVERAGE_TARGETS"
SITECUSTOMIZE = textwrap.dedent(f"""\
    import os, sys

    def _record_lines():
        out = os.environ.get({CHILD_DIR_ENV!r})
        targets = tuple(t for t in os.environ.get({CHILD_TARGETS_ENV!r}, "").split(os.pathsep) if t)
        if not out or not targets:
            return
        import atexit, json
        mon, executed = sys.monitoring, {{}}

        def on_line(code, lineno):
            if code.co_filename.startswith(targets):
                executed.setdefault(code.co_filename, set()).add(lineno)
            return mon.DISABLE

        def dump():
            mon.set_events({CHILD_TOOL_ID}, 0)
            path = os.path.join(out, f"{{os.getpid()}}.json")
            with open(path, "w") as f:
                json.dump({{k: sorted(v) for k, v in executed.items()}}, f)

        mon.use_tool_id({CHILD_TOOL_ID}, "torch_coverage_check child")
        mon.register_callback({CHILD_TOOL_ID}, mon.events.LINE, on_line)
        mon.set_events({CHILD_TOOL_ID}, mon.events.LINE)
        atexit.register(dump)

    _record_lines()
""")


def executable_lines(path: str) -> Set[int]:
    """Every source line that carries bytecode, from the compiled module's
    code objects (line 0, where a module's code starts, is no source line:
    the JAX gate counts it, and it is missed for modules whose first
    statement is not on line 1)."""
    with open(path, "rb") as fh:
        code = compile(fh.read(), path, "exec")
    lines: Set[int] = set()
    stack = [code]
    while stack:
        co = stack.pop()
        lines.update(ln for _s, _e, ln in co.co_lines() if ln)
        stack.extend(c for c in co.co_consts if hasattr(c, "co_lines"))
    return lines


def follow_children(targets: Sequence[str], work: str) -> str:
    """Make the Python processes started from now on record their lines
    under ``work``; returns the directory they write to."""
    site, out = os.path.join(work, "site"), os.path.join(work, "lines")
    os.makedirs(site)
    os.makedirs(out)
    with open(os.path.join(site, "sitecustomize.py"), "w") as f:
        f.write(SITECUSTOMIZE)
    os.environ[CHILD_DIR_ENV] = out
    os.environ[CHILD_TARGETS_ENV] = os.pathsep.join(targets)
    os.environ["PYTHONPATH"] = os.pathsep.join(
        p for p in (site, os.environ.get("PYTHONPATH")) if p)
    return out


def merge_children(out: str, executed: Dict[str, Set[int]]) -> int:
    """Add the children's recorded lines to ``executed``; returns how many
    children wrote theirs."""
    files = glob.glob(os.path.join(out, "*.json"))
    for path in files:
        with open(path) as f:
            for fn, lines in json.load(f).items():
                executed[fn].update(lines)
    return len(files)


def record(pytest_args: Sequence[str], targets: Sequence[str]
           ) -> Tuple[int, Dict[str, Set[int]]]:
    """Run pytest in this process with line events on, following the
    Python processes it starts; returns (pytest's exit code, {file under a
    target: lines executed})."""
    targets = tuple(os.path.join(os.path.abspath(t), "") for t in targets)
    executed: Dict[str, Set[int]] = defaultdict(set)

    def on_line(code, lineno):
        if code.co_filename.startswith(targets):
            executed[code.co_filename].add(lineno)
        # One event per code location is enough.
        return sys.monitoring.DISABLE

    saved = {k: os.environ.get(k) for k in (CHILD_DIR_ENV, CHILD_TARGETS_ENV, "PYTHONPATH")}
    with tempfile.TemporaryDirectory(prefix="torch_coverage_") as work:
        out = follow_children(targets, work)
        sys.monitoring.use_tool_id(TOOL_ID, "torch_coverage_check")
        sys.monitoring.register_callback(TOOL_ID, sys.monitoring.events.LINE, on_line)
        sys.monitoring.set_events(TOOL_ID, sys.monitoring.events.LINE)
        try:
            import pytest

            rc = int(pytest.main(list(pytest_args)))
        finally:
            sys.monitoring.set_events(TOOL_ID, 0)
            sys.monitoring.free_tool_id(TOOL_ID)
            for k, v in saved.items():
                if v is None:
                    os.environ.pop(k, None)
                else:
                    os.environ[k] = v
        children = merge_children(out, executed)
    print(f"\n{children} child processes followed")
    return rc, executed


def report(executed: Dict[str, Set[int]], targets: Iterable[str]
           ) -> Tuple[List[Row], int, int]:
    """(a row per .py file under the targets, lines hit, executable lines);
    a file's path is shown from its target's parent directory."""
    rows: List[Row] = []
    total_exec = total_hit = 0
    for target in targets:
        target = os.path.abspath(target)
        base = os.path.dirname(target)
        for dirpath, _dirs, files in sorted(os.walk(target)):
            if "__pycache__" in dirpath:
                continue
            for fn in sorted(f for f in files if f.endswith(".py")):
                path = os.path.join(dirpath, fn)
                lines = executable_lines(path)
                hit = executed.get(path, set()) & lines
                total_exec += len(lines)
                total_hit += len(hit)
                pct = 100.0 * len(hit) / len(lines) if lines else 100.0
                rows.append((os.path.relpath(path, base), len(lines), len(hit), pct,
                             sorted(lines - hit)))
    return rows, total_hit, total_exec


def compress(lines: List[int]) -> str:
    """Sorted line numbers as ranges: 3-5, 9, 12-14."""
    out = []
    start = prev = lines[0]
    for ln in lines[1:] + [None]:
        if ln is not None and ln == prev + 1:
            prev = ln
            continue
        out.append(str(start) if start == prev else f"{start}-{prev}")
        if ln is not None:
            start = prev = ln
    return ", ".join(out)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--fail-under", type=float, default=90.0)
    ap.add_argument("--show-missing", action="store_true")
    ap.add_argument("--target", action="append", default=None,
                    help="a package directory to measure (repeatable; default"
                         " climate_sim_tpu_torch/)")
    ap.add_argument("pytest_args", nargs="*", default=[])
    a = ap.parse_args(argv)

    targets = a.target or list(TARGET_DIRS)
    pytest_args = a.pytest_args or [
        *sorted(glob.glob(os.path.join(REPO_ROOT, "tests", "test_torch_*.py"))), "-q"]
    rc, executed = record(pytest_args, targets)
    rows, hit, total = report(executed, targets)

    width = max((len(r[0]) for r in rows), default=10)
    print(f"\n{'file':<{width}}  stmts   hit    cover")
    for rel, n, h, pct, missing in rows:
        print(f"{rel:<{width}}  {n:5d}  {h:5d}  {pct:6.1f}%")
        if a.show_missing and missing:
            print(f"  missing: {compress(missing)}")
    total_pct = 100.0 * hit / total if total else 100.0
    print(f"\nTOTAL: {hit}/{total} lines = {total_pct:.2f}%")

    if rc != 0:
        print("pytest FAILED", file=sys.stderr)
        return rc
    if total_pct < a.fail_under:
        print(f"coverage {total_pct:.2f}% < fail-under {a.fail_under}%", file=sys.stderr)
        return 2
    print(f"coverage gate OK (>= {a.fail_under}%)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
