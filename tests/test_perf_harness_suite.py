"""The benchmark harness's own CPU tests (``perf_harness/tests``), run in a
child process: one case here for each of the harness's cases.

This suite's conftest loads JAX, and a harness run refuses a process that
has loaded it, so the harness's tests cannot run in this process.  The
child runs them once, in the repository's root, with its own pytest
(cases for the card, marked ``gpu``, left out), and each case here reads
its own outcome from the child's ``--junitxml``.  The cases are listed by
the child's ``--collect-only``, which depends on the files alone, so every
worker of a parallel run collects the same cases.
"""

import os
import subprocess
import sys
import xml.etree.ElementTree as ET

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HARNESS_TESTS = "perf_harness/tests"
CHILD_ARGS = ["-m", "not gpu", "-p", "no:cacheprovider", "-p", "no:randomly"]
COLLECT_TIMEOUT_S = 300
RUN_TIMEOUT_S = 1300  # inside the 1470 s limit of ROADMAP.md's tier-1 command


def _child(args, timeout):
    # One thread a process: the child and its rank processes share the
    # cores with the other workers of a parallel run.
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.update(OMP_NUM_THREADS="1", MKL_NUM_THREADS="1")
    return subprocess.run([sys.executable, "-m", "pytest", HARNESS_TESTS, *CHILD_ARGS, *args],
                          cwd=REPO, env=env, capture_output=True, text=True, timeout=timeout)


def _collected():
    out = _child(["--collect-only", "-q"], COLLECT_TIMEOUT_S)
    ids = [line.strip() for line in out.stdout.splitlines() if "::" in line]
    if out.returncode != 0 or not ids:
        raise RuntimeError(f"collecting {HARNESS_TESTS} failed ({out.returncode}):\n"
                           f"{out.stdout[-4000:]}\n{out.stderr[-4000:]}")
    return ids


def _junit_key(nodeid):
    """(classname, name) of a node id in pytest's junit XML."""
    parts = nodeid.split("::")
    return (parts[0][:-len(".py")].replace("/", ".") + "".join("." + p for p in parts[1:-1]),
            parts[-1])


CASES = _collected()


@pytest.fixture(scope="module")
def outcomes(tmp_path_factory):
    """(classname, name) -> (outcome, message) of every case the child ran,
    and the tail of its output."""
    xml = tmp_path_factory.mktemp("perf_harness") / "junit.xml"
    out = _child(["-q", f"--junitxml={xml}"], RUN_TIMEOUT_S)
    tail = f"{out.stdout[-3000:]}\n{out.stderr[-3000:]}"
    found = {}
    if xml.exists():
        for case in ET.parse(xml).getroot().iter("testcase"):
            outcome, message = "passed", ""
            for tag in ("failure", "error", "skipped"):
                node = case.find(tag)
                if node is not None:
                    outcome = tag
                    message = f"{node.get('message', '')}\n{(node.text or '')[-3000:]}"
                    break
            found[(case.get("classname"), case.get("name"))] = (outcome, message)
    return found, tail


@pytest.mark.parametrize("nodeid", CASES)
def test_harness_case(outcomes, nodeid):
    found, tail = outcomes
    got = found.get(_junit_key(nodeid))
    if got is None:
        pytest.fail(f"the child ran no {nodeid}; its output ended:\n{tail}")
    outcome, message = got
    if outcome == "skipped":
        pytest.skip(f"skipped in the child: {message.strip()}")
    assert outcome == "passed", f"{nodeid} {outcome} in the child:\n{message}"
