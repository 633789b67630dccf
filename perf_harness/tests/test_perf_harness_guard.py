"""No module of the harness loads JAX, the JAX package, and the reference
not even the port: each checked in a fresh interpreter, top-level names
compared whole (the port's name begins with the JAX package's)."""

import json
import os
import subprocess
import sys

import pytest

from harness_tiny import HARNESS, REPO

MODULES = sorted(n[:-3] for n in os.listdir(HARNESS) if n.endswith(".py"))
BANNED = {"jax", "jaxlib", "flax", "climate_sim_tpu"}


def loaded_after(imports):
    code = ("import json, sys\n" + "".join(f"import {m}\n" for m in imports)
            + "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([HARNESS, REPO])))
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_every_harness_module_leaves_jax_out():
    top = loaded_after(MODULES)
    assert not top & BANNED


def test_the_reference_leaves_the_program_out():
    top = loaded_after(["reference"])
    assert not top & (BANNED | {"climate_sim_tpu_torch"})


def test_banned_names_are_compared_whole():
    import cell

    assert cell.banned_modules(["climate_sim_tpu_torch.ops", "numpy"]) == []
    assert cell.banned_modules(["climate_sim_tpu.ops", "jax._src", "jaxtyping"]) == [
        "climate_sim_tpu", "jax"]


@pytest.mark.parametrize("name", ["gpoint_per_s", "setup_s", "stencil_roofline_pct",
                                  "device_idle_pct", "call_overhead_ms", "loop_idle_pct",
                                  "launch_host_us", "first_call_s"])
def test_each_metric_reader_leaves_jax_out(name):
    top = loaded_after([f"layout; layout.Layout({REPO!r}).reader({name!r})"])
    assert not top & BANNED
