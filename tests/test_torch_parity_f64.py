"""The reference-parity deployment (``configs/parity_f64.yaml``: float64,
Dirichlet on all four sides, D 0.05, v (0.5, 0), dt 0.1) through the
port's ``run_simulation`` on the CPU, against the benchmark's plain
reference (``perf_harness/reference.py``: plain torch, importing neither
JAX nor the port), both its step-by-step and its separable evaluation.

Each span of ``out_every`` steps ends in a 4-step remainder pass (K1's
plain version on ``kernel=pallas``, 12 passes of 8 and one of 4 a span of
100), and the hotspots lie on the bottom, top and right edges.  The same
run in f32 is off by more than the tolerance, and with no periodic side
``strict_reference_compat`` changes nothing, bit for bit.
"""

import contextlib
import importlib.util
import io
import os
import sys

import pytest
import torch

from climate_sim_tpu_torch.config import merged_config
from climate_sim_tpu_torch.ops.cuda_stencil import pass_schedule
from climate_sim_tpu_torch.runtime.driver import run_simulation

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PARITY = os.path.join(REPO, "configs", "parity_f64.yaml")
# Loaded by path under its own name, so that the harness's folder (whose
# module names shadow the standard library's ``trace``) stays off sys.path.
_spec = importlib.util.spec_from_file_location(
    "perf_harness_reference", os.path.join(REPO, "perf_harness", "reference.py"))
R = sys.modules[_spec.name] = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(R)

# f64 round-off over a few hundred steps: each step rounds at ~1.1e-16 of
# the field, and the gaps of the port (its five collapsed weights, FMA
# order) and of the reference add up to some 1e-14 of the amplitude; f32's
# rounding (~6e-8 a step) is out by orders of magnitude more.
TOL = 1e-12

# (nx, ny, steps, out_every, hotspot (A, sigma_frac, xc_frac, yc_frac),
#  kernel, precision, strict_reference_compat).  K1 takes k = 8 from 256
# cells a side (pick_steps_per_pass); smaller grids run the per-step path.
CASES = {
    "square-bottom-edge": (256, 256, 300, 100, (1.3, 0.1, 0.3, 0.02), "pallas", "f64", False),
    "wide-top-edge": (288, 256, 228, 76, (0.7, 0.15, 0.5, 0.98), "pallas", "f64", False),
    "tall-right-edge": (256, 288, 300, 100, (1.9, 0.1, 0.9, 0.5), "pallas", "f64", False),
    "small-square-corner": (64, 64, 200, 100, (0.5, 0.2, 0.95, 0.05), "auto", "f64", False),
    "small-wide-right-edge": (96, 40, 300, 100, (1.1, 0.12, 0.9, 0.6), "auto", "f64", False),
    "square-f32-exceeds": (256, 256, 300, 100, (1.3, 0.1, 0.3, 0.02), "pallas", "f32", False),
    "wide-compat-inert": (288, 256, 228, 76, (0.7, 0.15, 0.5, 0.98), "pallas", "f64", True),
}


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: the grids are small, and the workers of a
    parallel run share the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def config(nx, ny, steps, out_every, spot, kernel, precision, compat):
    A, sigma, xc, yc = spot
    return merged_config(PARITY, [
        f"--nx={nx}", f"--ny={ny}", f"--steps={steps}", f"--out_every={out_every}",
        f"--kernel={kernel}", f"--precision={precision}",
        f"--strict_reference_compat={str(compat).lower()}", "--ic.mode=preset",
        "--ic.preset=gaussian_hotspot", f"--ic.A={A}", f"--ic.sigma_frac={sigma}",
        f"--ic.xc_frac={xc}", f"--ic.yc_frac={yc}"])


def run_port(cfg):
    with contextlib.redirect_stdout(io.StringIO()):
        return run_simulation(cfg, ["cpu"], write_output=False).u


@pytest.mark.parametrize("case", list(CASES))
def test_parity_f64_against_the_plain_reference(case):
    nx, ny, steps, out_every, spot, kernel, precision, compat = CASES[case]
    cfg = config(*CASES[case])
    if kernel == "pallas":  # every span ends in a 4-step remainder pass
        assert pass_schedule(cfg, out_every)[-2:] == [8, 4] and steps % out_every == 0
    s = R.Scheme(nx, ny, 1.0, 1.0, 0.05, 0.5, 0.0, 0.1, ("dirichlet",) * 4)
    h = R.Hotspot(*spot)
    plain = R.evolve_plain(h.field(s), s, steps)
    separable = R.evolve_separable([h], s, steps)[0]
    assert float((plain - separable).abs().max()) <= TOL * h.A
    u = run_port(cfg)
    assert u.dtype == (torch.float64 if precision == "f64" else torch.float32)
    for ref in (plain, separable):
        err = R.max_error(u, ref) / h.A
        if precision == "f64":
            assert err <= TOL, err
        else:
            assert err > TOL, err
    if compat:
        assert torch.equal(u, run_port(config(nx, ny, steps, out_every, spot, kernel,
                                              precision, False)))
