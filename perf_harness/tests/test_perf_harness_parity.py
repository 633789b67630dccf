"""The reference-parity cell's committed files (``parity_4096_f64``,
``parity4096.f64``): they load through :class:`layout.Layout` as a run
finds them; the reference built from the configuration agrees with the
step-by-step stencil on a tiny copy of its BCs and physics; and at a tiny
size on the CPU the cell runs correct in f64, while the program's own f32
and bf16 paths read above its limit."""

import dataclasses

import pytest

from harness_tiny import REPO, tiny_layout

import reference as R  # noqa: E402
import run  # noqa: E402
from layout import Layout  # noqa: E402
from ranks import Ranks  # noqa: E402

CELL, CONFIG = "parity4096.f64", "parity_4096_f64"
SIDES = ("left", "right", "bottom", "top")
PER_LAYER = {"stencil_roofline_pct", "device_idle_pct", "loop_idle_pct", "launch_host_us",
             "call_overhead_ms", "first_call_s"}
SEED = 2**31 + 2020


def test_the_committed_files_load_through_the_layout():
    lay = Layout(REPO)
    w = lay.workload(CELL)
    assert (w["config"], w["traffic"], int(w["chips"])) == (CONFIG, CELL, 1)
    config, traffic = lay.config(CONFIG), lay.traffic(CELL)
    assert config["name"] == traffic["config"] == CONFIG
    assert config["precision"] == "f64" and config["reduced"] == []
    assert config["bc"] == dict.fromkeys(SIDES, "dirichlet")
    assert (config["grid"]["nx"], config["grid"]["ny"]) == (4096, 4096)
    assert config["layout"] == {"ranks": 1, "mesh": None}
    # bench4096.single's traffic shape: the two cells differ only in what
    # the configuration changes
    bench = lay.traffic("bench4096.single")
    for key in ("job_steps", "warm_steps", "out_every", "output"):
        assert traffic[key] == bench[key], key
    assert [m["name"] for m in lay.metrics(CELL, "end_to_end")] == ["gpoint_per_s", "setup_s"]
    assert {m["name"] for m in lay.metrics(CELL, "per_layer")} == PER_LAYER
    for name in PER_LAYER:
        assert callable(lay.reader(name))


def test_the_configurations_reference_agrees_with_stepping():
    """``Scheme.from_config`` of the committed file, cut to 29x21: the
    separable evaluation against the scheme as written, with hotspots on
    the right, bottom and top edges, to f64 round-off over 300 steps."""
    s = R.Scheme.from_config(Layout(REPO).config(CONFIG))
    assert s.bc == ("dirichlet",) * 4 and (s.D, s.vx, s.vy, s.dt) == (0.05, 0.5, 0.0, 0.1)
    small = dataclasses.replace(s, nx=29, ny=21)
    spots = [R.Hotspot(1.7, 0.1, 0.95, 0.5), R.Hotspot(0.6, 0.2, 0.3, 0.02),
             R.Hotspot(1.1, 0.15, 0.5, 0.97)]
    for h, fast in zip(spots, R.evolve_separable(spots, small, 300)):
        slow = R.evolve_plain(h.field(small), small, 300)
        assert float((slow - fast).abs().max()) <= 1e-12 * h.A


@pytest.fixture
def tiny(tmp_path):
    return Layout(str(tmp_path), tiny_layout(str(tmp_path)))


def test_the_cell_runs_correct_at_a_tiny_size(tiny):
    line = run.run_cell(tiny, CELL, SEED, 0.2, False, kind="cpu")
    limit = tiny.config(CONFIG)["limits"]["max_err_rel"]
    assert line["correct"] is True and line["failed"] == 0
    assert line["checks"]["max_err_rel"]["value"] <= limit / 100


def test_lower_precisions_fail_the_limit_at_a_tiny_size(tiny):
    """The program's f32 path and its bf16 storage path on the same job
    read above the limit; the configuration's f64 a hundredth under it."""
    config = tiny.config(CONFIG)
    group = Ranks(1, config, tiny.traffic(CELL), SEED, "cpu")
    try:
        got = {p: group.do("probe", SEED, p)[0][0] for p in ("f64", "f32", "bf16")}
        group.do("leave")
    finally:
        group.close()
    limit = config["limits"]["max_err_rel"]
    assert got["f64"] <= limit / 100 and got["f32"] > limit and got["bf16"] > limit
