"""The check against the reference, on the CPU at a tiny size: a sound run
is correct; a run with the timed path broken underneath is not, for each
fault a cell can have; and the control, the program's own bf16 storage
path, fails the limit.  The cell over a mesh runs as four gloo ranks, each
its own process, as a cell over four cards runs its NCCL ranks; a fault
is planted in rank 0, this process, and its tiles carry it into the check.
The readings that set the limit come from the card at the cells' own
sizes (``limits.py``); tests of the control and of the faults there are
marked for the card."""

import json
import os

import pytest
import torch

from harness_tiny import HARNESS, REPO, add_mesh_cell, tiny_layout

import run  # noqa: E402
from layout import Layout  # noqa: E402
from ranks import Ranks  # noqa: E402

import climate_sim_tpu_torch.ops.step as step_mod  # noqa: E402
import climate_sim_tpu_torch.parallel.halo as halo  # noqa: E402
import climate_sim_tpu_torch.runtime.driver as driver  # noqa: E402

SEED = 2**31 + 4099
CELL_SEEDS = (2**31 + 11, 2**31 + 12, 2**31 + 13)


@pytest.fixture
def tiny(tmp_path):
    harness = tiny_layout(str(tmp_path))
    add_mesh_cell(str(tmp_path), harness)
    return Layout(str(tmp_path), harness)


def run_single(tiny):
    return run.run_cell(tiny, "bench4096.single", SEED, 0.2, False, kind="cpu")


def run_mesh(tiny):
    return run.run_cell(tiny, "mesh96.gloo4", SEED, 0.2, False, kind="cpu")


def test_sound_runs_are_correct(tiny):
    for line in (run_single(tiny), run_mesh(tiny)):
        assert line["correct"] is True
        assert line["checks"]["max_err_rel"]["value"] < 1e-5


def test_a_step_that_returns_its_state(tiny, monkeypatch):
    monkeypatch.setattr(step_mod, "fused_step_storage", lambda up, *a: up[1:-1, 1:-1])
    for line in (run_single(tiny), run_mesh(tiny)):
        assert line["correct"] is False and line["failed"] == line["attempted"]


def test_half_the_grid_left_out(tiny, monkeypatch):
    real = step_mod.fused_step_storage

    def half(up, *a):
        out = real(up, *a).clone()
        rows = out.shape[0] // 2
        out[rows:] = up[1 + rows:-1, 1:-1]
        return out

    monkeypatch.setattr(step_mod, "fused_step_storage", half)
    assert run_single(tiny)["correct"] is False


def test_the_exchange_between_tiles_left_out(tiny, monkeypatch):
    real = halo._deliver

    def no_exchange(parts, mesh, moves, out):
        real(parts, mesh, moves, out)
        for (sy, sx), (dy, dx), _ in moves:
            if (sy, sx) != (dy, dx) and out[dy][dx] is not None:
                out[dy][dx] = torch.zeros_like(out[dy][dx])

    monkeypatch.setattr(halo, "_deliver", no_exchange)
    assert run_mesh(tiny)["correct"] is False


def test_an_answer_altered_where_it_is_produced(tiny, monkeypatch):
    real = driver.run_simulation

    def altered(*a, **k):
        result = real(*a, **k)
        u = result.u
        u[u.shape[0] // 2, u.shape[1] // 3] += 1.0  # at least half of any job's amplitude
        return result

    monkeypatch.setattr(driver, "run_simulation", altered)
    line = run_single(tiny)
    assert line["correct"] is False and line["failed"] == line["attempted"]


@pytest.mark.parametrize("workload", ["bench4096.single", "mesh96.gloo4"])
def test_the_control_fails_the_limit(tiny, workload):
    """The program's bf16 storage path (one rounding a step on the CPU)
    against the same reference reads above the configuration's limit."""
    w = tiny.workload(workload)
    config, traffic = tiny.config(w["config"]), tiny.traffic(w["traffic"])
    group = Ranks(int(config["layout"]["ranks"]), config, traffic, SEED, "cpu")
    try:
        bf16 = max(e[0] for e in group.do("probe", SEED, "bf16"))
        f32 = max(e[0] for e in group.do("probe", SEED))
        group.do("leave")
    finally:
        group.close()
    limit = config["limits"]["max_err_rel"]
    assert bf16 > limit > f32


@pytest.mark.gpu
@pytest.mark.parametrize("workload", ["bench4096.single"])
def test_the_control_fails_the_limit_on_the_card(workload):
    """The same at the cell's own size, through the real layout: the bf16
    control above the limit, the configuration's precision below it."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lay = Layout(REPO)
    w = lay.workload(workload)
    if torch.cuda.device_count() < int(w["chips"]):
        pytest.skip(f"needs {w['chips']} CUDA cards")
    config, traffic = lay.config(w["config"]), lay.traffic(w["traffic"])
    group = Ranks(int(config["layout"]["ranks"]), config, traffic, SEED)
    try:
        bf16 = max(e[0] for e in group.do("probe", SEED, "bf16"))
        sound = max(e[0] for e in group.do("probe", SEED))
        group.do("leave")
    finally:
        group.close()
    assert bf16 > config["limits"]["max_err_rel"] > sound


def _k1_returns_its_state(real):
    def same(u, cfg, dt, k):
        return u.clone()
    same.launches = 0  # the wrapper counts its launches on the module's name
    return same


def _k1_leaves_half_out(real):
    def half(u, cfg, dt, k):
        out = real(u, cfg, dt, k)
        out[u.shape[0] // 2:] = u[u.shape[0] // 2:]
        return out
    half.launches = 0
    return half


def _answer_altered(real):
    def altered(*a, **k):
        result = real(*a, **k)
        u = result.u
        u[u.shape[0] // 2, u.shape[1] // 3] += 1.0
        return result
    return altered


CARD_FAULTS = {
    "k1_returns_its_state": ("climate_sim_tpu_torch.ops.cuda_stencil",
                             "multistep_kernel_step", _k1_returns_its_state),
    "k1_leaves_half_out": ("climate_sim_tpu_torch.ops.cuda_stencil",
                           "multistep_kernel_step", _k1_leaves_half_out),
    "answer_altered": ("climate_sim_tpu_torch.runtime.driver", "run_simulation",
                       _answer_altered),
}


@pytest.mark.gpu
@pytest.mark.parametrize("fault", sorted(CARD_FAULTS))
def test_each_fault_fails_the_limit_on_the_card(fault, monkeypatch):
    """Each fault of ``bench4096.single`` planted in the timed path at the
    cell's own size, on three seeds: every reading above the limit.  The
    readings are printed (``-s``) for PERF.md."""
    import importlib

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    lay = Layout(REPO)
    w = lay.workload("bench4096.single")
    config, traffic = lay.config(w["config"]), lay.traffic(w["traffic"])
    module, name, make = CARD_FAULTS[fault]
    mod = importlib.import_module(module)
    monkeypatch.setattr(mod, name, make(getattr(mod, name)))
    group = Ranks(1, config, traffic, SEED)
    try:
        readings = [group.do("probe", seed)[0][0] for seed in CELL_SEEDS]
    finally:
        group.close()
    print(f"fault {fault}: max_err_rel {readings} limit {config['limits']['max_err_rel']}")
    assert min(readings) > config["limits"]["max_err_rel"]


def test_the_real_limits_lie_between_their_readings():
    """Each configuration's limit is the one PERF.md derives: above the
    sound runs' largest reading and below the control's smallest."""
    for name in os.listdir(os.path.join(HARNESS, "configs")):
        with open(os.path.join(HARNESS, "configs", name)) as f:
            c = json.load(f)
        r = c["limits"]["readings"]
        assert r["sound_max"] < c["limits"]["max_err_rel"] < r["control_min"]
