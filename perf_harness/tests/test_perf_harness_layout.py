"""Data-driven loading, the command without a card, and the checkout
without the program."""

import json
import os
import shutil
import subprocess
import sys

from harness_tiny import HARNESS, REPO, add_mesh_cell, tiny_layout

import cell  # noqa: E402
import run  # noqa: E402
from layout import Layout  # noqa: E402

NEW_METRIC = '''"""jobs_in_window: a reader a later change might add."""


def read(summary):
    return float(summary["window"]["jobs"])
'''


def add_cell(root: str, harness: str) -> None:
    """A new configuration, traffic and metric, as new files and new
    entries of BENCHMARK.json only."""
    with open(os.path.join(harness, "configs", "bench_4096.json")) as f:
        cfg = json.load(f)
    cfg.update(name="torus_24", bc={s: "periodic" for s in ("left", "right", "bottom", "top")})
    cfg["grid"].update(nx=24, ny=20)
    with open(os.path.join(harness, "configs", "torus_24.json"), "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(harness, "traffic", "bench4096.single.json")) as f:
        traffic = json.load(f)
    traffic.update(config="torus_24", why="a new cell")
    with open(os.path.join(harness, "traffic", "torus24.single.json"), "w") as f:
        json.dump(traffic, f)
    with open(os.path.join(harness, "metrics", "jobs_in_window.py"), "w") as f:
        f.write(NEW_METRIC)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    bench["configs"].append({"name": "torus_24", "source": "a test", "reduced": [],
                             "file": "perf_harness/configs/torus_24.json", "why": "a test"})
    bench["workloads"].append({"name": "torus24.single", "config": "torus_24",
                               "traffic": "torus24.single", "chips": 1, "why": "a test"})
    bench["end_to_end"].append({"name": "jobs_in_window", "unit": "jobs", "better": "higher",
                                "bound": 0.25, "source": "host_clock",
                                "workloads": ["torus24.single"]})
    with open(path, "w") as f:
        json.dump(bench, f)


def test_new_files_alone_add_a_cell(tmp_path):
    before = {n: open(os.path.join(HARNESS, n)).read()
              for n in os.listdir(HARNESS) if n.endswith(".py")}
    harness = tiny_layout(str(tmp_path))
    add_cell(str(tmp_path), harness)
    line = run.run_cell(Layout(str(tmp_path), harness), "torus24.single", 2**31 + 77, 0.2,
                        False, kind="cpu")
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] >= 1
    assert set(line["metrics"]) == {"gpoint_per_s", "setup_s", "jobs_in_window"}
    assert line["metrics"]["jobs_in_window"]["value"] == line["attempted"]
    assert list(line)[-1] == "checks"
    after = {n: open(os.path.join(HARNESS, n)).read() for n in before}
    assert after == before


def test_traced_dry_run_reports_the_per_layer_metrics_it_can_read(tmp_path):
    harness = tiny_layout(str(tmp_path))
    line = run.run_cell(Layout(str(tmp_path), harness), "bench4096.single", 5, 0.2, True,
                        kind="cpu")
    assert line["correct"] is True
    # the program's spans are read on the CPU; no device events and no K1
    # launch there: the trace readers and launch_host_us find nothing to read
    assert set(line["metrics"]) == {"call_overhead_ms", "first_call_s"}
    assert line["metrics"]["call_overhead_ms"]["value"] > 0
    assert line["metrics"]["first_call_s"]["value"] > 0
    assert line["device"]["busy_s"] == 0.0 and "breakdown" not in line


def test_a_traced_cell_of_ranks_keeps_what_each_rank_recorded(tmp_path, monkeypatch):
    harness = tiny_layout(str(tmp_path))
    cell_name = add_mesh_cell(str(tmp_path), harness)
    lay = Layout(str(tmp_path), harness)
    seen = {}
    real = lay.read

    def keep(workload, kind, summary):
        seen.update(summary)
        return real(workload, kind, summary)

    monkeypatch.setattr(lay, "read", keep)
    line = run.run_cell(lay, cell_name, 7, 0.2, True, kind="cpu")
    assert line["correct"] is True
    program = seen["program"]
    assert sorted(program) == ["jobs", "trace", "warmup"]
    for job, ranks in program.items():
        assert len(ranks) == 4, job
        for got in ranks:
            if job == "jobs":
                # the calibration job and the repeats before the traced one
                assert len(got) == 1 + cell.REPEATS
            for r in got if job == "jobs" else [got]:
                assert r["span_counts"]["climate.call"] == 1
                assert r["spans_s"]["climate.call"] > r["spans_s"]["climate.loop"] > 0
                assert r["k1_launches"] == 0  # no K1 launch is counted on the CPU


def test_collect_passes_the_programs_record_through():
    import program
    from climate_sim_tpu_torch.runtime import tracing

    with program.collect() as record:
        with tracing.span(program.prefix() + "probe"):
            tracing.add("probe", 3)
    assert [s.name for s in record.spans] == ["climate.probe"]
    assert record.counters == {"probe": 3}
    assert not tracing.ON


def test_an_untraced_run_enters_no_collect(tmp_path, monkeypatch):
    import program

    def refused():
        raise AssertionError("collect() entered with --trace 0")

    monkeypatch.setattr(program, "collect", refused)
    harness = tiny_layout(str(tmp_path))
    line = run.run_cell(Layout(str(tmp_path), harness), "bench4096.single", 6, 0.2, False,
                        kind="cpu")
    assert line["correct"] is True
    assert set(line["metrics"]) == {"gpoint_per_s", "setup_s"}


def test_the_command_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, "perf_harness/run.py", "--workload",
                          "bench4096.single", "--seed", "3", "--seconds", "1", "--trace", "0"],
                         cwd=REPO, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA card" in out.stderr


def test_a_checkout_without_the_program_fails(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(HARNESS, tmp_path / "perf_harness",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    code = ("import sys; sys.argv[0] = 'perf_harness/run.py'; sys.path.insert(0, 'perf_harness')\n"
            "import run\n"
            "from layout import Layout\n"
            "print(run.run_cell(Layout('.'), 'bench4096.single', 1, 0.1, False, kind='cpu'))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                         text=True, timeout=300, env={k: v for k, v in os.environ.items()
                                                      if k != "PYTHONPATH"})
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "climate_sim_tpu_torch" in out.stderr
