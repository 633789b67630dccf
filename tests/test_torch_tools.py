"""The port's tools on the CPU, held to the JAX package's scripts.

* ``climate_sim_tpu_torch/benchproto.py``: the copies (``bench_config``,
  ``auto_reps``) against the originals, and the timing protocol's call
  count;
* ``scripts/torch_generate_ic.py``: the same file bytes as
  ``scripts/generate_ic.py``, a file IC through the port's CLI, the HDF5
  form, and the CDF-5 bytes of the port's codecs against bytes written
  here from the format's specification;
* ``scripts/torch_run_benchmark.py``: the same CSVs as
  ``scripts/run_benchmark.py`` for the same timings, the contention
  control's split, a real CPU sweep, and no CPU run for ``--platform=cuda``;
* ``scripts/torch_hw_conformance.py``: a small CPU run, and a wrong and a
  raising path each failing it;
* ``scripts/torch_hw_rates.py``: the band logic on synthetic rates, and a
  small CPU run;
* every tool imports no JAX: each is imported, and its CPU path run, with
  ``jax`` and ``climate_sim_tpu`` blocked.

Each tool's default device is the card; here (no card) each must fail
rather than run on the CPU, which the ``no_card`` fixture's tests check.
"""

import contextlib
import importlib.util
import io
import os
import struct
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from climate_sim_tpu import benchproto as jbench
from climate_sim_tpu import config as jconfig

from climate_sim_tpu_torch import benchproto as tbench
from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.io.datasets import load_field
from climate_sim_tpu_torch.io.netcdf import NetCDFFile
from climate_sim_tpu_torch.io.snapshots import SnapshotWriter
from climate_sim_tpu_torch.runtime import cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("torch_generate_ic", "torch_run_benchmark", "torch_hw_conformance",
         "torch_hw_rates")


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(main, argv):
    """(exit code, stdout) of a tool's ``main(argv)`` in this process."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a card, and a card is present")


# ------------------------------------------------------------- benchproto


@pytest.mark.parametrize("nx, ny, chunk", [(4096, 4096, 100), (513, 77, 7), (64, 32, 2000)])
def test_bench_config_is_jax_field_by_field(nx, ny, chunk):
    want = jconfig.config_to_dict(jbench.bench_config(nx, ny, chunk))
    got = tconfig.config_to_dict(tbench.bench_config(nx, ny, chunk))
    assert got == want


def test_auto_reps_is_jax_over_sizes():
    for nx in (16, 100, 512, 1000, 4001, 4096, 8192):
        for ny in (16, 504, 4096):
            for chunk in (1, 100, 2000):
                assert tbench.auto_reps(nx, ny, chunk) == jbench.auto_reps(nx, ny, chunk)
    assert tbench.auto_reps(64, 64, 10, window_points=10**6) == \
        jbench.auto_reps(64, 64, 10, window_points=10**6)


@pytest.mark.parametrize("state", ["tensor", "tiles"])
def test_time_best_of_calls_once_then_trials_times_reps(state):
    calls = []

    def fn(u):
        calls.append(1)
        return u

    u = torch.zeros(4) if state == "tensor" else [[torch.zeros(2), None], [None, torch.zeros(2)]]
    best, out = tbench.time_best_of(fn, u, reps=5, trials=3)
    assert len(calls) == 1 + 3 * 5
    assert out is u and 0.0 <= best < 10.0
    assert tbench.cuda_devices(u) == []


def test_warm_up_propagates_a_failure():
    def boom(u):
        raise RuntimeError("kernel library failed to load")

    with pytest.raises(RuntimeError, match="failed to load"):
        tbench.warm_up(boom, torch.zeros(2))


# ------------------------------------------------------- torch_generate_ic


@pytest.mark.parametrize("flags", [[], ["--nx", "40", "--ny", "24", "--amp", "2.5",
                                        "--sigma-frac", "0.1", "--xc-frac", "0.3",
                                        "--dx", "0.5", "--var", "T", "--out", "sub/ic.nc"]],
                         ids=["defaults", "reference flags"])
def test_generate_ic_writes_the_jax_scripts_bytes(tmp_path, monkeypatch, flags):
    jgen, tgen = load_script("generate_ic"), load_script("torch_generate_ic")
    out = {}
    for name, run in (("jax", lambda: jgen.main()), ("port", lambda: tgen.main(flags))):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        monkeypatch.setattr(sys, "argv", ["generate_ic.py", *flags])
        with contextlib.redirect_stdout(io.StringIO()) as buf:
            assert run() == 0
        path = "sub/ic.nc" if flags else "inputs/ic_global.nc"
        out[name] = ((d / path).read_bytes(), buf.getvalue().replace(str(d), ""))
    assert out["port"] == out["jax"]


def test_a_file_ic_through_the_cli_is_the_f64_preset(tmp_path, monkeypatch):
    path = str(tmp_path / "ic.nc")
    assert run_main(load_script("torch_generate_ic").main,
                    ["--nx", "48", "--ny", "40", "--out", path])[0] == 0
    monkeypatch.setenv("CLIMATE_SIM_PLATFORM", "cpu")
    base = [f"--config={REPO}/configs/bench_4096.yaml", "--nx=48", "--ny=40", "--steps=6",
            "--out_every=3", "--write_final=true", "--precision=f64", "--kernel=pallas"]
    for name, extra in (("file", ["--ic.mode=file", f"--ic.path={path}"]), ("preset", [])):
        rc, _ = run_main(cli.main, [*base, *extra, f"--output.dir={tmp_path / name}"])
        assert rc == 0
    with NetCDFFile(str(tmp_path / "file" / "snapshots.nc")) as a, \
            NetCDFFile(str(tmp_path / "preset" / "snapshots.nc")) as b:
        got, want = a.variables["u"][:, :, :], b.variables["u"][:, :, :]
    assert got.shape == want.shape == (3, 40, 48)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_generate_ic_netcdf4_reads_back(tmp_path):
    pytest.importorskip("h5py")
    tgen = load_script("torch_generate_ic")
    path = str(tmp_path / "ic.h5")
    rc, out = run_main(tgen.main, ["--nx", "12", "--ny", "10", "--A", "3", "--format=netcdf4",
                                   "--out", path])
    assert rc == 0 and ("HDF5" in out or "NETCDF4" in out)
    np.testing.assert_array_equal(load_field(path, "u"), tgen.make_gaussian_ic(12, 10, A=3.0))


def test_generate_ic_netcdf4_without_a_library_fails(tmp_path, monkeypatch, capsys):
    tgen = load_script("torch_generate_ic")
    monkeypatch.setitem(sys.modules, "netCDF4", None)
    monkeypatch.setitem(sys.modules, "h5py", None)
    assert tgen.main(["--format=netcdf4", "--out", str(tmp_path / "ic.h5")]) == 1
    assert "needs netCDF4 or h5py" in capsys.readouterr().err
    assert not (tmp_path / "ic.h5").exists()


# ------------------------------------------------------- CDF-5 golden bytes


def _name(s):
    b = s.encode()
    return struct.pack(">Q", len(b)) + b + b"\0" * (-len(b) % 4)


def cdf5_golden(ny, nx, attrs, records):
    """A snapshot file as the CDF-5 specification lays it out: magic
    ``CDF\\x05``, an 8-byte numrecs, the NC_DIMENSION (0x0A), NC_ATTRIBUTE
    (0x0C) and NC_VARIABLE (0x0B) lists with 8-byte counts, one NC_DOUBLE
    (6) record variable ``u(time, y, x)`` with no attributes (ABSENT), its
    8-byte vsize and begin, then the records big-endian from ``begin``."""
    def header(begin):
        h = b"CDF\x05" + struct.pack(">Q", len(records))
        h += struct.pack(">IQ", 0x0A, 3)
        h += _name("time") + struct.pack(">Q", 0)  # the record (UNLIMITED) dimension
        h += _name("y") + struct.pack(">Q", ny)
        h += _name("x") + struct.pack(">Q", nx)
        h += struct.pack(">IQ", 0x0C, len(attrs))
        for k, v in attrs:
            b = v.encode()
            h += _name(k) + struct.pack(">IQ", 2, len(b)) + b + b"\0" * (-len(b) % 4)
        h += struct.pack(">IQ", 0x0B, 1)
        h += _name("u") + struct.pack(">QQQQ", 3, 0, 1, 2)
        h += struct.pack(">IQ", 0, 0)  # ABSENT variable attributes
        h += struct.pack(">IQQ", 6, ny * nx * 8, begin)
        return h

    begin = len(header(0))
    return header(begin) + b"".join(np.asarray(r, ">f8").tobytes() for r in records)


@pytest.mark.parametrize("native", [False, True], ids=["python codec", "native writer"])
def test_snapshot_file_is_the_cdf5_specification(tmp_path, native, capsys):
    cfg = tconfig.merged_config(None, ["--nx=3", "--ny=2", "--steps=8", "--dt=0.1",
                                       "--D=0.05", "--vx=0.5", "--vy=-0.25",
                                       "--bc.left=periodic", "--bc.top=neumann"])
    records = [np.arange(6.0).reshape(2, 3) * 0.5, np.full((2, 3), -1.25)]
    path = str(tmp_path / "s.nc")
    with SnapshotWriter(path, cfg, use_native=native) as w:
        for r in records:
            w.write(r)
    assert "native snapshot writer unavailable" not in capsys.readouterr().err
    attrs = [("description", "climate-sim-tpu"), ("grid", "3 x 2"), ("dt", "0.100000"),
             ("steps", "8"), ("D", "0.050000"), ("velocity", "(0.500000,-0.250000)"),
             ("boundary_conditions",
              "left=periodic right=dirichlet bottom=dirichlet top=neumann")]
    with open(path, "rb") as f:
        assert f.read() == cdf5_golden(2, 3, attrs, records)


# ----------------------------------------------------- torch_run_benchmark


def test_annotate_strong_is_jax_with_and_without_p1():
    jrb, trb = load_script("run_benchmark"), load_script("torch_run_benchmark")
    with_p1 = [(1, 1024, 1024, 200, 8.0, 0.04), (2, 1024, 1024, 200, 5.0, 0.025),
               (4, 1024, 1024, 200, 4.0, 0.02), (8, 1024, 1024, 200, 0.0, 0.0)]
    without = [(4, 512, 512, 100, 3.0, 0.03), (2, 512, 512, 100, 5.0, 0.05),
               (8, 512, 512, 100, 2.5, 0.025)]
    for rows in (with_p1, without):
        assert trb.annotate_strong(rows) == jrb.annotate_strong(rows)


def _fake_timing(p, nx, ny, steps, *rest):
    total = 1e-3 * nx * ny / (p ** 0.8) / 1024 + 0.01 * p
    return total, total / steps


def test_csvs_are_the_jax_harness_csvs(tmp_path, monkeypatch):
    """The same timings through both harnesses' main (their run_one
    replaced): the three CSVs agree byte for byte, comment lines, the
    strong annotation (a sweep without p=1) and the weak normalisation
    included."""
    jrb, trb = load_script("run_benchmark"), load_script("torch_run_benchmark")
    monkeypatch.setattr(jrb, "run_one", _fake_timing)
    monkeypatch.setattr(trb, "run_one", _fake_timing)
    flags = ["--platform=multiproc", "--strong-ranks", "2", "4", "3", "--strong-nx", "96",
             "--strong-ny", "80", "--weak-ranks", "1", "2", "9", "--weak-tile-nx", "24",
             "--weak-tile-ny", "16", "--steps", "12"]
    monkeypatch.setattr(sys, "argv", ["run_benchmark.py", *flags, f"--out-dir={tmp_path}/jax"])
    with contextlib.redirect_stdout(io.StringIO()):
        assert jrb.main() == 0
        assert trb.main([*flags, "--device=cpu", f"--out-dir={tmp_path}/port"]) == 0

    def csvs(d):
        out = {}
        for name in os.listdir(d):
            with open(os.path.join(d, name)) as f:
                out[name.rsplit("_", 2)[0]] = f.read()
        return out

    got, want = csvs(tmp_path / "port"), csvs(tmp_path / "jax")
    assert sorted(got) == ["strong", "strong_annotated", "weak"]
    assert got == want


def test_nocomm_gives_the_last_run_the_remainder(monkeypatch):
    trb = load_script("torch_run_benchmark")
    assert trb.nocomm_split(65, 4) == [16, 16, 16, 17]
    assert trb.nocomm_split(64, 4) == [16] * 4
    launched = []

    class FakeRun:
        def __init__(self, args, stdout=None, **kw):
            launched.append(args)
            stdout.write("timing: total_max=0.25 s, worst_avg_step=0.01 s\n")
            self.returncode = 0

        def wait(self, timeout=None):
            return 0

        def poll(self):
            return 0

    monkeypatch.setattr(trb.subprocess, "Popen", FakeRun)
    total, per = trb.run_multiproc(4, 40, 65, 25, [], "cpu", nocomm=True)
    assert (total, per) == (0.25, 0.01)
    sizes = [[a for a in args if a.startswith(("--nx=", "--ny="))] for args in launched]
    assert sizes == [["--nx=40", f"--ny={n}"] for n in (16, 16, 16, 17)]
    assert not any(a.startswith("--distributed") for args in launched for a in args)


def test_a_cpu_sweep_writes_three_csvs_with_jax_headers(tmp_path):
    trb = load_script("torch_run_benchmark")
    rc, out = run_main(trb.main, [
        "--platform=multiproc", "--device=cpu", "--strong-ranks", "1", "2",
        "--strong-nx", "64", "--strong-ny", "64", "--weak-ranks", "1", "4",
        "--weak-tile-nx", "32", "--weak-tile-ny", "32", "--steps", "8",
        f"--config={REPO}/configs/bench_4096.yaml", f"--out-dir={tmp_path}"])
    assert rc == 0, out
    header = "platform,ranks,nx,ny,steps,total_time,perstep_time"
    want = {"strong": (header, 2), "strong_annotated": (header + ",speedup,efficiency,karp_flatt", 2),
            "weak": (header + ",weak_efficiency", 2)}
    names = os.listdir(tmp_path)
    assert sorted(n.rsplit("_", 2)[0] for n in names) == sorted(want)
    for name in names:
        head, n_rows = want[name.rsplit("_", 2)[0]]
        with open(tmp_path / name) as f:
            lines = [ln.rstrip("\n") for ln in f if not ln.startswith("#")]
        assert lines[0] == head and len(lines) == 1 + n_rows
        for row in lines[1:]:
            cells = row.split(",")
            assert cells[0] == "multiproc" and len(cells) == len(head.split(","))
            assert all(float(c) > 0 for c in cells[5:7])


def test_run_benchmark_without_a_card_runs_nothing(tmp_path, no_card, capsys):
    trb = load_script("torch_run_benchmark")
    for flags in (["--platform=cuda"], [], ["--platform=multiproc_nocomm"]):
        assert trb.main([*flags, f"--out-dir={tmp_path}/out"]) != 0
    assert "torch.cuda.is_available() is False" in capsys.readouterr().err
    assert trb.main(["--platform=cuda", "--device=cpu", f"--out-dir={tmp_path}/out"]) != 0
    assert not (tmp_path / "out").exists()


# ---------------------------------------------------- torch_hw_conformance

SMALL_CONFORMANCE = ["--device=cpu", "--nx=64", "--ny=32", "--steps=4", "--grid-scale=8"]


def test_conformance_on_the_cpu_is_all_ok():
    rc, out = run_main(load_script("torch_hw_conformance").main, SMALL_CONFORMANCE)
    rows = [ln for ln in out.splitlines() if ln.startswith(("ok ", "FAIL "))]
    assert rc == 0
    assert out.splitlines()[-1] == f"hw_conformance: {len(rows)} cases: ALL OK"
    paths = {ln.split()[2] for ln in rows}
    assert paths == {"single", "sharded_multistep", "sharded_overlap", "sharded_perstep",
                     "carrier", "padded_perstep"}
    names = [ln.split()[1] for ln in rows]
    assert len(set(names)) == 24 and "wide_knee_mixed" in names and "bf16_carrier" in names


@pytest.mark.parametrize("fault", ["off by 1e-3", "raises"])
def test_a_faulty_path_fails_the_gate(monkeypatch, fault, capsys):
    conf = load_script("torch_hw_conformance")
    single = conf.PATHS["single"]

    def wrong(cfg, u, meshes, steps):
        if fault == "raises":
            raise RuntimeError("launch failed")
        return single(cfg, u, meshes, steps) + 1e-3

    monkeypatch.setitem(conf.PATHS, "single", wrong)
    rc, out = run_main(conf.main, SMALL_CONFORMANCE)
    rows = [ln for ln in out.splitlines() if ln.startswith(("ok ", "FAIL "))]
    fails = [ln for ln in rows if ln.startswith("FAIL ")]
    # 1e-3 is past the f32 tolerance (5e-5) of the 20 f32 cases and
    # inside the bf16 one (4e-2) of the other 4.
    n_fail = 24 if fault == "raises" else 20
    assert rc == 1
    assert len(fails) == n_fail and all(ln.split()[2] == "single" for ln in fails)
    if fault != "raises":
        assert not any(ln.split()[1].startswith("bf16") for ln in fails)
    assert out.splitlines()[-1] == f"hw_conformance: {len(rows)} cases: {n_fail} FAILURES"
    if fault == "raises":
        assert all("rel_err=nan" in ln for ln in fails)
        assert "EXC  dirichlet4" in capsys.readouterr().err


def test_conformance_without_a_card_fails(no_card):
    assert load_script("torch_hw_conformance").main([]) != 0


# ---------------------------------------------------------- torch_hw_rates


def test_bands_span_half_the_lowest_to_twice_the_highest_reading():
    hr = load_script("torch_hw_rates")
    assert set(hr.BANDS) == set(hr.READINGS) == {
        "single_torus", "single_bf16", "slab_2x2", "carrier_4001_2x2", "overlap_2x2",
        "perstep_2x2"}
    for name, r in hr.READINGS.items():
        assert hr.BANDS[name] == (0.5 * min(r), 2.0 * max(r))
        assert all(hr.BANDS[name][0] < x < hr.BANDS[name][1] for x in r)
    assert hr.FLOOR == 0.5 * hr.K1_READING


def test_the_carrier_grid_is_odd_and_follows_nx():
    hr = load_script("torch_hw_rates")
    assert hr.carrier_grid(4096) == 4001
    for nx in (64, 128, 1024, 2048):
        c = hr.carrier_grid(nx)
        assert c % 2 == 1 and nx - nx // 16 <= c <= nx


def test_judge_holds_each_ratio_to_its_band():
    hr = load_script("torch_hw_rates")
    bands = {"a": (0.5, 2.0), "b": (0.05, 0.2)}
    lines, failures = hr.judge(100.0, {"a": 100.0, "b": 10.0}, 50.0, bands)
    assert failures == 0 and len(lines) == 3 and lines[1].startswith("ok   a ")
    lines, failures = hr.judge(100.0, {"a": 201.0, "b": 4.9}, 50.0, bands)
    assert failures == 2 and [ln[:4] for ln in lines[1:]] == ["FAIL", "FAIL"]
    lines, failures = hr.judge(40.0, {"a": 40.0, "b": 4.0}, 50.0, bands)
    assert failures == 1 and lines[1] == "FAIL single_mixed below absolute floor 50.0"


def test_hw_rates_on_the_cpu_prints_every_path(monkeypatch):
    rc, out = run_main(load_script("torch_hw_rates").main,
                       ["--device=cpu", "--nx=128", "--ny=128", "--chunk=8", "--reps=2", "--trials=1"])
    assert rc == 0
    rows = [ln.split()[1] for ln in out.splitlines() if ln.startswith("cpu ")]
    assert rows == ["single_mixed", "single_torus", "single_bf16", "slab_2x2",
                    "carrier_4001_2x2", "overlap_2x2", "perstep_2x2"]
    assert out.splitlines()[-1].startswith("hw_rates: 7 checks: not held to the bands")


def test_hw_rates_without_a_card_fails(no_card):
    assert load_script("torch_hw_rates").main([]) != 0


# ---------------------------------------------------------------- imports


def test_no_tool_imports_jax(tmp_path):
    """Each tool and benchproto imported, and each tool's CPU path run, in
    a process where importing ``jax`` or ``climate_sim_tpu`` fails."""
    code = textwrap.dedent(f"""
        import contextlib, importlib.util, io, os, sys
        sys.modules["jax"] = None
        sys.modules["climate_sim_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import climate_sim_tpu_torch.benchproto
        mods = {{}}
        for name in {TOOLS!r}:
            spec = importlib.util.spec_from_file_location(name, os.path.join({REPO!r}, "scripts", name + ".py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
        tmp = {str(tmp_path)!r}
        runs = [
            ("torch_generate_ic", ["--nx", "8", "--ny", "8", "--out", tmp + "/ic.nc"]),
            ("torch_hw_conformance", ["--device=cpu", "--nx=64", "--ny=32", "--steps=2",
                                      "--grid-scale=16"]),
            ("torch_hw_rates", ["--device=cpu", "--nx=64", "--ny=64", "--chunk=2", "--reps=1", "--trials=1"]),
        ]
        for name, argv in runs:
            with contextlib.redirect_stdout(io.StringIO()):
                assert mods[name].main(argv) == 0, name
        mods["torch_run_benchmark"].nocomm_split(10, 3)
        assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
        print("NO_JAX_OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stderr[-3000:]
