"""The port's read path for ``visualization/``
(``climate_sim_tpu_torch/visualization.py``), held to ``visualization.io``
reading through the JAX package.

* In a fresh process where ``jax``, ``climate_sim_tpu`` (and so every
  module under it) and ``netCDF4`` cannot be imported, the port's CLI
  writes a 64² run of 3 records and ``python -m
  climate_sim_tpu_torch.visualization`` draws ``show`` and ``compare``
  into PNGs (Agg backend).
* In this process, every frame and attribute read through the port's
  entry point equals what ``visualization.io`` reads through the JAX
  package's reader, bit for bit; the five error contracts of
  ``visualization/io.py`` and the CLI's exit codes are the original's;
  and ``visualization.io._open_dataset`` is the original again after
  every call, a failing one included.
"""

import importlib.util
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

import visualization.cli as vcli
import visualization.io as vio

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch import visualization as tvis
from climate_sim_tpu_torch.io.netcdf import NetCDFFile, NetCDFWriter
from climate_sim_tpu_torch.runtime import driver as tdriver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "configs", "bench_4096.yaml")
ORIGINAL_OPENER = vio._open_dataset

# Runs a snippet with jax, the JAX package and netCDF4 unimportable; a
# module under climate_sim_tpu needs its parent, so it fails too.
GUARD = textwrap.dedent(f"""
    import os, sys
    for name in ("jax", "climate_sim_tpu", "netCDF4"):
        sys.modules[name] = None
    sys.path.insert(0, {REPO!r})
""")


def run_guarded(code, tmp_path):
    env = {**os.environ, "MPLBACKEND": "Agg", "CLIMATE_SIM_PLATFORM": "cpu"}
    return subprocess.run([sys.executable, "-c", GUARD + textwrap.dedent(code)], cwd=tmp_path,
                          capture_output=True, text=True, timeout=180, env=env)


@pytest.fixture(scope="module")
def run_dir(tmp_path_factory):
    """A 64² bench run of 3 records (steps 0, 10 and 20 of 30), written by
    the port's driver on the CPU."""
    out = tmp_path_factory.mktemp("viz_run")
    args = [f"--config={BENCH}", "--nx=64", "--ny=64", "--steps=30", "--out_every=10",
            f"--output.dir={out}"]
    cfg = tconfig.merged_config(BENCH, args)
    tdriver.run_simulation(cfg, "cpu")
    return str(out)


def test_plots_on_a_port_only_install(tmp_path):
    """The port's CLI writes the run, then ``show`` and ``compare`` draw it,
    each in a process that cannot import jax, climate_sim_tpu or netCDF4."""
    res = run_guarded(f"""
        from climate_sim_tpu_torch.runtime import cli
        rc = cli.main([{"--config=" + BENCH!r}, "--nx=64", "--ny=64", "--steps=30",
                       "--out_every=10", "--output.dir=run"])
        from climate_sim_tpu_torch.io.netcdf import NetCDFFile
        with NetCDFFile("run/snapshots.nc") as ds:
            assert ds.dimensions["time"] == 3, ds.dimensions
        assert not any(m == "jax" or m.split(".")[0] == "climate_sim_tpu"
                       for m in sys.modules if sys.modules[m] is not None)
        sys.exit(rc)
    """, tmp_path)
    assert res.returncode == 0, res.stderr[-3000:]
    for argv in (["show", "--dir", "run", "--save", "show.png"],
                 ["compare", "--dir-a", "run", "--dir-b", "run", "--step", "1",
                  "--save", "compare.png"]):
        res = run_guarded(f"""
            import runpy
            sys.argv = ["climate_sim_tpu_torch.visualization", *{argv!r}]
            runpy.run_module("climate_sim_tpu_torch.visualization", run_name="__main__",
                             alter_sys=True)
            assert not any(m == "jax" or m.split(".")[0] in ("climate_sim_tpu", "netCDF4")
                           for m in sys.modules if sys.modules[m] is not None)
        """, tmp_path)
        assert res.returncode == 0, res.stderr[-3000:]
        png = tmp_path / argv[-1]
        assert png.stat().st_size > 0
        with open(png, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_frames_and_attributes_equal_the_jax_reader(run_dir):
    steps = vio.list_available_steps(run_dir)
    assert steps == [0, 1, 2]
    assert tvis.list_available_steps(run_dir) == steps
    with tvis.SnapshotReader(run_dir) as reader:
        assert reader.num_steps == len(steps)
        for step in steps:
            want = vio.load_global(run_dir, step)
            got = tvis.load_global(run_dir, step)
            assert got.dtype == want.dtype and got.shape == want.shape == (64, 64)
            np.testing.assert_array_equal(got, want)
            np.testing.assert_array_equal(reader.frame(step), want)
    want, got = vio.load_metadata(run_dir), tvis.load_metadata(run_dir)
    assert sorted(got) == sorted(want) and len(want) > 0
    for name, value in want.items():
        assert type(got[name]) is type(value), name
        np.testing.assert_array_equal(got[name], value)
    assert vio._open_dataset is ORIGINAL_OPENER


def test_the_port_reader_opens_with_the_ports_codec(run_dir):
    """Inside the block ``visualization.io`` opens through the port's
    opener (the port's reader where netCDF4 is absent), outside through its
    own, also when the block raises."""
    with tvis.port_reader():
        assert vio._open_dataset is tvis.open_dataset
        ds = vio._open_dataset(os.path.join(run_dir, "snapshots.nc"))
        try:
            if importlib.util.find_spec("netCDF4") is None:
                assert isinstance(ds, NetCDFFile)
        finally:
            ds.close()
    assert vio._open_dataset is ORIGINAL_OPENER
    with pytest.raises(ZeroDivisionError):
        with tvis.port_reader():
            1 / 0
    assert vio._open_dataset is ORIGINAL_OPENER


def no_time_dir(tmp_path):
    """A directory whose .nc file has a ``u(y, x)`` but no time dimension."""
    d = tmp_path / "no_time"
    if d.exists():
        return str(d)
    d.mkdir()
    with NetCDFWriter(str(d / "f.nc")) as w:
        w.def_dim("y", 4)
        w.def_dim("x", 4)
        w.def_var("u", np.float64, ("y", "x"))
        w.enddef()
        w.put_var("u", np.zeros((4, 4)))
    return str(d)


def error_case(case, tmp_path, run_dir):
    """(a call taking a reader module, the exception it must raise)."""
    empty = tmp_path / "empty"
    empty.mkdir(exist_ok=True)
    missing = str(tmp_path / "missing")
    return {
        "directory not found": (lambda m: m.load_global(missing, 0), FileNotFoundError),
        "no .nc file": (lambda m: (m.list_available_steps(str(empty)),
                                   m.load_metadata(str(empty))), FileNotFoundError),
        "missing variable": (lambda m: m.load_global(run_dir, 0, var="v"), KeyError),
        "no time dimension": (lambda m: m.SnapshotReader(no_time_dir(tmp_path)), RuntimeError),
        "step out of range": (lambda m: m.load_global(run_dir, 3), IndexError),
    }[case]


@pytest.mark.parametrize("case", ["directory not found", "no .nc file", "missing variable",
                                  "no time dimension", "step out of range"])
def test_error_contracts_are_the_originals(case, tmp_path, run_dir):
    """Each of ``visualization/io.py``'s five contracts, through the port
    and through the original: the same exception with the same message
    (for the empty directory, ``list_available_steps`` returns [] first)."""
    call, exc = error_case(case, tmp_path, run_dir)
    if case == "no .nc file":
        assert tvis.list_available_steps(str(tmp_path / "empty")) == [] == \
            vio.list_available_steps(str(tmp_path / "empty"))
    with pytest.raises(exc) as got:
        call(tvis)
    with pytest.raises(exc) as want:
        call(vio)
    assert str(got.value) == str(want.value)
    assert vio._open_dataset is ORIGINAL_OPENER


@pytest.mark.parametrize("argv", [
    ["show"],
    ["show", "--dir", "MISSING"],
    ["show", "--dir", "EMPTY"],
    ["show", "--dir", "RUN", "--step", "7", "--save", "x.png"],
    ["compare", "--dir-a", "RUN", "--dir-b", "RUN", "--step", "1", "--save", "PNG"],
], ids=["usage", "missing dir", "no snapshots", "step out of range", "compare"])
def test_cli_exit_codes_are_the_originals(argv, tmp_path, run_dir):
    """``main`` of the port and of ``visualization.cli`` on the same argv:
    the same SystemExit code or exception, and the opener restored."""
    (tmp_path / "empty").mkdir()
    subst = {"MISSING": str(tmp_path / "missing"), "EMPTY": str(tmp_path / "empty"),
             "RUN": run_dir}
    outcomes = []
    for main in (tvis.main, vcli.main):
        args = [subst.get(a, a) for a in argv]
        if args[-1] == "PNG":
            args[-1] = str(tmp_path / f"{main.__module__}.png")
        try:
            main(args)
            outcomes.append(("ok", None))
        except SystemExit as e:
            outcomes.append(("exit", 1 if isinstance(e.code, str) else e.code))
        except Exception as e:  # noqa: BLE001 - the uncaught exception is the exit path
            outcomes.append((type(e).__name__, str(e)))
        assert vio._open_dataset is ORIGINAL_OPENER
    assert outcomes[0] == outcomes[1]
    if argv[0] == "compare":
        assert outcomes[0] == ("ok", None)
        for name in ("climate_sim_tpu_torch.visualization", "visualization.cli"):
            assert (tmp_path / f"{name}.png").stat().st_size > 0
