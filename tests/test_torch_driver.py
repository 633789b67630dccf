"""The PyTorch port's driver, CLI, config/io copies and packaging against
the JAX package, on the CPU.

``run_simulation`` and the CLI of both packages run the same dev.yaml-style
and bench-style configs at 64²-128² on one CPU device; the snapshot files
are read back with both packages' readers: headers and attributes equal,
data within ``1e-12`` (f64) / ``2e-5`` (f32).  The port runs both its plain
per-step path (``kernel=jnp``) and its K1 path (``kernel=pallas``, which on
the CPU takes K1's plain version).
"""

import os
import re
import subprocess
import sys

import numpy as np
import pytest
import torch
import jax

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.io import datasets as jdatasets
from climate_sim_tpu.io import netcdf as jnetcdf
from climate_sim_tpu.io import snapshots as jsnapshots
from climate_sim_tpu.runtime.cli import main as jmain
from climate_sim_tpu.runtime.driver import run_simulation as jrun

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.convert import from_reference
from climate_sim_tpu_torch.io import snapshots as tsnapshots
from climate_sim_tpu_torch.io.netcdf import NetCDFFile as TNetCDFFile
from climate_sim_tpu_torch.ops import _build
from climate_sim_tpu_torch.ops import cuda_stencil as tcs
from climate_sim_tpu_torch.runtime import driver as tdriver
from climate_sim_tpu_torch.runtime.cli import main as tmain

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, "configs", "dev.yaml")
BENCH = os.path.join(REPO, "configs", "bench_4096.yaml")

# (yaml, overrides): dev.yaml is the one-sided-y mix (bottom periodic, top
# Dirichlet), bench_4096.yaml the mixed-BC benchmark config, both cut to
# CPU size.
CASES = {
    "dev64": (DEV, ["--nx=64", "--ny=64", "--steps=60", "--out_every=20"]),
    "bench128": (BENCH, ["--nx=128", "--ny=96", "--steps=45", "--out_every=20",
                         "--write_final=true"]),
}
# K1 passes of each case: dev64 runs k = 64 // 32 = 2, ten passes per
# 20-step span; bench128 runs k = 96 // 32 = 3, spans of 20, 20 and 5 steps
# in 7 + 7 + 2 passes.
K1_PASSES = {"dev64": 30, "bench128": 16}


def read_back(path, reader):
    with reader(path) as ds:
        attrs = {k: ds.getncattr(k) for k in ds.ncattrs()}
        return dict(ds.dimensions), attrs, np.asarray(ds.variables["u"][:, :, :])


def run_both(tmp_path, case, precision, port_kernel):
    yaml_path, extra = CASES[case]
    args = extra + [f"--precision={precision}"]
    jcfg = jconfig.merged_config(
        yaml_path, args + ["--kernel=jnp", f"--output.dir={tmp_path}/jax"]
    )
    jres = jrun(jcfg, devices=jax.devices()[:1])
    tcfg = tconfig.merged_config(
        yaml_path, args + [f"--kernel={port_kernel}", f"--output.dir={tmp_path}/port"]
    )
    tres = tdriver.run_simulation(tcfg, "cpu")
    return jres, tres


@pytest.mark.parametrize("port_kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("precision", ["f64", "f32"])
@pytest.mark.parametrize("case", list(CASES))
def test_run_simulation_snapshots_match_jax(tmp_path, case, precision, port_kernel):
    jres, tres = run_both(tmp_path, case, precision, port_kernel)
    assert tres.output_path.endswith(os.path.basename(jres.output_path))
    assert tres.snapshots_written == jres.snapshots_written
    assert tres.timed_passes == (
        tres.steps if port_kernel == "jnp" else K1_PASSES[case]
    )
    assert tres.warmup_passes == 1
    atol = 1e-12 if precision == "f64" else 2e-5
    for reader in (jnetcdf.NetCDFFile, TNetCDFFile):
        jd, ja, ju = read_back(jres.output_path, reader)
        td, ta, tu = read_back(tres.output_path, reader)
        assert td == jd and ta == ja
        np.testing.assert_allclose(tu, ju, rtol=0, atol=atol)
    np.testing.assert_allclose(
        tres.u.to(torch.float64).numpy(), np.asarray(jres.u, np.float64),
        rtol=0, atol=atol,
    )


def test_bf16_run_matches_jax_within_rounding(tmp_path):
    """bf16 storage through both drivers: the port's K1 path rounds once per
    pass, the JAX CPU path once per step, so compare each with the f32 run
    at the bf16 bound instead of with each other."""
    _, f32 = run_both(tmp_path / "a", "dev64", "f32", "pallas")
    _, bf = run_both(tmp_path / "b", "dev64", "bf16", "pallas")
    assert bf.u.dtype == torch.bfloat16
    d = np.abs(bf.u.to(torch.float32).numpy() - f32.u.numpy()).max()
    assert d < 8e-3


def test_pass_counts_follow_the_schedule():
    cfg = tconfig.merged_config(BENCH, ["--steps=1000", "--out_every=500"])
    assert tdriver.span_lengths(cfg) == [500, 500]
    assert tdriver.span_pieces(500) == [256, 244]
    adv = tcs.build_multistep_advance(cfg, cfg.dt)
    assert tdriver.run_pass_count(cfg, adv) == 126
    cfg.out_every = 300
    assert tdriver.span_lengths(cfg) == [300, 300, 300, 100]


def stdout_lines(text, prefixes):
    return [ln for ln in text.splitlines() if ln.startswith(prefixes)]


@pytest.mark.parametrize("case", list(CASES))
def test_cli_stdout_contract_matches_jax(tmp_path, case, monkeypatch, capsys):
    yaml_path, extra = CASES[case]
    args = [f"--config={yaml_path}", *extra, "--precision=f64", "--kernel=jnp"]
    monkeypatch.setenv("CLIMATE_SIM_PLATFORM", "cpu")
    assert jmain(args + ["--max_devices=1", f"--output.dir={tmp_path}/j"]) == 0
    jout = capsys.readouterr().out
    assert tmain(args + [f"--output.dir={tmp_path}/t"]) == 0
    tout = capsys.readouterr().out
    same = ("climate-sim-tpu", "  grid:", "  bc:", "IC min/max:", "Opening NetCDF")
    assert stdout_lines(tout, same) == stdout_lines(jout, same)
    assert len(stdout_lines(tout, same)) == 5
    for out in (jout, tout):
        assert re.search(r"^timing: total_max=\S+ s, worst_avg_step=\S+ s$", out, re.M)
        assert re.search(
            r"^throughput: \d+\.\d Mpoint/s total, \d+\.\d Mpoint/s/chip$", out, re.M
        )
    steps = tconfig.merged_config(yaml_path, extra).steps
    assert re.search(rf"^passes: timed={steps} warmup=1$", tout, re.M)


@pytest.mark.parametrize("bad", ["--bc.left=bogus", "--dt=0", "--nx=abc"])
def test_cli_config_errors_exit_2(bad, tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CLIMATE_SIM_PLATFORM", "cpu")
    args = [bad, f"--output.dir={tmp_path}/o"]
    assert jmain(list(args)) == 2
    assert tmain(list(args)) == 2
    err = capsys.readouterr().err
    assert err.count("error:") == 2
    assert not os.path.exists(f"{tmp_path}/o")


def test_cli_bad_ic_file_exit_1_no_snapshot(tmp_path, monkeypatch, capsys):
    monkeypatch.setenv("CLIMATE_SIM_PLATFORM", "cpu")
    out = f"{tmp_path}/o"
    rc = tmain(["--ic.mode=file", "--ic.path=/nonexistent/ic.nc",
                f"--output.dir={out}", "--nx=16", "--ny=16", "--steps=2"])
    assert rc == 1
    assert "error:" in capsys.readouterr().err
    assert not os.path.exists(os.path.join(out, "snapshots.nc"))


def test_cli_help_and_version(capsys):
    assert tmain(["--help"]) == 0
    assert "python -m climate_sim_tpu_torch" in capsys.readouterr().out
    assert tmain(["--version"]) == 0
    assert "0.1.0" in capsys.readouterr().out


def test_cuda_request_without_a_card_raises(tmp_path, monkeypatch, capsys):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    cfg = tconfig.merged_config(None, ["--nx=16", "--ny=16", "--steps=2"])
    with pytest.raises(RuntimeError, match="is_available"):
        tdriver.run_simulation(cfg, "cuda", write_output=False)
    with pytest.raises(RuntimeError, match="is_available"):
        tdriver.resolve_device("cuda:0")
    monkeypatch.delenv("CLIMATE_SIM_PLATFORM", raising=False)
    assert tmain(["--nx=16", "--ny=16", "--steps=2", f"--output.dir={tmp_path}"]) == 1
    assert "is_available" in capsys.readouterr().err
    assert not os.listdir(tmp_path)


@pytest.mark.parametrize("override", ["--distributed=127.0.0.1:1234,2"])
def test_mesh_or_distributed_request_raises(override):
    """A malformed ``distributed`` spec raises the JAX package's error
    before any process group is joined (multi-process runs themselves are
    tests/test_torch_multiprocess.py's)."""
    from climate_sim_tpu.runtime.driver import maybe_init_distributed

    cfg = tconfig.merged_config(None, ["--nx=16", "--ny=16", override])
    with pytest.raises(ValueError) as je:
        maybe_init_distributed(jconfig.merged_config(None, ["--nx=16", "--ny=16", override]))
    with pytest.raises(ValueError) as te:
        tdriver.run_simulation(cfg, "cpu", write_output=False)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("override", ["--mesh.x=2", "--mesh.y=4"])
def test_mesh_request_on_one_device_runs_single_device_path(override, capsys):
    """JAX builds a mesh only when more than one device is visible
    (driver.py:281-287): a mesh request on one device runs the
    single-device path, with no mesh: line, in both packages."""
    args = ["--nx=16", "--ny=16", "--steps=6", "--out_every=3",
            "--precision=f64", override]
    jres = jrun(jconfig.merged_config(None, args), devices=jax.devices()[:1],
                write_output=False)
    jout = capsys.readouterr().out
    tres = tdriver.run_simulation(tconfig.merged_config(None, args), "cpu",
                                  write_output=False)
    tout = capsys.readouterr().out
    assert jres.mesh_shape is None and tres.mesh_shape is None
    assert "mesh:" not in jout and "mesh:" not in tout
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-12)


@pytest.mark.parametrize("max_devices, want", [(1, None), (2, (1, 2)), (0, (2, 2))])
def test_max_devices_truncates_the_device_list(max_devices, want):
    """``max_devices`` keeps the first N devices, as in JAX
    (tests/test_driver_paths.py:136): one device left means no mesh."""
    args = ["--nx=16", "--ny=16", "--steps=1", "--out_every=1",
            f"--max_devices={max_devices}"]
    jres = jrun(jconfig.merged_config(None, args), devices=jax.devices()[:4],
                write_output=False)
    tres = tdriver.run_simulation(tconfig.merged_config(None, args), ["cpu"] * 4,
                                  write_output=False)
    assert jres.mesh_shape == tres.mesh_shape == want


def test_diagnostics_profile_and_write_final(tmp_path, capsys):
    cfg = tconfig.merged_config(
        DEV, ["--nx=32", "--ny=32", "--steps=6", "--out_every=3", "--kernel=pallas",
              "--diagnostics_every=1", "--write_final=true",
              f"--profile_dir={tmp_path}/prof", f"--output.dir={tmp_path}/o"],
    )
    res = tdriver.run_simulation(cfg, "cpu")
    out = capsys.readouterr().out
    assert out.count("diag: step=") == 2
    assert os.path.exists(os.path.join(tmp_path, "prof", "trace.json"))
    assert res.snapshots_written == 3
    _, _, frames = read_back(res.output_path, TNetCDFFile)
    np.testing.assert_array_equal(frames[-1], res.u.to(torch.float64).numpy())


@pytest.mark.parametrize("args", [
    ["--dt=5.0", "--vx=0.5"],                       # clamped to the CFL limit
    ["--dt=1.0", "--D=0.15", "--vy=0.9"],           # over the combined bound
])
def test_dt_warnings_match_jax(args, capsys):
    from climate_sim_tpu.runtime.driver import prepare as jprepare

    base = ["--nx=32", "--ny=32", "--kernel=jnp"]
    jprepare(jconfig.merged_config(None, base + args), devices=jax.devices()[:1])
    jerr = capsys.readouterr().err
    _, _, _, dt, clamped = tdriver.prepare(tconfig.merged_config(None, base + args), "cpu")
    terr = capsys.readouterr().err
    warn = [ln for ln in jerr.splitlines() if ln.startswith("[warn] dt=")]
    assert warn and [ln for ln in terr.splitlines() if ln.startswith("[warn]")] == warn
    assert clamped == ("--dt=5.0" in args)


def test_bf16_advisory_counts_the_chosen_path(capsys):
    """bf16 rounds once per pass: 100 steps are 100 rounding events on the
    plain per-step path (warned) and 13 passes of K1 (not warned)."""
    base = ["--nx=256", "--ny=256", "--steps=100", "--out_every=100", "--precision=bf16"]
    tdriver.prepare(tconfig.merged_config(None, base + ["--kernel=jnp"]), "cpu")
    assert "~100 rounding events" in capsys.readouterr().err
    _, adv, _, _, _ = tdriver.prepare(tconfig.merged_config(None, base + ["--kernel=pallas"]), "cpu")
    assert adv.pass_count(100) == 13
    assert "rounding events" not in capsys.readouterr().err


def test_debug_nans_stops_a_run_that_produces_nan(tmp_path, capsys):
    frame = np.zeros((8, 8))
    frame[3, 4] = np.nan
    path = str(tmp_path / "nan.nc")
    with tsnapshots.SnapshotWriter(path, tconfig.merged_config(None, ["--nx=8", "--ny=8"])) as w:
        w.write(frame)
    args = ["--nx=8", "--ny=8", "--steps=4", "--out_every=2", "--ic.mode=file",
            f"--ic.path={path}", "--output.enable=false"]
    res = tdriver.run_simulation(tconfig.merged_config(None, args), "cpu")
    assert torch.isnan(res.u).any()
    with pytest.raises(FloatingPointError, match="after step 2"):
        tdriver.run_simulation(
            tconfig.merged_config(None, args + ["--debug_nans=true"]), "cpu"
        )


def test_from_reference_round_trips_a_jax_config_and_field():
    jcfg = jconfig.merged_config(
        DEV, ["--nx=48", "--ny=40", "--precision=f64", "--steps_per_pass=4",
              "--halo_overlap=false", "--output.path=/x/y.nc", "--ic.var=v"],
    )
    field = np.random.default_rng(3).random((40, 48))
    cfg, u = from_reference(jconfig.config_to_dict(jcfg), field)
    assert tconfig.config_to_dict(cfg) == jconfig.config_to_dict(jcfg)
    assert u.dtype == torch.float64 and u.device.type == "cpu"
    np.testing.assert_array_equal(u.numpy(), field)
    cfg32, u32 = from_reference(
        jconfig.config_to_dict(jconfig.merged_config(DEV, [])), np.zeros((512, 512))
    )
    assert u32.dtype == torch.float32 and cfg32.bc.describe() == jcfg.bc.describe()
    with pytest.raises(ValueError, match="field shape"):
        from_reference(jconfig.config_to_dict(jcfg), field.T)


CONFIG_ARGS = [
    [],
    ["--nx=100", "--ny", "50", "--bc=periodic", "--precision=bf16"],
    ["--bc.left=noflux", "--bc.top=period", "--kernel=pallas_multistep",
     "--strict_reference_compat=true", "--halo_overlap=auto", "--mesh.x=2"],
    ["--ic.mode=file", "--ic.path=a.nc", "--ic.var=w", "--output.prefix=p",
     "--write_final=1", "--output.enable=false", "--diagnostics_every=3"],
]


@pytest.mark.parametrize("yaml_path", [None, DEV, BENCH])
@pytest.mark.parametrize("args", CONFIG_ARGS)
def test_config_copy_matches_jax(yaml_path, args):
    want = jconfig.merged_config(yaml_path, args)
    got = tconfig.merged_config(yaml_path, args)
    assert tconfig.config_to_dict(got) == jconfig.config_to_dict(want)
    assert got.resolved_output_path() == want.resolved_output_path()


@pytest.mark.parametrize("args", [["--nx=0"], ["--kernel=cuda"], ["--precision=f16"],
                                  ["--steps_per_pass=33"], ["--halo_overlap=aato"]])
def test_config_copy_rejects_like_jax(args):
    with pytest.raises(ValueError) as je:
        jconfig.merged_config(None, args)
    with pytest.raises(ValueError) as te:
        tconfig.merged_config(None, args)
    assert str(te.value) == str(je.value)


@pytest.mark.parametrize("name", ["io/netcdf.py", "io/datasets.py", "ops/stability.py",
                                  "native/cdf5_writer.cc"])
def test_verbatim_copies_equal_their_originals(name):
    original = {"native/cdf5_writer.cc": os.path.join(REPO, "native", "src", "cdf5_writer.cc")}
    with open(original.get(name, os.path.join(REPO, "climate_sim_tpu", name))) as f:
        want = f.read()
    with open(os.path.join(REPO, "climate_sim_tpu_torch", name)) as f:
        assert f.read() == want


def test_snapshot_files_are_byte_identical(tmp_path):
    jcfg = jconfig.merged_config(DEV, ["--nx=20", "--ny=12"])
    tcfg = tconfig.merged_config(DEV, ["--nx=20", "--ny=12"])
    assert tsnapshots.metadata_attrs(tcfg) == jsnapshots.metadata_attrs(jcfg)
    frames = np.random.default_rng(1).random((3, 12, 20))
    paths = [str(tmp_path / "j.nc"), str(tmp_path / "t" / "t.nc")]
    with jsnapshots.SnapshotWriter(paths[0], jcfg, use_native=False) as w:
        for f in frames:
            w.write(f)
    with tsnapshots.SnapshotWriter(paths[1], tcfg) as w:
        for f in frames:
            w.write(f)
        with pytest.raises(ValueError, match="snapshot shape"):
            w.write(frames[0].T)
    with open(paths[0], "rb") as a, open(paths[1], "rb") as b:
        assert a.read() == b.read()
    np.testing.assert_array_equal(
        jdatasets.load_field(paths[1]), frames[-1]
    )


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import climate_sim_tpu_torch, climate_sim_tpu_torch.runtime.driver\n"
        "import climate_sim_tpu_torch.ops.cuda_stencil, climate_sim_tpu_torch.convert\n"
        "import climate_sim_tpu_torch.runtime.cli, climate_sim_tpu_torch.ops._build\n"
        "import climate_sim_tpu_torch.parallel, climate_sim_tpu_torch.ops.cuda_sharded\n"
        "import climate_sim_tpu_torch.runtime.distributed, climate_sim_tpu_torch.io.native\n"
        "assert 'jax' not in sys.modules, 'jax was imported'\n"
        "assert not any(m.startswith('climate_sim_tpu.') or m == 'climate_sim_tpu'\n"
        "               for m in sys.modules), 'the JAX package was imported'\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_build_finds_sources_without_nvcc(tmp_path, monkeypatch):
    srcs = _build.kernel_sources()
    assert [os.path.basename(s) for s in srcs] == ["multistep_stencil.cu",
                                                   "region_stencil.cu", "slab_stencil.cu"]
    assert [os.path.basename(s) for s in _build.kernel_headers()] == ["stencil_core.cuh",
                                                                      "tile_stencil.cuh"]
    assert os.path.dirname(srcs[0]) == os.path.join(REPO, "climate_sim_tpu_torch", "csrc")
    h = _build.sources_hash(srcs)
    assert len(h) == 16 and h == _build.sources_hash(srcs)
    with open(srcs[0]) as f:
        text = f.read()
    for symbol in ("climate_multistep_stencil", "climate_cuda_error_string"):
        assert f" {symbol}(" in text
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setattr(_build, "DEFAULT_CUDA_BIN", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
    fake = tmp_path / "nvcc"
    fake.write_text("#!/bin/sh\n")
    fake.chmod(0o755)
    assert _build.find_nvcc() == str(fake)

