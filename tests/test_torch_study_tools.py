"""The port's study tools on the CPU, held to the JAX package's scripts.

* ``scripts/torch_bf16_study.py``: its error rows against
  ``scripts/bf16_study.py``'s at the same flags (both round bf16 once a
  step on the CPU), and the K1 path it takes on a card (``kernel=pallas``:
  K1's plain version, one rounding a pass) against JAX's multi-step
  kernel in interpret mode;
* ``scripts/torch_sharded_path_bench.py`` and
  ``scripts/torch_carrier_bench.py``: every path on a 1x1 CPU mesh prints
  its line, and its field equals the single-device advance's exactly;
* ``scripts/torch_coverage_check.py``: executable lines, missed lines,
  the percentage and the exit codes on a package and a test written here;
* each new module and script imports, and runs its CPU path, in a process
  where ``jax`` and ``climate_sim_tpu`` cannot be imported.

Each tool's default device is the card; without one it must fail, not
run on the CPU.
"""

import contextlib
import importlib.util
import io
import os
import re
import subprocess
import sys
import textwrap

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.ops import pallas_stencil as jps

from climate_sim_tpu_torch import config as tconfig

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = ("torch_bf16_study", "torch_sharded_path_bench", "torch_carrier_bench",
         "torch_coverage_check")


def load_script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run_main(main, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(*args)
    return rc, buf.getvalue()


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a card, and a card is present")


# ------------------------------------------------------------- bf16 study


def rows(out):
    """{(bc, steps): (max_abs_err, rel_l2, f32_max)} of a study's table."""
    got = {}
    for line in out.splitlines():
        parts = line.split()
        if len(parts) == 5 and parts[1].isdigit():
            got[(parts[0], int(parts[1]))] = tuple(float(p) for p in parts[2:])
    return got


def test_bf16_study_rows_match_the_jax_script(monkeypatch):
    flags = ["--err-size", "64", "--horizons", "10", "50", "--skip-perf"]
    rc, out = run_main(load_script("torch_bf16_study").main, ["--device=cpu", *flags])
    assert rc == 0
    got = rows(out)
    monkeypatch.setattr(sys, "argv", ["bf16_study.py", *flags])
    rc, jout = run_main(load_script("bf16_study").main)
    assert rc == 0
    want = rows(jout)
    assert sorted(got) == sorted(want) and len(want) == 8
    for key, (err, rel_l2, fmax) in want.items():
        g_err, g_rel, g_fmax = got[key]
        assert abs(g_fmax - fmax) <= 1e-6 * fmax, key
        assert abs(g_err - err) <= 2.0**-8 * fmax, key
        assert abs(g_rel - rel_l2) <= 0.05 * rel_l2, key


def test_bf16_study_k1_path_matches_jax_kernel_in_interpret_mode():
    """The card's path (K1, here its plain version): one bf16 rounding a
    pass on JAX's schedule, within one bf16 ulp of the value of JAX's
    multi-step kernel run in interpret mode, 32², 16 steps."""
    study = load_script("torch_bf16_study")
    n, steps = 32, 16
    bcs = study.bc_classes()["mixed"]
    tcfg = study.cfg_for(bcs, n, steps, kernel="pallas")
    jcfg = jconfig.SimConfig(nx=n, ny=n, D=0.05, vx=0.5, vy=-0.25, dt=0.1, steps=steps,
                             out_every=steps)
    jcfg.bc = jconfig.BCConfig(*(jconfig.bc_from_string(tconfig.bc_to_string(b)) for b in bcs))
    from climate_sim_tpu_torch.ops.init import gaussian_hotspot

    u_b = gaussian_hotspot(tcfg, torch.bfloat16, "cpu")
    got = study.evolve(u_b, tcfg, steps, torch.device("cpu"))
    ju = jnp.asarray(u_b.to(torch.float32).numpy()).astype(jnp.bfloat16)
    want = np.asarray(jps.build_multistep_advance(jcfg, jcfg.dt, interpret=True)(steps)(ju)
                      .astype(jnp.float64))
    assert np.all(np.abs(got - want) <= np.abs(want) * 2.0**-7 + 1e-30)
    # One rounding a pass (16 here, k = 1 at 32²): the bf16 run is not the
    # f32 run, and stays within a bf16 ulp of the field's scale a pass.
    f = study.evolve(u_b.to(torch.float32), tcfg, steps, torch.device("cpu"))
    assert 0 < np.abs(got - f).max() <= steps * 2.0**-8 * np.abs(f).max()


def test_bf16_study_perf_lines_on_the_cpu():
    rc, out = run_main(load_script("torch_bf16_study").main,
                       ["--device=cpu", "--err-size", "32", "--horizons", "4",
                        "--perf-size", "32", "--perf-steps", "2000"])
    assert rc == 0
    assert re.search(r"^perf f32: \S+ Gpt/s at 32\^2 \(2000 steps, best of 3\)$", out, re.M)
    assert re.search(r"^perf bf16: \S+ Gpt/s at 32\^2 \(2000 steps, best of 3\)$", out, re.M)
    assert len(rows(out)) == 4


# ------------------------------------------------------------- path benches


def test_path_bench_every_path_matches_single():
    bench = load_script("torch_sharded_path_bench")
    cfg = bench.bench_cfg(64, 64, 16)
    results = bench.measure(cfg, bench.PATHS, 16, 1, 1, torch.device("cpu"))
    assert list(results) == list(bench.PATHS)
    single = results["single"][2]
    assert single.shape == (64, 64) and torch.isfinite(single).all()
    for path, (rate, seconds, field, passes) in results.items():
        assert rate > 0 and seconds > 0, path
        assert passes == (16 if path == "perstep" else 8), path  # k = 64 // 32 = 2
        assert float((field - single).abs().max()) == 0.0, path


def test_path_bench_prints_each_path():
    rc, out = run_main(load_script("torch_sharded_path_bench").main,
                       ["--device=cpu", "--nx", "64", "--ny", "64", "--chunk", "16",
                        "--reps", "1", "--trials", "1"])
    assert rc == 0
    for path in ("single", "slab", "overlap", "perstep"):
        assert re.search(rf"^{path}: \S+ Gpt/s/shard \(reps=1\)$", out, re.M), path
    for path in ("slab", "overlap", "perstep"):
        m = re.search(rf"^{path} vs single: \S+x, \S+ ms a pass more \((\d+) passes a"
                      rf" chunk\); field after one chunk: max abs diff (\S+)$", out, re.M)
        assert m and float(m.group(2)) == 0.0, path


@pytest.mark.parametrize("bc, precision", [("mixed", "f32"), ("torus", "f32"),
                                           ("one_sided_y", "bf16")])
def test_carrier_bench_matches_single(bc, precision):
    rc, out = run_main(load_script("torch_carrier_bench").main,
                       ["--device=cpu", "--sizes", "64", "65", "--chunk", "16", "--reps", "1",
                        "--trials", "1", "--single", f"--bc={bc}", f"--precision={precision}"])
    assert rc == 0
    for n in (64, 65):
        assert re.search(rf"^{n}\^2 {bc}: carrier \S+ Gpt/s \(carrier {n}x{n}, reps=1\)$",
                         out, re.M)
        assert re.search(rf"^{n}\^2 {bc}: single  \S+ Gpt/s$", out, re.M)
        m = re.search(rf"^{n}\^2 {bc}: carrier vs single, field after one chunk: max abs diff"
                      rf" (\S+)$", out, re.M)
        assert m and float(m.group(1)) == 0.0


@pytest.mark.parametrize("name", ["torch_bf16_study", "torch_sharded_path_bench",
                                  "torch_carrier_bench"])
def test_tool_without_a_card_fails(name, no_card):
    rc, out = run_main(load_script(name).main, [])
    assert rc != 0 and "Gpt/s" not in out


# ------------------------------------------------------------- coverage gate

PKG = '''\
"""A package for the gate's test."""


def used(x):
    return x + 1


def unused(x):
    y = x * 2
    return y
'''
TEST = '''\
from pkg.mod import used


def test_used():
    assert used(1) == 2
'''


def synthetic(tmp_path):
    (tmp_path / "pkg").mkdir()
    (tmp_path / "pkg" / "__init__.py").write_text("")
    (tmp_path / "pkg" / "mod.py").write_text(PKG)
    (tmp_path / "test_mod.py").write_text(TEST)
    return str(tmp_path / "pkg")


def test_coverage_counting_functions(tmp_path):
    gate = load_script("torch_coverage_check")
    pkg = synthetic(tmp_path)
    mod = os.path.join(pkg, "mod.py")
    # The docstring, both defs and the three body lines.
    assert gate.executable_lines(mod) == {1, 4, 5, 8, 9, 10}
    assert gate.executable_lines(os.path.join(pkg, "__init__.py")) == set()
    rows, hit, total = gate.report({mod: {1, 4, 5, 8}}, [pkg])
    assert [r[0] for r in rows] == [os.path.join("pkg", "__init__.py"),
                                    os.path.join("pkg", "mod.py")]
    name, n, h, pct, missing = rows[1]
    assert (n, h, missing, pct) == (6, 4, [9, 10], pytest.approx(100.0 * 4 / 6))
    assert rows[0][1:4] == (0, 0, 100.0) and (hit, total) == (4, 6)
    assert gate.compress([3, 4, 5, 9, 12, 13, 14]) == "3-5, 9, 12-14"


@pytest.mark.parametrize("fail_under, rc", [(50, 0), (90, 2)])
def test_coverage_gate_on_a_synthetic_package(tmp_path, fail_under, rc):
    """The gate run on the package and its test: the body of ``unused``
    (lines 9-10) is all that is missed, and the exit code follows
    --fail-under."""
    pkg = synthetic(tmp_path)
    res = subprocess.run(
        [sys.executable, os.path.join(REPO, "scripts", "torch_coverage_check.py"),
         f"--target={pkg}", "--show-missing", f"--fail-under={fail_under}", "--",
         "test_mod.py", "-q", "-p", "no:cacheprovider", "-p", "no:randomly"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120)
    assert res.returncode == rc, res.stdout[-2000:] + res.stderr[-2000:]
    lines = res.stdout.splitlines()
    row = next(i for i, ln in enumerate(lines) if ln.startswith(os.path.join("pkg", "mod.py")))
    assert lines[row].split()[1:] == ["6", "4", "66.7%"]
    assert lines[row + 1].strip() == "missing: 9-10"
    assert "TOTAL: 4/6 lines = 66.67%" in lines
    assert ("coverage gate OK" in res.stdout) == (rc == 0)


# ---------------------------------------------------------------- imports


def test_no_new_tool_imports_jax(tmp_path):
    """The read path and each new script imported, and each script's CPU
    path run, where importing ``jax`` or ``climate_sim_tpu`` fails."""
    code = textwrap.dedent(f"""
        import contextlib, importlib.util, io, os, sys
        sys.modules["jax"] = None
        sys.modules["climate_sim_tpu"] = None
        sys.path.insert(0, {REPO!r})
        import climate_sim_tpu_torch.visualization
        mods = {{}}
        for name in {TOOLS!r}:
            spec = importlib.util.spec_from_file_location(name, os.path.join({REPO!r}, "scripts", name + ".py"))
            mods[name] = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mods[name])
        runs = [
            ("torch_bf16_study", ["--device=cpu", "--err-size", "32", "--horizons", "4",
                                  "--skip-perf"]),
            ("torch_sharded_path_bench", ["--device=cpu", "--nx=32", "--ny=32", "--chunk=4",
                                          "--reps=1", "--trials=1"]),
            ("torch_carrier_bench", ["--device=cpu", "--sizes", "33", "--chunk=4", "--reps=1",
                                     "--trials=1", "--single"]),
        ]
        for name, argv in runs:
            with contextlib.redirect_stdout(io.StringIO()):
                assert mods[name].main(argv) == 0, name
        assert not any(m == "jax" or m.split(".")[0] == "climate_sim_tpu"
                       for m in sys.modules if sys.modules[m] is not None)
        print("NO_JAX_OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stderr[-3000:]
