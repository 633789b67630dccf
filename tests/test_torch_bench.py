"""The port's headline bench (``bench_torch.py``) and the card's figures
in ``climate_sim_tpu_torch/benchproto.py``, on the CPU.

* the bench's defaults are ``bench.py``'s constants, read from its source
  with ``ast`` (never imported);
* one chunk of the bench's workload at 64², from the port's IC through the
  port's advance, equals JAX's ``gaussian_hotspot`` +
  ``build_single_device_advance(cfg, cfg.dt)(10)`` (f32; ``atol 2e-5`` for
  the plain per-step path, 5e-5 for K1's plain version over a chunk of
  passes, the port's one-chunk parity tolerances);
* ``--device=cpu`` prints exactly one JSON line with ``bench.py``'s keys;
  without a card the default run, and on an unknown card any run, stops
  with no JSON line;
* ``peaks``: the H100's data-sheet figures, no TPU entry, an error for a
  card missing from the table; ``chunk_work`` at 4096², chunk 100, f32:
  the roofline of a chunk is its operations (one read and one write of
  the field take less), the pass schedule's bound 13 passes of bytes,
  3.221e12 points/s;
* the bench and ``benchproto`` import no JAX.
"""

import ast
import contextlib
import io
import json
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from climate_sim_tpu import benchproto as jbench
from climate_sim_tpu.ops import init as jinit
from climate_sim_tpu.ops import step as jstep

import bench_torch
from climate_sim_tpu_torch import benchproto as tbench
from climate_sim_tpu_torch.ops import init as tinit
from climate_sim_tpu_torch.ops import step as tstep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
H100 = "NVIDIA H100 80GB HBM3"
SMALL = ["--nx", "64", "--ny", "64", "--chunk", "10", "--reps", "2", "--trials", "1"]


@pytest.fixture
def no_card():
    if torch.cuda.is_available():
        pytest.skip("checks the failure without a card, and a card is present")


def bench_py_literals():
    """NX, NY, CHUNK, REPS and ``time_best_of``'s ``trials`` as bench.py's
    source spells them."""
    with open(os.path.join(REPO, "bench.py")) as f:
        tree = ast.parse(f.read())
    out = {}
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Constant):
            for target in node.targets:
                if isinstance(target, ast.Name):
                    out[target.id] = node.value.value
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "time_best_of":
            out["trials"] = next(k.value.value for k in node.keywords if k.arg == "trials")
    return out


def test_defaults_are_bench_py_literals():
    lit = bench_py_literals()
    a = bench_torch.arg_parser().parse_args([])
    assert (a.nx, a.ny, a.chunk, a.reps, a.trials) == (
        lit["NX"], lit["NY"], lit["CHUNK"], lit["REPS"], lit["trials"]) == (4096, 4096, 100, 600, 3)
    assert a.device == "cuda"
    assert bench_torch.metric_name(a.nx, a.ny) == "grid_points_per_s_per_chip_4096sq_diffadv"


@pytest.mark.parametrize("kernel, atol", [("auto", 2e-5), ("pallas", 5e-5)])
def test_one_chunk_of_the_workload_matches_jax(kernel, atol):
    """``auto`` is the plain per-step path ``--device=cpu`` runs; ``pallas``
    is the card's path, K1, here through its plain version."""
    nx = ny = 64
    chunk = 10
    jcfg = jbench.bench_config(nx, ny, chunk)
    want = np.asarray(jstep.build_single_device_advance(jcfg, jcfg.dt)(chunk)(
        jinit.gaussian_hotspot(jcfg, jnp.float32)))
    tcfg = tbench.bench_config(nx, ny, chunk)
    tcfg.kernel = kernel
    adv = tstep.build_single_device_advance(tcfg, tcfg.dt, "cpu")
    assert adv.uses_kernel == (kernel == "pallas")
    got = adv(chunk)(tinit.gaussian_hotspot(tcfg, torch.float32, "cpu"))
    assert got.dtype == torch.float32 and want.dtype == np.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


def test_cpu_run_prints_one_json_line():
    res = subprocess.run([sys.executable, "bench_torch.py", "--device=cpu", *SMALL], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-3000:]
    lines = res.stdout.splitlines()
    assert len(lines) == 1, res.stdout
    out = json.loads(lines[0])
    assert list(out) == ["metric", "value", "unit", "vs_baseline"]
    assert out["metric"] == "grid_points_per_s_per_chip_64x64_diffadv"
    assert out["unit"] == "points/s" and out["value"] > 0 and out["vs_baseline"] is None
    assert "[bench] device=cpu" in res.stderr and "[bench] K1 launches=0" in res.stderr


def test_without_a_card_the_default_run_fails(no_card, capsys):
    assert bench_torch.main([]) != 0
    out, err = capsys.readouterr()
    assert out == "" and "is_available() is False" in err


def test_an_unknown_card_stops_the_run(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "set_device", lambda d: None)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "NVIDIA Unlisted 1GB")
    with pytest.raises(ValueError, match="NVIDIA Unlisted 1GB"):
        bench_torch.main(SMALL)
    assert capsys.readouterr().out == ""


def test_peaks_are_the_h100_data_sheet_and_no_tpu():
    p = tbench.peaks(H100)
    assert (p.bytes_per_s, p.f32_flop_per_s, p.f64_flop_per_s) == (3.35e12, 67e12, 34e12)
    assert not [k for k in tbench.DEVICE_PEAKS if "TPU" in k]
    assert 819e9 not in [p.bytes_per_s for p in tbench.DEVICE_PEAKS.values()]
    with pytest.raises(ValueError, match="TPU v5 lite"):
        tbench.peaks("TPU v5 lite")


def test_chunk_roofline_at_4096_is_its_operations():
    """One read and one write of the field, whatever the pass schedule."""
    cfg = tbench.bench_config(4096, 4096, 100)
    w = tbench.chunk_work(cfg, 100, torch.float32)
    assert w.field_bytes == 2 * 4 * 4096 * 4096 and w.flops == 9 * 4096 ** 2 * 100
    s, by = tbench.bound_s(w.field_bytes, w.flops, torch.float32, H100)
    assert by == "operations" and s == pytest.approx(w.flops / 67e12)
    assert s == pytest.approx(0.2254e-3, rel=1e-3) and w.field_bytes / 3.35e12 < s / 5
    assert 4096 ** 2 * 100 / s == pytest.approx(7.444e12, rel=1e-3)


def test_pass_schedule_bound_at_4096_is_13_passes_of_bytes():
    cfg = tbench.bench_config(4096, 4096, 100)
    w = tbench.chunk_work(cfg, 100, torch.float32)
    assert w.passes == 13 and w.pass_bytes == 13 * w.field_bytes == 13 * 2 * 4 * 4096 * 4096
    s, by = tbench.bound_s(w.pass_bytes, w.flops, torch.float32, H100)
    assert by == "bytes" and s == pytest.approx(w.pass_bytes / 3.35e12)
    assert s == pytest.approx(0.5208e-3, rel=1e-4)
    assert 4096 ** 2 * 100 / s == pytest.approx(3.221e12, rel=1e-3)
    h = tbench.chunk_work(cfg, 100, torch.bfloat16)
    assert (h.passes, h.flops) == (13, w.flops) and h.pass_bytes * 2 == w.pass_bytes
    assert tbench.bound_s(h.pass_bytes, h.flops, torch.bfloat16, H100)[0] == pytest.approx(s / 2)


def test_bf16_takes_the_f32_rate_when_operations_bind(monkeypatch):
    monkeypatch.setitem(tbench.DEVICE_PEAKS, "wide", tbench.Peaks(1e18, 67e12, 34e12))
    cfg = tbench.bench_config(4096, 4096, 100)
    flops = 9 * 4096 ** 2 * 100
    for dtype, rate in ((torch.bfloat16, 67e12), (torch.float32, 67e12), (torch.float64, 34e12)):
        w = tbench.chunk_work(cfg, 100, dtype)
        assert tbench.bound_s(w.pass_bytes, w.flops, dtype, "wide") == (
            pytest.approx(flops / rate), "operations")


def test_bench_and_benchproto_import_no_jax():
    code = textwrap.dedent(f"""
        import contextlib, io, sys, torch
        sys.modules["jax"] = None
        sys.modules["climate_sim_tpu"] = None
        sys.path.insert(0, {REPO!r})
        from climate_sim_tpu_torch import benchproto
        import bench_torch
        cfg = benchproto.bench_config(64, 64, 10)
        w = benchproto.chunk_work(cfg, 10, torch.float32)
        assert benchproto.bound_s(w.field_bytes, w.flops, torch.float32, {H100!r})[0] > 0
        with contextlib.redirect_stdout(io.StringIO()):
            assert bench_torch.main(["--device=cpu", *{SMALL!r}]) == 0
        assert "jax" not in [m for m in sys.modules if sys.modules[m] is not None]
        print("NO_JAX_OK")
    """)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert res.returncode == 0 and "NO_JAX_OK" in res.stdout, res.stderr[-3000:]
