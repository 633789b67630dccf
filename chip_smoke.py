"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. the device: its name, and its name and power limit from nvidia-smi;
2. the build of K1 (csrc/multistep_stencil.cu) with nvcc, or a cache hit;
3. K1 against its plain PyTorch version on the card, over shapes, BC
   classes, steps per pass and dtypes;
4. the main path through the port's own CLI: configs/bench_4096.yaml at
   4096² and configs/dev.yaml at 512², each checked for exit code, the
   timing line, a K1 launch count equal to the pass schedule, snapshots that
   read back, and a final field that agrees with the plain per-step path
   run on the same card;
5. the time of one K1 pass and of its plain version at 4096², f32.

The line before the last is a JSON summary of the kernels; the last line is
``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BENCH_CFG = os.path.join(HERE, "configs", "bench_4096.yaml")
DEV_CFG = os.path.join(HERE, "configs", "dev.yaml")

D, N, P = "dirichlet", "neumann", "periodic"
# (left, right, bottom, top), strict_reference_compat
BC_CLASSES = {
    "D4": ((D, D, D, D), False),
    "N4": ((N, N, N, N), False),
    "P4": ((P, P, P, P), False),
    "bench": ((D, N, P, P), False),
    "MIX2": ((P, P, D, N), False),
    "dev": ((D, N, P, D), False),
    "one_sided_x": ((P, N, D, D), False),
    "both_axes": ((P, D, P, N), False),
    "compat": ((P, P, P, P), True),
}
SHAPES = [(128, 64), (120, 96), (4096, 4096)]  # (nx, ny)
STEPS_PER_PASS = [1, 3, 8]
# K1 vs its plain version: FMA contraction and summation order differ, so
# f32 and f64 agree to round-off; bf16 rounds the two f32 results once
# each, so they agree to one bf16 ulp of the value (<= |value| * 2^-7).
ATOL = {"float32": 1e-5, "float64": 1e-12}
# Main path, 1000 steps in f32: K1 collapses the update to five f32 weights
# whose sum is off 1 by up to ~1e-7, a bias the per-step torch ops do not
# share; it compounds to a few 1e-5 over 1000 steps (2.9e-5 measured at
# 512² on the CPU with the plain version of K1).
MAIN_PATH_ATOL = 1e-4


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke: FAILED: {msg}")


def phase_device(torch):
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    print(f"[device] {name}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    print(f"[device] nvidia-smi: {smi}")
    return name, smi


def phase_build():
    from climate_sim_tpu_torch.ops._build import load_library

    t0 = time.perf_counter()
    kl = load_library()
    how = f"built in {kl.seconds:.1f} s" if kl.built else "cache hit"
    print(f"[build] {os.path.relpath(kl.path, HERE)}: {how}"
          f" ({time.perf_counter() - t0:.1f} s with load)")
    for line in kl.log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"[build] {line.strip()}")


def make_cfg(nx, ny, bc_class, **kw):
    from climate_sim_tpu_torch.config import BCConfig, SimConfig, bc_from_string

    bcs, compat = BC_CLASSES[bc_class]
    cfg = SimConfig(nx=nx, ny=ny, D=0.05, vx=0.5, vy=-0.25, dt=0.1, **kw)
    cfg.bc = BCConfig(*(bc_from_string(b) for b in bcs))
    cfg.strict_reference_compat = compat
    return cfg


def edge_parked(torch, ny, nx, seed, device):
    """A field made on the card from a seed, mass parked against every edge."""
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    u = 0.2 * torch.rand((ny, nx), generator=g, device=device, dtype=torch.float64)
    for sl in ((slice(None), slice(0, 3)), (slice(None), slice(-3, None)),
               (slice(0, 3), slice(None)), (slice(-3, None), slice(None))):
        u[sl] += torch.rand(u[sl].shape, generator=g, device=device, dtype=torch.float64)
    return u


def phase_kernel_vs_plain(torch, device):
    from climate_sim_tpu_torch.ops import cuda_stencil as cs

    worst = {"float32": 0.0, "float64": 0.0, "bfloat16": 0.0}
    cases = 0
    for nx, ny in SHAPES:
        base = edge_parked(torch, ny, nx, seed=nx + ny, device=device)
        for bc_class in BC_CLASSES:
            cfg = make_cfg(nx, ny, bc_class)
            for dtype in (torch.float32, torch.float64, torch.bfloat16):
                u = base.to(dtype)
                name = str(dtype).removeprefix("torch.")
                for k in STEPS_PER_PASS:
                    got = cs.multistep_kernel_step(u, cfg, cfg.dt, k)
                    torch.cuda.synchronize(device)
                    want = cs.multistep_pass_plain(u, cfg, cfg.dt, k)
                    if got.dtype != dtype or got.shape != u.shape:
                        fail(f"K1 returned {got.dtype} {tuple(got.shape)}")
                    g64, w64 = got.to(torch.float64), want.to(torch.float64)
                    err = (g64 - w64).abs()
                    if not torch.isfinite(g64).all():
                        fail(f"K1 non-finite: {nx}x{ny} {bc_class} {name} k={k}")
                    if dtype == torch.bfloat16:
                        ok = bool((err <= w64.abs() * 2.0**-7 + 1e-30).all())
                    else:
                        ok = float(err.max()) <= ATOL[name]
                    if not ok:
                        fail(f"K1 vs plain: {nx}x{ny} {bc_class} {name} k={k}:"
                             f" max abs err {float(err.max()):.3g}")
                    worst[name] = max(worst[name], float(err.max()))
                    cases += 1
    print(f"[k1-vs-plain] {cases} cases ok ({len(SHAPES)} shapes x"
          f" {len(BC_CLASSES)} BC classes x 3 dtypes x k in {STEPS_PER_PASS})")
    for name, e in worst.items():
        print(f"[k1-vs-plain] max abs err {name}: {e:.3g}")
    return cases, worst


def run_cli(args):
    """The port's CLI in this process (so the launch counter is readable),
    its output echoed and returned."""
    from climate_sim_tpu_torch.runtime.cli import main

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(args)
    out = buf.getvalue()
    sys.stdout.write(out)
    return rc, out


def phase_main_path(torch, device, label, cfg_path, extra, tmp):
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.io.netcdf import NetCDFFile
    from climate_sim_tpu_torch.ops import cuda_stencil as cs
    from climate_sim_tpu_torch.runtime import driver

    out_dir = os.path.join(tmp, label)
    args = [f"--config={cfg_path}", *extra, f"--output.dir={out_dir}",
            "--write_final=true"]
    cfg = merged_config(cfg_path, args)
    # The pass schedule, counted here from the config: spans between
    # snapshots, pieces of at most 256 steps, passes of
    # pick_steps_per_pass steps.
    expect_passes = sum(
        len(cs.pass_schedule(cfg, piece))
        for span in driver.span_lengths(cfg) for piece in driver.span_pieces(span)
    )
    expect_snaps = -(-cfg.steps // cfg.out_every)

    print(f"[main:{label}] python -m climate_sim_tpu_torch {' '.join(args)}")
    cs.multistep_kernel_step.launches = 0
    rc, out = run_cli(args)
    launches = cs.multistep_kernel_step.launches
    if rc != 0:
        fail(f"{label}: CLI exit code {rc}")
    if not re.search(r"^timing: total_max=\S+ s, worst_avg_step=\S+ s$", out, re.M):
        fail(f"{label}: no timing line")
    if "path: K1 CUDA kernel" not in out:
        fail(f"{label}: the run did not take the K1 CUDA path")
    m = re.search(r"^passes: timed=(\d+) warmup=(\d+)$", out, re.M)
    if m is None:
        fail(f"{label}: no passes line")
    timed, warm = int(m.group(1)), int(m.group(2))
    if timed != expect_passes or launches != timed + warm:
        fail(f"{label}: K1 launches {launches} != {expect_passes} timed"
             f" + {warm} warm-up passes (driver reported {timed})")
    print(f"[main:{label}] K1 launches {launches}: {timed} timed passes"
          f" (schedule: {expect_passes}) + {warm} warm-up")

    with NetCDFFile(cfg.resolved_output_path()) as ds:
        frames = ds.variables["u"][:, :, :]
    if frames.shape != (expect_snaps + 1, cfg.ny, cfg.nx):
        fail(f"{label}: snapshot file holds {frames.shape}, expected"
             f" {expect_snaps} snapshots + the final field")
    import numpy as np

    if not np.isfinite(frames).all():
        fail(f"{label}: non-finite snapshot values")
    from climate_sim_tpu_torch.ops.init import gaussian_hotspot

    ic = gaussian_hotspot(cfg, torch.float32, device).to(torch.float64).cpu().numpy()
    if not np.array_equal(frames[0], ic):
        fail(f"{label}: the first snapshot is not the IC")

    # The plain per-step torch path on the same card, in f32 and in f64.
    final = torch.from_numpy(frames[-1]).to(device)
    for prec, tol in (("f32", MAIN_PATH_ATOL), ("f64", MAIN_PATH_ATOL)):
        ref_cfg = merged_config(cfg_path, [*args, "--kernel=jnp", f"--precision={prec}"])
        with contextlib.redirect_stdout(io.StringIO()):
            ref = driver.run_simulation(ref_cfg, device, write_output=False).u
        err = float((final - ref.to(torch.float64)).abs().max())
        if err > tol:
            fail(f"{label}: final field vs plain per-step {prec}: {err:.3g} > {tol}")
        print(f"[main:{label}] final field vs plain per-step torch path"
              f" ({prec}): max abs err {err:.3g} (tol {tol})")
    print(f"[main:{label}] {expect_snaps} snapshots + final read back, finite,"
          f" shape {frames.shape[1:]}")
    return launches


def phase_timing(torch, device):
    """Per-pass time of K1 and of its plain version at 4096², f32, k = 8,
    from CUDA events after warm-up, measured in turns: plain, K1, K1, plain."""
    from climate_sim_tpu_torch.ops import cuda_stencil as cs

    nx = ny = 4096
    cfg = make_cfg(nx, ny, "bench")
    u = edge_parked(torch, ny, nx, seed=7, device=device).to(torch.float32)
    k = 8

    def per_pass_ms(fn, reps):
        fn(u)
        torch.cuda.synchronize(device)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(reps):
            fn(u)
        stop.record()
        torch.cuda.synchronize(device)
        return start.elapsed_time(stop) / reps

    def kernel(x):
        return cs.multistep_kernel_step(x, cfg, cfg.dt, k)

    def plain(x):
        return cs.multistep_pass_plain(x, cfg, cfg.dt, k)

    p1 = per_pass_ms(plain, 5)
    k1 = per_pass_ms(kernel, 50)
    k2 = per_pass_ms(kernel, 50)
    p2 = per_pass_ms(plain, 5)
    k_ms, p_ms = (k1 + k2) / 2, (p1 + p2) / 2
    pts = nx * ny * k
    print(f"[timing] {nx}x{ny} f32, k={k} steps per pass, bench BCs:"
          f" K1 {k1:.4f} / {k2:.4f} ms per pass, plain {p1:.4f} / {p2:.4f} ms")
    print(f"[timing] K1 {pts / (k_ms * 1e6):.1f} Gpoint/s,"
          f" plain {pts / (p_ms * 1e6):.1f} Gpoint/s")
    return k_ms, p_ms


def main() -> int:
    if not os.path.isdir(os.path.join(HERE, "climate_sim_tpu_torch")):
        print("chip_smoke: the climate_sim_tpu_torch package is not beside"
              " this script", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False: needs a CUDA"
              " card", file=sys.stderr)
        return 1
    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)

    name, smi = phase_device(torch)
    phase_build()
    cases, worst = phase_kernel_vs_plain(torch, device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches = phase_main_path(
            torch, device, "bench_4096", BENCH_CFG,
            ["--steps=1000", "--out_every=500"], tmp,
        )
        launches += phase_main_path(torch, device, "dev", DEV_CFG, [], tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    k_ms, p_ms = phase_timing(torch, device)

    kernels = {"kernels": [{
        "name": "K1 multistep_stencil",
        "route": "cuda",
        "source": "climate_sim_tpu_torch/csrc/multistep_stencil.cu",
        "replaces": "climate_sim_tpu/ops/pallas_stencil.py:1309",
        "launches": launches,
        "max_abs_err": worst["float32"],
        "max_abs_err_by_dtype": worst,
        "cases": cases,
        "ms": k_ms,
        "plain_ms": p_ms,
    }]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
