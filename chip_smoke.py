"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. the device: its name, and its name and power limit from nvidia-smi;
2. the build of K1-K4 (csrc/*.cu) with nvcc, or a cache hit;
3. K1 against its plain PyTorch version on the card, over shapes, BC
   classes, steps per pass and dtypes;
4. the main path through the port's own CLI: configs/bench_4096.yaml at
   4096² and configs/dev.yaml at 512², each checked for exit code, the
   timing line, a K1 launch count equal to the pass schedule, snapshots that
   read back, and a final field that agrees with the plain per-step path
   run on the same card;
5. the time of one K1 pass and of its plain version at 4096², f32;
6. K2, K3 and K4 against their plain versions on the card, over tile
   shapes (a 2048² tile included), BC classes, dtypes, steps per pass and
   the edge flags of every tile of 1x1, 2x2, 1x4 and 4x1 meshes;
7. the sharded path through ``run_simulation(cfg, [cuda:0] * n)``:
   bench_4096 on a 2x2 mesh with the slab path (K4) and with
   ``halo_overlap: true`` (K3), dev.yaml at 512² on 1x4 and 4x1, each
   checked for the timing and mesh lines, launch counts equal to the pass
   schedule times the tiles, snapshots that read back, and a final field
   that agrees with the single-device K1 run on the same card;
8. the per-step sharded path (K2) on a 2x2 mesh at 4096², 100 steps,
   held against the slab path and against K1;
9. K2-K4 per pass on a 2048² tile beside their plain versions, and the
   rates of the 2x2 slab and overlap paths on one card beside K1's.

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
# Sharded runs against the single-device K1 run, f32, 1000 steps: both use
# the same five weights; where the tile's pass size differs from K1's (the
# 512² dev runs, k = 4 against 8) only FMA contraction and rounding order
# differ, well inside MAIN_PATH_ATOL.
SHARDED_ATOL = MAIN_PATH_ATOL
TILE_SHAPES = [(128, 64), (120, 96), (2048, 2048)]  # (mx, my)
MESH_SHAPES = [(1, 1), (2, 2), (1, 4), (4, 1)]  # (px, py)
KERNEL_NAMES = ("K1", "K2", "K3", "K4")
TIMING_TILE = 2048  # the tile of a 2x2 mesh at 4096²


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
    reset_counts()
    rc, out = run_cli(args)
    counts = read_counts()
    launches = counts["K1"]
    if rc != 0:
        fail(f"{label}: CLI exit code {rc}")
    if any(counts[n] for n in ("K2", "K3", "K4")):
        fail(f"{label}: the single-device path launched {counts}")
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


def counters():
    """The launch counter of each kernel's wrapper, by kernel name."""
    from climate_sim_tpu_torch.ops import cuda_sharded as sh
    from climate_sim_tpu_torch.ops import cuda_stencil as cs

    return {"K1": cs.multistep_kernel_step, "K2": sh.prepadded_kernel_step,
            "K3": sh.tile_region_multistep, "K4": sh.sharded_tile_slab_multistep}


def reset_counts():
    for fn in counters().values():
        fn.launches = 0


def read_counts():
    return {name: fn.launches for name, fn in counters().items()}


def mesh_flag_sets():
    """The edge flags of every tile of the MESH_SHAPES meshes."""
    from climate_sim_tpu_torch.parallel.mesh import make_mesh

    out = []
    for px, py in MESH_SHAPES:
        m = make_mesh(px, py, ["cpu"] * (px * py))
        for y in range(py):
            for x in range(px):
                if m.edge_flags(y, x) not in out:
                    out.append(m.edge_flags(y, x))
    return out


def slabs(torch, w, kh):
    """A padded window's tile, xhalo (my, 2kh) and yhalo (2kh, mx+2kh)."""
    tile = w[kh:-kh, kh:-kh].contiguous()
    xh = torch.cat([w[kh:-kh, :kh], w[kh:-kh, -kh:]], dim=1).contiguous()
    yh = torch.cat([w[:kh], w[-kh:]], dim=0).contiguous()
    return tile, xh, yh


def compare(torch, label, got, want, dtype):
    """Max abs error of a kernel result against its plain version; fails
    past the dtype's tolerance."""
    if got.dtype != want.dtype or got.shape != want.shape:
        fail(f"{label}: {got.dtype} {tuple(got.shape)} vs plain"
             f" {want.dtype} {tuple(want.shape)}")
    g64, w64 = got.to(torch.float64), want.to(torch.float64)
    err = (g64 - w64).abs()
    if not torch.isfinite(g64).all():
        fail(f"{label}: non-finite values")
    name = str(dtype).removeprefix("torch.")
    if dtype == torch.bfloat16:
        ok = bool((err <= w64.abs() * 2.0**-7 + 1e-30).all())
    else:
        ok = float(err.max()) <= ATOL[name]
    if not ok:
        fail(f"{label}: max abs err {float(err.max()):.3g}")
    return name, float(err.max())


def phase_tile_kernels_vs_plain(torch, device):
    """K2, K3 (flagged under every mesh tile's flags, and unflagged) and K4
    against their plain versions, on random padded windows made on the
    card; K4 reads the same window as slabs."""
    from climate_sim_tpu_torch.ops import cuda_sharded as sh

    flag_sets = mesh_flag_sets()
    worst = {n: {"float32": 0.0, "float64": 0.0, "bfloat16": 0.0} for n in ("K2", "K3", "K4")}
    cases = {"K2": 0, "K3": 0, "K4": 0}
    for mx, my in TILE_SHAPES:
        for bc_class in BC_CLASSES:
            cfg = make_cfg(mx, my, bc_class)
            for dtype in (torch.float32, torch.float64, torch.bfloat16):
                for k in STEPS_PER_PASS:
                    w = edge_parked(torch, my + 2 * k, mx + 2 * k, seed=mx + k,
                                    device=device).to(dtype)
                    tile, xh, yh = slabs(torch, w, k)
                    for flags in flag_sets + [None]:
                        label = f"{mx}x{my} {bc_class} {dtype} k={k} flags={flags}"
                        got = sh.tile_region_multistep(w, flags or sh.NO_FLAGS, cfg, cfg.dt,
                                                       k, my, mx, flagged=flags is not None)
                        torch.cuda.synchronize(device)
                        want = sh.region_pass_plain(w, cfg, cfg.dt, k, my, mx,
                                                    flags or sh.NO_FLAGS)
                        name, e = compare(torch, f"K3 {label}", got, want, dtype)
                        worst["K3"][name] = max(worst["K3"][name], e)
                        cases["K3"] += 1
                        if flags is None:
                            continue
                        got = sh.sharded_tile_slab_multistep(tile, xh, yh, flags, cfg,
                                                             cfg.dt, k)
                        torch.cuda.synchronize(device)
                        want = sh.slab_pass_plain(tile, xh, yh, flags, cfg, cfg.dt, k)
                        name, e = compare(torch, f"K4 {label}", got, want, dtype)
                        worst["K4"][name] = max(worst["K4"][name], e)
                        cases["K4"] += 1
                up = w[k - 1:-(k - 1) or None, k - 1:-(k - 1) or None].contiguous()
                got = sh.prepadded_kernel_step(up, cfg, cfg.dt)
                torch.cuda.synchronize(device)
                want = sh.prepadded_step_plain(up, cfg, cfg.dt)
                name, e = compare(torch, f"K2 {mx}x{my} {bc_class} {dtype}", got, want, dtype)
                worst["K2"][name] = max(worst["K2"][name], e)
                cases["K2"] += 1
    for n in ("K2", "K3", "K4"):
        errs = ", ".join(f"{d} {e:.3g}" for d, e in worst[n].items())
        print(f"[tile-kernels-vs-plain] {n}: {cases[n]} cases ok; max abs err {errs}")
    print(f"[tile-kernels-vs-plain] {len(TILE_SHAPES)} tile shapes x {len(BC_CLASSES)}"
          f" BC classes x 3 dtypes; K3/K4 k in {STEPS_PER_PASS} x {len(flag_sets)}"
          " mesh-tile flag sets (K3 also unflagged)")
    return cases, worst


def expected_tile_passes(cfg, px, py):
    """Passes per tile of a sharded run: spans between snapshots, pieces of
    at most 256 steps, passes of the tile's k (fixed once from the tile and
    out_every); plus the 1-step warm-up pass."""
    import dataclasses

    from climate_sim_tpu_torch.ops.cuda_stencil import pick_steps_per_pass
    from climate_sim_tpu_torch.runtime import driver

    tile = dataclasses.replace(cfg, nx=cfg.nx // px, ny=cfg.ny // py)
    k = pick_steps_per_pass(tile, cfg.out_every or 8)
    return sum(-(-piece // k) for span in driver.span_lengths(cfg)
               for piece in driver.span_pieces(span))


def phase_sharded_run(torch, device, label, cfg_path, extra, mesh_xy, kernel, tmp):
    """One sharded run through run_simulation on ``[device] * n``."""
    import numpy as np

    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.io.netcdf import NetCDFFile
    from climate_sim_tpu_torch.ops.init import gaussian_hotspot
    from climate_sim_tpu_torch.runtime import driver

    px, py = mesh_xy
    n = px * py
    args = [*extra, f"--mesh.x={px}", f"--mesh.y={py}", "--kernel=pallas",
            f"--output.dir={os.path.join(tmp, label)}", "--write_final=true"]
    cfg = merged_config(cfg_path, args)
    print(f"[sharded:{label}] run_simulation({os.path.basename(cfg_path)} {' '.join(args)},"
          f" devices=[{device}] * {n})")
    reset_counts()
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = driver.run_simulation(cfg, [device] * n)
    counts = read_counts()
    out = buf.getvalue()
    sys.stdout.write(out)
    if not re.search(r"^timing: total_max=\S+ s, worst_avg_step=\S+ s$", out, re.M):
        fail(f"{label}: no timing line")
    if f"  mesh: x={px} y={py} ({n} devices)" not in out.splitlines():
        fail(f"{label}: no mesh line for x={px} y={py}")
    path = "overlap, K3" if kernel == "K3" else "slab, K4"
    if f"path: {path} CUDA kernel" not in out:
        fail(f"{label}: the run did not take the {path} CUDA path")
    if res.mesh_shape != (py, px):
        fail(f"{label}: mesh_shape {res.mesh_shape}")
    m = re.search(r"^passes: timed=(\d+) warmup=(\d+)$", out, re.M)
    timed, warm = int(m.group(1)), int(m.group(2))
    expect = expected_tile_passes(cfg, px, py)
    per_pass = 5 if kernel == "K3" else 1
    want = {name: 0 for name in KERNEL_NAMES}
    want[kernel] = per_pass * (expect + warm) * n
    if timed != expect or counts != want:
        fail(f"{label}: launches {counts} != {want} ({expect} timed + {warm}"
             f" warm-up passes x {n} tiles; driver reported {timed} timed)")
    print(f"[sharded:{label}] {kernel} launches {counts[kernel]} = {per_pass} x"
          f" ({timed} timed + {warm} warm-up passes) x {n} tiles; other kernels 0")

    expect_snaps = -(-cfg.steps // cfg.out_every)
    with NetCDFFile(cfg.resolved_output_path()) as ds:
        frames = ds.variables["u"][:, :, :]
    if frames.shape != (expect_snaps + 1, cfg.ny, cfg.nx) or not np.isfinite(frames).all():
        fail(f"{label}: snapshot file holds {frames.shape} (finite:"
             f" {np.isfinite(frames).all()}), expected {expect_snaps} + final")
    ic = gaussian_hotspot(cfg, torch.float32, device).to(torch.float64).cpu().numpy()
    if not np.array_equal(frames[0], ic):
        fail(f"{label}: the first snapshot is not the IC")
    if not np.array_equal(frames[-1], res.u.to(torch.float64).cpu().numpy()):
        fail(f"{label}: the final snapshot is not the returned field")
    with contextlib.redirect_stdout(io.StringIO()):
        ref = driver.run_simulation(cfg, [device], write_output=False).u
    err = float((res.u - ref).abs().max())
    if not err <= SHARDED_ATOL:
        fail(f"{label}: final field vs single-device K1 run: {err:.3g} > {SHARDED_ATOL}")
    print(f"[sharded:{label}] {expect_snaps} snapshots + final read back;"
          f" final field vs single-device K1 run: max abs err {err:.3g}"
          f" (tol {SHARDED_ATOL})")
    return counts[kernel], err


def bench_setup(torch, device, px=2, py=2):
    """bench_4096's config at 4096² f32 with the kernel named, its clamped
    dt, its IC on the card and a px x py mesh of the card."""
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.ops.init import apply_initial_condition
    from climate_sim_tpu_torch.ops.stability import clamp_dt
    from climate_sim_tpu_torch.parallel.mesh import make_mesh

    cfg = merged_config(BENCH_CFG, ["--kernel=pallas"])
    dt = clamp_dt(cfg.dt, cfg.dx, cfg.dy, cfg.vx, cfg.vy, cfg.D)[0]
    u0 = apply_initial_condition(cfg, torch.float32, device).contiguous()
    return cfg, dt, u0, make_mesh(px, py, [device] * (px * py))


def phase_per_step(torch, device):
    """build_sharded_advance + make_interior_step (K2) on a 2x2 mesh at
    4096², 100 steps; held against the slab path and K1."""
    from climate_sim_tpu_torch.ops.cuda_stencil import build_multistep_advance
    from climate_sim_tpu_torch.ops.step import make_interior_step
    from climate_sim_tpu_torch.parallel import halo
    from climate_sim_tpu_torch.parallel.mesh import gather_field, shard_field

    cfg, dt, u0, mesh = bench_setup(torch, device)
    tiles = shard_field(u0, mesh)
    adv = halo.build_sharded_advance(cfg, mesh, dt, make_interior_step(cfg, dt))
    reset_counts()
    out = adv(100)(tiles)
    torch.cuda.synchronize(device)
    counts = read_counts()
    want = {"K1": 0, "K2": 100 * 4, "K3": 0, "K4": 0}
    if counts != want:
        fail(f"per-step: launches {counts} != {want}")
    per_step = gather_field(out, mesh)
    slab = gather_field(halo.build_sharded_multistep_advance(cfg, mesh, dt)(100)(tiles), mesh)
    k1 = build_multistep_advance(cfg, dt)(100)(u0)
    errs = {"slab": float((slab - per_step).abs().max()),
            "K1": float((k1 - per_step).abs().max())}
    if not torch.isfinite(per_step).all() or max(errs.values()) > SHARDED_ATOL:
        fail(f"per-step: max abs err vs {errs} > {SHARDED_ATOL}")
    print(f"[per-step] 2x2 mesh at 4096², 100 steps: K2 launches {counts['K2']}"
          f" = 100 x 4 tiles; slab path vs per-step max abs err {errs['slab']:.3g},"
          f" per-step vs K1 {errs['K1']:.3g} (tol {SHARDED_ATOL})")
    return counts["K2"], errs


def events_ms(torch, device, fn, reps):
    """Mean ms of ``fn()`` over ``reps`` calls, from CUDA events after one
    warm-up call."""
    fn()
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def phase_tile_timing(torch, device):
    """K2-K4 per pass on a 2048² tile (bench BCs, f32, k = 8, a corner
    tile's flags) beside their plain versions, and the 4096² rates of the
    2x2 slab and overlap paths on one card beside K1's, 100-step chunks;
    each measured in turns."""
    from climate_sim_tpu_torch.ops import cuda_sharded as sh
    from climate_sim_tpu_torch.ops.cuda_stencil import build_multistep_advance
    from climate_sim_tpu_torch.parallel import halo
    from climate_sim_tpu_torch.parallel.mesh import shard_field

    m, k, flags = TIMING_TILE, 8, (1, 0, 1, 0)
    cfg = make_cfg(2 * m, 2 * m, "bench")
    w = edge_parked(torch, m + 2 * k, m + 2 * k, seed=11, device=device).to(torch.float32)
    tile, xh, yh = slabs(torch, w, k)
    up = w[k - 1:-(k - 1), k - 1:-(k - 1)].contiguous()
    pairs = {
        "K2": (lambda: sh.prepadded_kernel_step(up, cfg, cfg.dt),
               lambda: sh.prepadded_step_plain(up, cfg, cfg.dt)),
        "K3": (lambda: sh.tile_region_multistep(w, flags, cfg, cfg.dt, k, m, m),
               lambda: sh.region_pass_plain(w, cfg, cfg.dt, k, m, m, flags)),
        "K4": (lambda: sh.sharded_tile_slab_multistep(tile, xh, yh, flags, cfg, cfg.dt, k),
               lambda: sh.slab_pass_plain(tile, xh, yh, flags, cfg, cfg.dt, k)),
    }
    times = {}
    for name, (kern, plain) in pairs.items():
        p1 = events_ms(torch, device, plain, 5)
        k1 = events_ms(torch, device, kern, 50)
        k2 = events_ms(torch, device, kern, 50)
        p2 = events_ms(torch, device, plain, 5)
        times[name] = ((k1 + k2) / 2, (p1 + p2) / 2)
        steps = 1 if name == "K2" else k
        print(f"[timing] {name} on a {m}² tile, f32, {steps} step(s) per pass:"
              f" kernel {k1:.4f} / {k2:.4f} ms, plain {p1:.4f} / {p2:.4f} ms per pass"
              f" ({m * m * steps / (times[name][0] * 1e6):.1f} Gpoint/s)")

    bcfg, dt, u0, mesh = bench_setup(torch, device)
    tiles = shard_field(u0, mesh)
    k1_adv = build_multistep_advance(bcfg, dt)
    slab_adv = halo.build_sharded_multistep_advance(bcfg, mesh, dt)
    over_adv = halo.build_sharded_overlap_advance(bcfg, mesh, dt)
    runs = {"K1": lambda: k1_adv(100)(u0), "slab": lambda: slab_adv(100)(tiles),
            "overlap": lambda: over_adv(100)(tiles)}
    ms = {name: [] for name in runs}
    for name in ("K1", "slab", "overlap", "overlap", "slab", "K1"):
        ms[name].append(events_ms(torch, device, runs[name], 5))
    pts = bcfg.nx * bcfg.ny * 100
    rates = {name: pts / (sum(v) / len(v) * 1e6) for name, v in ms.items()}
    for name, v in ms.items():
        print(f"[timing] 4096² f32 bench BCs, 100-step chunk, {name}"
              f"{' (2x2 mesh of one card)' if name != 'K1' else ' (single device)'}:"
              f" {' / '.join(f'{t:.3f}' for t in v)} ms,"
              f" {rates[name]:.1f} Gpoint/s ({rates[name] / rates['K1']:.2f}x K1)")
    return times, rates


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
    tile_cases, tile_worst = phase_tile_kernels_vs_plain(torch, device)
    launches = {n: 0 for n in KERNEL_NAMES}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches["K1"] += phase_main_path(
            torch, device, "bench_4096", BENCH_CFG,
            ["--steps=1000", "--out_every=500"], tmp,
        )
        launches["K1"] += phase_main_path(torch, device, "dev", DEV_CFG, [], tmp)
        bench = ["--steps=1000", "--out_every=500"]
        for label, cfg_path, extra, mesh_xy, kernel in (
            ("bench_4096_2x2_slab", BENCH_CFG, bench, (2, 2), "K4"),
            ("bench_4096_2x2_overlap", BENCH_CFG, [*bench, "--halo_overlap=true"], (2, 2), "K3"),
            ("dev_1x4", DEV_CFG, [], (1, 4), "K4"),
            ("dev_4x1", DEV_CFG, [], (4, 1), "K4"),
        ):
            launches[kernel] += phase_sharded_run(
                torch, device, label, cfg_path, extra, mesh_xy, kernel, tmp)[0]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches["K2"], _ = phase_per_step(torch, device)
    k_ms, p_ms = phase_timing(torch, device)
    tile_times, _ = phase_tile_timing(torch, device)

    sources = {"K1": "multistep_stencil.cu", "K2": "sharded_stencil.cu",
               "K3": "sharded_stencil.cu", "K4": "sharded_stencil.cu"}
    replaces = {"K1": 1309, "K2": 1371, "K3": 1418, "K4": 1525}
    titles = {"K1": "K1 multistep_stencil", "K2": "K2 prepadded_kernel_step",
              "K3": "K3 tile_region_multistep", "K4": "K4 sharded_tile_slab_multistep"}
    all_cases = {"K1": cases, **tile_cases}
    all_worst = {"K1": worst, **tile_worst}
    all_times = {"K1": (k_ms, p_ms), **tile_times}
    for n in KERNEL_NAMES:
        if launches[n] < 1:
            fail(f"{n} was launched no time on its path")
    kernels = {"kernels": [{
        "name": titles[n],
        "route": "cuda",
        "source": f"climate_sim_tpu_torch/csrc/{sources[n]}",
        "replaces": f"climate_sim_tpu/ops/pallas_stencil.py:{replaces[n]}",
        "launches": launches[n],
        "max_abs_err": all_worst[n]["float32"],
        "max_abs_err_by_dtype": all_worst[n],
        "cases": all_cases[n],
        "ms": all_times[n][0],
        "plain_ms": all_times[n][1],
    } for n in KERNEL_NAMES]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
