"""Smoke test of the PyTorch port on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (nothing is caught):

1. the device: its name, and its name and power limit from nvidia-smi;
2. the build of K1-K5 (csrc/*.cu) with nvcc, or a cache hit, with each
   kernel instantiation's registers and spills (a spill in float32 or
   bfloat16 fails), and of the native snapshot writer;
3. K1 against its plain PyTorch version on the card, over shapes (the
   streaming core's edges among them: a grid narrower than one band, nx
   one more than a band's output width, ny not a multiple of the segment
   height), BC classes, steps per pass (1 to 32) and dtypes;
4. the main path through the port's own CLI: configs/bench_4096.yaml at
   4096² and configs/dev.yaml at 512², each checked for exit code, the
   timing line, a K1 launch count equal to the pass schedule, snapshots that
   read back, and a final field that agrees with the plain per-step path
   run on the same card;
5. the time of one K1 pass (from a CUDA graph replay) and of its plain
   version at 4096², in f32, bf16 and f64; then the headline bench,
   ``python3 bench_torch.py`` at its defaults in its own process
   (``phase_bench``): one stdout line with ``bench.py``'s keys and metric,
   its value within 0.85-1.10x of K1's f32 rate just read, ``vs_baseline``
   the value over the card's one-step 8 B/point line, the roofline share
   and the pass-schedule share on stderr each at most 1, and K1 launched
   (1 + 3 x 600) x 13 times;
6. K2, K3 and K4 against their plain versions on the card, over tile
   shapes (a 2048² tile, the new shapes of phase 3 and K3's 8-column and
   8-row band regions included), BC classes, dtypes, steps per pass and
   the edge flags of every tile of 1x1, 2x2, 1x4 and 4x1 meshes, and K2 on
   the padded remainder tiles of phase 8; then K5 over the same shapes
   with several true extents (the full tile and l == k among them) and the
   flags of 2x2, 1x4 and 4x1 carrier meshes, and on the carrier tile of
   every carrier run of phase 7 at that run's staging depth, true extent,
   weights and pass sizes; then the seeded fuzz (``phase_fuzz``): K1-K5
   against their plain versions on random draws (K1 on grids 4-600 a side,
   all 81 BC mixes, compat, k 1-32, three dtypes; K2-K5 on random tiles,
   the edge flags of random tiles of meshes up to 8x4, K4/K5 staging
   depths and K5 true extents), with the same tolerances, a ``[fuzz]``
   line per kernel with the seed, its case count and worst errors;
7. the sharded path through ``run_simulation(cfg, [cuda:0] * n)``:
   bench_4096 on a 2x2 mesh with the slab path (K4) and with
   ``halo_overlap: true`` (K3), dev.yaml at 512² on 1x4 and 4x1, and the
   carrier path (K5) on grids the mesh does not divide: bench_4096's BCs
   at 4001² on 2x2 (y torus staging), dev.yaml at 509x511 on 1x4 and 4x1
   (one-sided y staging), all-periodic at 1001x999 on 2x2; each replaying
   its chunks as CUDA graphs (the banner says so) and checked for the
   timing and mesh lines, launch counts equal to the pass schedule times
   the tiles with every other kernel at 0, snapshots that read back, and
   a final field that agrees with the single-device K1 run on the same
   card; the bench_4096 slab run and the 4001² carrier run again under
   ``disable_graphs()``, their files byte-identical to the graphed runs'
   (``phase_eager_files``);
8. the per-step sharded path (K2) on a 2x2 mesh at 4096², 100 steps,
   held against the slab path and against K1; the per-step path on
   remainder tiles at 4001² on 2x2 (torch ops, and K2), 1000 steps,
   against K1; then ``phase_graphs``: each captured mesh path against its
   eager run on 2x2 of the card (slab, overlap and per-step K2 at 4096²,
   the carrier at 4001²; f32 on all, bf16 and f64 on slab and carrier;
   mixed and torus BCs; chunks of 1, 7, 100 and 256 steps), the tiles
   bit-identical and a replay's launches and ``mesh.copies`` equal to the
   eager chunk's, with each capture's seconds and memory, then eager and
   graphed 100-step chunks timed in turns; then the multi-process driver
   (``--distributed``, one process per rank, gloo between ranks that
   share the card, whose chunks stay eager by the capture rule): phase 7's
   bench_4096 slab and 4001² carrier runs on 4 ranks, its overlap run on
   2 ranks of 2 tiles, and a 4-rank restart from the slab run's file, each
   file byte-identical to its single-process counterpart, the launches
   summed over the ranks equal to the pass schedule, the log on rank 0
   only; then, with two cards or more, one process over a 2x2 mesh of the
   cards (``phase_nccl``): the slab, carrier and overlap runs, bench_4096's
   per-step path with torch ops and the per-step path with K2 on the
   remainder tiles of a 2^21 x 3 grid, each replaying its chunks as one
   CUDA graph that spans the cards, in turns with its eager run under
   ``disable_graphs()`` (graphed, eager, eager, graphed; files
   byte-identical), and one traced replay of each path's 100-step chunk
   held to its counted launches on every card; and, with four cards, one
   rank per card over NCCL on each, each file byte-identical to the
   single-process run's, its rate beside it; the ranks replay captured
   chunks, and the slab, carrier and per-step torch-ops runs also run
   eager in turns with them);
9. the port's tools, each through its entry point: an IC file from
   ``scripts/torch_generate_ic.py`` at 4096² run through the CLI and held
   to the preset run; ``scripts/torch_hw_conformance.py`` (every path x
   BC class against the f64 oracle; its ``N cases: ALL OK`` line);
   ``scripts/torch_run_benchmark.py`` on the ``cuda`` and ``multiproc``
   platforms (the CSV rows printed); ``scripts/torch_hw_rates.py`` (each
   path's rate against K1's, held to its band); then the study tools
   (``phase_study``):
   ``scripts/torch_bf16_study.py`` at its defaults (12 error rows and
   both perf lines, through K1), ``scripts/torch_sharded_path_bench.py``
   and ``scripts/torch_carrier_bench.py --single`` on a 1x1 mesh of the
   card (each path's field within SHARDED_ATOL of K1's), and bench_4096's
   snapshots read back through ``climate_sim_tpu_torch.visualization``
   (frame 0 the IC, the last frame the run's field, bit for bit); then the
   exchange-latency model (``phase_latency``): ``scripts/torch_exchange_latency.py``
   with 4 ranks sharing the card over gloo (2048² tiles, face-only and
   ``--load``; with four cards also NCCL ranks one a card, 2 on 1x2 and 4
   on 2x2 at 4096²), each line holding JAX's keys and ``rounds_per_iter``,
   and ``scripts/torch_latency_bound.py`` on a 2x2 mesh of the card at
   4096² (L in {0, 0.5, 1, 2} ms; the model fed the gloo latency a batch),
   the exchange depth 2 and each slope inside [depth - 0.5, batches + 1];
10. K2-K5 per pass (launches replayed from a CUDA graph, so the card's
   time and not the wrappers' host time is measured) beside their plain
   versions (K5 on a 2009x2001 carrier
   tile, in turns with K4 on 2048²; K2 also beside ``conv2d`` with its five
   weights as a 3x3 cross), the rates of the 2x2 slab and overlap paths at
   4096² and of the carrier path at 4001² on one card beside K1's, and
   profiled 1000-step runs through the driver, output off: the
   single-device main path (K1) and the carrier path (K5), each with its
   kernel time, launches, throughput line and busy share of the
   unprofiled wall.

The second line before the last is a JSON summary of the kernels (``cases``
counts the matrix cases of phases 3 and 6, ``fuzz_cases`` the fuzz's):
each kernel's ``launches`` sum the runs of phases 4, 7 and 8 (the paths' own
runs, the multi-process ranks' included), and its ``tools_launches`` count
phase 9's runs in this process (the study tools' and the latency
injection's among them) and K1's in ``bench_torch.py`` (from its stderr)
apart from them; the script fails if either is 0.  Then the card's name and power
limit from nvidia-smi; the last line is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without the
repository beside it, the script exits non-zero and prints no result.

``python3 chip_smoke.py --multiprocess-only`` runs phases 1 and 2, the
three phase-7 runs that the multi-process runs are held to, and the
multi-process runs (with four cards, the NCCL runs too);
``python3 chip_smoke.py --nccl-only`` phases 1 and 2, ``phase_nccl``
(one process over the cards, graphed and eager; with four cards the NCCL
runs) and the NCCL exchange-latency runs (it needs four cards);
``python3 chip_smoke.py --tools-only`` runs phases 1, 2 and 9's tools;
``python3 chip_smoke.py --study-only`` phases 1, 2 and ``phase_study``;
``python3 chip_smoke.py --latency-only`` phases 1, 2 and ``phase_latency``;
``python3 chip_smoke.py --bench-only`` phases 1, 2, K1's f32 timing of
phase 5 and ``phase_bench``;
``python3 chip_smoke.py --fuzz-only`` phases 1, 2 and ``phase_fuzz``;
``python3 chip_smoke.py --graphs-only`` phases 1, 2, ``phase_graphs`` and
phase 7's bench_4096 slab and 4001² carrier runs, each also under
``disable_graphs()``.
``python3 chip_smoke.py --parity-only`` phases 1, 2 and ``phase_parity``
(K1 in f64 with Dirichlet on all four sides at 4096², k = 8 and 4, against
its plain version; each pass's output digest and time by BC class).
``--fuzz-seed N`` (with any of these, or alone) draws the fuzz from N
instead of FUZZ_SEED.
"""

from __future__ import annotations

import contextlib
import hashlib
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
# (nx, ny); the streaming core's edges: a grid narrower than one band
# (20 wide), nx one more than a band's 240 output columns at k = 8 with ny
# not a multiple of the segment height (333 = 10 x 32 + 13).
SHAPES = [(128, 64), (120, 96), (20, 300), (241, 333), (4096, 4096)]
STEPS_PER_PASS = [1, 3, 8, 16, 32]
# K1 vs its plain version: FMA contraction and summation order differ, so
# f32 and f64 agree to round-off; bf16 rounds the two f32 results once
# each, so they agree to one bf16 ulp of the value (<= |value| * 2^-7).
ATOL = {"float32": 1e-5, "float64": 1e-12}
# K5 against its plain version, f32: the bound that K5 is held to (2.4e-7
# was the largest error over its unit-shape cases on the card).
K5_ATOL = {**ATOL, "float32": 1e-6}
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
# (mx, my); the new shapes as SHAPES, and K3's k-column and k-row band
# regions of a 2048² tile (K4/K5 take only k <= min(mx, my)).
TILE_SHAPES = [(128, 64), (120, 96), (20, 300), (241, 333), (8, 2048), (2048, 8),
               (2048, 2048)]
MESH_SHAPES = [(1, 1), (2, 2), (1, 4), (4, 1)]  # (px, py)
KERNEL_NAMES = ("K1", "K2", "K3", "K4", "K5")
TIMING_TILE = 2048  # the tile of a 2x2 mesh at 4096²
BENCH_GRID = 4096
CARRIER_GRID = 4001  # bench_4096's BCs at 4001² on 2x2: ...
CARRIER_TILE = (2009, 2001)  # ... 2009x2001 carrier tiles (my, mx) ...
CARRIER_EDGE = (1992, 2000)  # ... whose corner tile holds the true edge at (ly, lx)
BENCH_STEPS = ["--steps=1000", "--out_every=500"]
PADDED_STEPS = 1000  # the remainder-tile per-step runs of phase 8
# The carrier runs of phase 7: (label, config, overrides, (px, py)).
CARRIER_RUNS = (
    (f"bench_{CARRIER_GRID}_2x2_carrier", BENCH_CFG,
     [*BENCH_STEPS, f"--nx={CARRIER_GRID}", f"--ny={CARRIER_GRID}"], (2, 2)),
    ("dev_509x511_1x4_carrier", DEV_CFG, ["--nx=509", "--ny=511"], (1, 4)),
    ("dev_509x511_4x1_carrier", DEV_CFG, ["--nx=509", "--ny=511"], (4, 1)),
    ("periodic_1001x999_2x2_carrier", BENCH_CFG,
     [*BENCH_STEPS, "--nx=1001", "--ny=999", "--bc=periodic"], (2, 2)),
)
# Carrier tiles of at most this many cells are checked under every BC
# class besides their run's own.
SMALL_TILE = 1 << 19
# The card's published peaks and the stencil's operations a cell and step
# are climate_sim_tpu_torch.benchproto's (DEVICE_PEAKS, FLOPS_PER_POINT_STEP);
# a card missing there fails the bounds.


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


_DTYPES = {"ff": "float32", "dd": "float64", "13__nv_bfloat16f": "bfloat16"}
_SOURCES = {"WrapSource": "K1", "RegionSource": "K2/K3", "SlabSource": "K4/K5"}


def kernel_resources(log):
    """Per kernel instantiation in ptxas' -v output: (kernels, dtype, level
    count, columns a thread, registers, stack frame bytes, spill store
    bytes, spill load bytes)."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name, frame = m.group(1), (0, 0, 0)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                      r" (\d+) bytes spill loads", line)
        if m and name:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            k = re.search(r"band_kernelI(13__nv_bfloat16f|ff|dd)Li(\d+)ELi(\d+)E.*?"
                          r"(WrapSource|RegionSource|SlabSource)", name)
            if k:
                out.append((_SOURCES[k.group(4)], _DTYPES[k.group(1)], int(k.group(2)),
                            int(k.group(3)), int(m.group(1)), *frame))
            name = None
    return out


def phase_build():
    """Build (or find) the kernels' library; print each instantiation's
    registers, stack frame and spills, and fail on a spill in float32 or
    bfloat16 or in any instantiation of K1's wide body (several columns a
    thread)."""
    from climate_sim_tpu_torch.ops._build import load_library

    t0 = time.perf_counter()
    kl = load_library()
    how = f"built in {kl.seconds:.1f} s" if kl.built else "cache hit"
    print(f"[build] {os.path.relpath(kl.path, HERE)}: {how}"
          f" ({time.perf_counter() - t0:.1f} s with load)")
    res = kernel_resources(kl.log)
    # The native snapshot writer builds with the host compiler; a fallback
    # to the Python codec on the card would be a failure, not a warning.
    from climate_sim_tpu_torch.io import native

    native.load_library()
    print(f"[build] {os.path.relpath(native.library_path(), HERE)}: the native snapshot"
          " writer loaded")
    for kern, dtype, levels, cols, regs, frame, st, ld in sorted(res):
        spill = f"spills {st} B stored, {ld} B loaded" if st or ld else "no spills"
        print(f"[build] {kern} {dtype} {levels} levels x{cols} columns: {regs} registers,"
              f" {frame} B stack frame, {spill}")
    if kl.built and not res:
        fail("no kernel resources in the build log")
    bad = [r for r in res if (r[1] != "float64" or r[3] > 1) and (r[6] or r[7])]
    if bad:
        fail(f"spills in float32/bfloat16 or wide kernels: {bad}")


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
    if any(counts[n] for n in KERNEL_NAMES if n != "K1"):
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


def phase_timing(torch, device, dtypes=("float32", "bfloat16", "float64")):
    """Per-pass time of K1 and of its plain version at 4096², k = 8, bench
    BCs, in each of ``dtypes``, measured in turns per dtype: plain, K1, K1,
    plain (K1 by CUDA graph replay, the plain version, which synchronises
    with the host, by events).  Returns {dtype: (K1 ms, plain ms,
    bound)}."""
    from climate_sim_tpu_torch.benchproto import FLOPS_PER_POINT_STEP
    from climate_sim_tpu_torch.ops import cuda_stencil as cs

    nx = ny = BENCH_GRID
    cfg = make_cfg(nx, ny, "bench")
    base = edge_parked(torch, ny, nx, seed=7, device=device)
    k = 8
    pts = nx * ny * k
    out = {}
    for name in dtypes:
        dtype = getattr(torch, name)
        u = base.to(dtype)
        ms = in_turns(torch, device,
                      {"K1": lambda: cs.multistep_kernel_step(u, cfg, cfg.dt, k),
                       "plain": lambda: cs.multistep_pass_plain(u, cfg, cfg.dt, k)},
                      ("plain", "K1", "K1", "plain"), {"K1": 60, "plain": 5},
                      graphed=("K1",))
        k_ms, p_ms = sum(ms["K1"]) / 2, sum(ms["plain"]) / 2
        b = bound(2 * nbytes(u), FLOPS_PER_POINT_STEP * pts, dtype)
        out[name] = (k_ms, p_ms, b)
        print(f"[timing] {nx}x{ny} {name}, k={k} steps per pass, bench BCs:"
              f" K1 {' / '.join(f'{t:.4f}' for t in ms['K1'])} ms per pass, plain"
              f" {' / '.join(f'{t:.4f}' for t in ms['plain'])} ms;"
              f" K1 {pts / (k_ms * 1e6):.1f} Gpoint/s, plain {pts / (p_ms * 1e6):.1f};"
              f" bound {b[0]:.4f} ms ({b[1]}), {b[0] / k_ms:.1%} of it reached")
    return out


BENCH_TIMEOUT_S = 300
BENCH_KEYS = ["metric", "value", "unit", "vs_baseline"]
BENCH_METRIC = "grid_points_per_s_per_chip_4096sq_diffadv"
# The warm-up chunk and 3 trials of 600 chunks, 13 K1 passes a 100-step
# chunk at 4096² (12 of 8 steps and one of 4).
BENCH_K1_LAUNCHES = (1 + 3 * 600) * 13
# The bench's chained chunks against phase 5's graph-replayed k = 8 pass:
# the chunk's 4-step pass and the host's enqueue may move it either way.
BENCH_RATE_BAND = (0.85, 1.10)


def phase_bench(torch, device, k1_ms):
    """``python3 bench_torch.py`` at its defaults, in its own process:
    exit 0, one stdout line with ``bench.py``'s keys and metric, ``value``
    within BENCH_RATE_BAND of K1's f32 rate from phase 5 (``k1_ms`` a k = 8
    pass at 4096²), ``vs_baseline`` the value over the card's one-step
    8 B/point line, the roofline and pass-schedule shares on stderr each in
    (0, 1], and K1 launched BENCH_K1_LAUNCHES times.  Returns those
    launches by kernel (tools' launches: the bench is not the paths'
    run)."""
    from climate_sim_tpu_torch.benchproto import peaks

    t0 = time.perf_counter()
    rc, out, err = run_tool(["bench_torch.py"], timeout=BENCH_TIMEOUT_S)
    for line in err.splitlines():
        print(f"[bench] stderr: {line}")
    if rc != 0:
        fail(f"bench_torch.py exited {rc}: {err[-2000:]}")
    lines = out.splitlines()
    if len(lines) != 1:
        fail(f"bench_torch.py printed {len(lines)} stdout lines, not 1: {out[-2000:]}")
    result = json.loads(lines[0])
    print(f"[bench] stdout: {json.dumps(result)}")
    if list(result) != BENCH_KEYS or result["metric"] != BENCH_METRIC \
            or result["unit"] != "points/s":
        fail(f"bench_torch.py's line is not bench.py's: {result}")
    k1_rate = BENCH_GRID * BENCH_GRID * 8 / (k1_ms * 1e-3)
    ratio = result["value"] / k1_rate
    lo, hi = BENCH_RATE_BAND
    if not lo <= ratio <= hi:
        fail(f"bench value {result['value']} is {ratio:.3f}x K1's {k1_rate:.1f}, outside"
             f" [{lo}, {hi}]")
    line_rate = peaks(torch.cuda.get_device_name(device)).bytes_per_s / 8
    if result["vs_baseline"] != round(result["value"] / line_rate, 4):
        fail(f"vs_baseline {result['vs_baseline']} is not value / {line_rate:.4g}")
    shares = {label: float(re.search(rf"{label} share=(\S+)", err).group(1))
              for label in ("roofline", "pass-schedule")}
    for label, share in shares.items():
        if not 0 < share <= 1.0:
            fail(f"the {label} share {share} is not in (0, 1]")
    launches = int(re.search(r"^\[bench\] K1 launches=(\d+)$", err, re.M).group(1))
    if launches != BENCH_K1_LAUNCHES:
        fail(f"bench_torch.py launched K1 {launches} times, not {BENCH_K1_LAUNCHES}")
    print(f"[bench] {result['value'] / 1e9:.2f} Gpoint/s, {ratio:.3f}x K1's graph-replayed"
          f" pass ({k1_rate / 1e9:.1f}); vs_baseline {result['vs_baseline']}; roofline share"
          f" {shares['roofline']:.4f}, pass-schedule share {shares['pass-schedule']:.4f};"
          f" K1 launches {launches}; {time.perf_counter() - t0:.1f} s")
    return {n: launches if n == "K1" else 0 for n in KERNEL_NAMES}


# The reference-parity deployment (configs/parity_f64.yaml at the 4096²
# grid): K1's full and remainder passes of a 100-step span.
PARITY_STEPS = (8, 4)


def phase_parity(torch, device):
    """``--parity-only``: K1 at 4096² in f64 with Dirichlet on all four
    sides and the parity physics (v (0.5, 0)), k = 8 and 4, against its
    plain version, with the cut it runs (``k1_geometry``); then each
    pass in f64 and f32 timed by graph replay in turns with the same pass
    under bench_4096's BCs (no fixed y side, so no block takes the wide
    body's select path) and under P,P,D,N (fixed y sides, live x wrap).
    Each pass's output is printed as a SHA-256 digest, so that two
    checkouts' kernels can be held to each other bit for bit.  Returns
    {"<dtype> k<k>": {BC class: [ms, ms]}}."""
    from climate_sim_tpu_torch.ops import cuda_stencil as cs

    nx = ny = BENCH_GRID
    cfgs = {cls: make_cfg(nx, ny, cls) for cls in ("D4", "bench", "MIX2")}
    for c in cfgs.values():
        c.vy = 0.0
    u = edge_parked(torch, ny, nx, seed=20, device=device)
    for k in PARITY_STEPS:
        cfg = cfgs["D4"]
        got = cs.multistep_kernel_step(u, cfg, cfg.dt, k)
        torch.cuda.synchronize(device)
        err = float((got - cs.multistep_pass_plain(u, cfg, cfg.dt, k)).abs().max())
        if not err <= ATOL["float64"]:
            fail(f"K1 vs plain: parity {nx}x{ny} float64 k={k}: max abs err {err:.3g}")
        print(f"[parity] {nx}x{ny} float64, Dirichlet on all sides, k={k}:"
              f" {cs.k1_geometry(ny, nx, k, torch.float64)}; max abs err {err:.3g}")
    out = {}
    for dtype in (torch.float64, torch.float32):
        v = u.to(dtype)
        name = str(dtype).removeprefix("torch.")
        for k in PARITY_STEPS:
            fns = {cls: lambda c=c: cs.multistep_kernel_step(v, c, c.dt, k)
                   for cls, c in cfgs.items()}
            for cls, fn in fns.items():
                digest = hashlib.sha256(fn().cpu().numpy().tobytes()).hexdigest()[:16]
                print(f"[parity] digest {name} k={k} {cls}: {digest}")
            ms = out[f"{name} k{k}"] = in_turns(
                torch, device, fns, ("D4", "bench", "MIX2", "MIX2", "bench", "D4"),
                dict.fromkeys(fns, 60), graphed=tuple(fns))
            print(f"[parity] {nx}x{ny} {name} k={k} by BC class, ms per pass: " + ", ".join(
                f"{cls} {' / '.join(f'{t:.4f}' for t in ts)}" for cls, ts in ms.items()))
    return out


def bench_after_timing(torch, device, tmp):
    """``--bench-only``: phase 5's K1 timing in f32, the rate the bench is
    held to, then :func:`phase_bench`."""
    return phase_bench(torch, device, phase_timing(torch, device, ("float32",))["float32"][0])


def counters():
    """The launch counter of each kernel's wrapper, by kernel name."""
    from climate_sim_tpu_torch.ops import cuda_sharded as sh
    from climate_sim_tpu_torch.ops import cuda_stencil as cs

    return {"K1": cs.multistep_kernel_step, "K2": sh.prepadded_kernel_step,
            "K3": sh.tile_region_multistep, "K4": sh.sharded_tile_slab_multistep,
            "K5": sh.carrier_tile_slab_multistep}


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


def compare(torch, label, got, want, dtype, atol=ATOL):
    """Max abs error of a kernel result against its plain version; fails
    past the dtype's tolerance in ``atol`` (bf16: one ulp of the value)."""
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
        ok = float(err.max()) <= atol[name]
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
                        if flags is None or k > min(mx, my):  # K4: kh <= the tile
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
    # K2 on the padded remainder tiles of the per-step paths: 4001² on 2x2
    # (phase 8) and REMAINDER_GRID on 2x2 (the NCCL ranks of phase 8), each
    # under its run's weights.
    from climate_sim_tpu_torch.parallel.mesh import split_sizes

    for nx, ny in ((CARRIER_GRID, CARRIER_GRID), REMAINDER_GRID):
        rem_cfg, rem_dt = bench_config(nx, ny)
        rem_shapes = sorted({(h + 2, w + 2) for h in split_sizes(ny, 2)
                             for w in split_sizes(nx, 2)})
        rem_cases = 0
        for h, w in rem_shapes:
            for dtype in (torch.float32, torch.float64, torch.bfloat16):
                up = edge_parked(torch, h, w, seed=h + w, device=device).to(dtype)
                got = sh.prepadded_kernel_step(up, rem_cfg, rem_dt)
                torch.cuda.synchronize(device)
                want = sh.prepadded_step_plain(up, rem_cfg, rem_dt)
                name, e = compare(torch, f"K2 remainder tile {h}x{w} {dtype}", got, want,
                                  dtype)
                worst["K2"][name] = max(worst["K2"][name], e)
                rem_cases += 1
        cases["K2"] += rem_cases
        print(f"[tile-kernels-vs-plain] K2 on the padded remainder tiles of {nx}x{ny} on"
              f" 2x2 {rem_shapes} x 3 dtypes: {rem_cases} cases ok")
    for n in ("K2", "K3", "K4"):
        errs = ", ".join(f"{d} {e:.3g}" for d, e in worst[n].items())
        print(f"[tile-kernels-vs-plain] {n}: {cases[n]} cases ok; max abs err {errs}")
    print(f"[tile-kernels-vs-plain] {len(TILE_SHAPES)} tile shapes x {len(BC_CLASSES)}"
          f" BC classes x 3 dtypes; K3/K4 k in {STEPS_PER_PASS} (K4: k <= the tile) x"
          f" {len(flag_sets)} mesh-tile flag sets (K3 also unflagged)")
    return cases, worst


def carrier_flag_sets():
    """The edge flags of every tile of 2x2, 1x4 and 4x1 carrier meshes (the
    edge tile last), and of a trailing all-pad tile."""
    out = []
    for flags in mesh_flag_sets():
        if flags not in out and flags != (1, 1, 1, 1):
            out.append(flags)
    return out + [(0, 0, 0, 0)]


def carrier_run_geometry(cfg_path, extra, mesh_xy):
    """What a carrier run of phase 7 gives K5: its config and clamped dt,
    the carrier tile (my, mx), the staging depth KH, every tile's flags6,
    and the step counts of its passes (a remainder pass runs fewer steps on
    the KH-deep slabs)."""
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.ops.stability import clamp_dt
    from climate_sim_tpu_torch.parallel.halo import build_carrier_slab_advance
    from climate_sim_tpu_torch.parallel.mesh import make_mesh
    from climate_sim_tpu_torch.runtime import driver

    px, py = mesh_xy
    cfg = merged_config(cfg_path, [*extra, f"--mesh.x={px}", f"--mesh.y={py}",
                                   "--kernel=pallas"])
    dt = clamp_dt(cfg.dt, cfg.dx, cfg.dy, cfg.vx, cfg.vy, cfg.D)[0]
    adv = build_carrier_slab_advance(cfg, make_mesh(px, py, ["cpu"] * (px * py)), dt)
    kh = adv.steps_per_pass
    ks = {min(kh, piece - j) for span in driver.span_lengths(cfg)
          for piece in driver.span_pieces(span) for j in range(0, piece, kh)}
    flags6 = sorted({adv.flags6(y, x) for y in range(py) for x in range(px)})
    tile = (adv.carrier_shape[0] // py, adv.carrier_shape[1] // px)
    return cfg, dt, tile, kh, flags6, ks


def phase_carrier_kernel_vs_plain(torch, device):
    """K5 against its plain version on random carrier tiles and slabs made
    on the card (the whole tile, pad included), f32 within K5_ATOL: first
    on the unit tile shapes over the true extents (my, mx), (k, k) and one
    in between and every carrier tile's flags; then on the carrier tile of
    each carrier run of phase 7, at that run's staging depth, true extent
    and weights, under every carrier tile's flags (the run's own tiles'
    among them), k in {1, 3, KH} and the run's remainder pass, and, on the
    smaller tiles, every BC class too."""
    from climate_sim_tpu_torch.ops import cuda_sharded as sh

    flag_sets = carrier_flag_sets()
    worst = {"float32": 0.0, "float64": 0.0, "bfloat16": 0.0}
    cases = {"unit": 0, "main": 0}

    def check(where, tile, xh, yh, f6, cfg, dt, k, kh, label):
        got = sh.carrier_tile_slab_multistep(tile, xh, yh, f6, cfg, dt, k, khalo=kh)
        torch.cuda.synchronize(device)
        want = sh.carrier_pass_plain(tile, xh, yh, f6, cfg, dt, k, kh)
        name, e = compare(torch, f"K5 {label} k={k} KH={kh} flags6={f6}", got, want,
                          tile.dtype, K5_ATOL)
        worst[name] = max(worst[name], e)
        cases[where] += 1

    for mx, my in TILE_SHAPES:
        for bc_class in BC_CLASSES:
            cfg = make_cfg(mx, my, bc_class)
            for dtype in (torch.float32, torch.float64, torch.bfloat16):
                for k in STEPS_PER_PASS:
                    if k > min(mx, my):  # K5 takes kh <= the tile
                        continue
                    w = edge_parked(torch, my + 2 * k, mx + 2 * k, seed=mx + 3 * k,
                                    device=device).to(dtype)
                    tile, xh, yh = slabs(torch, w, k)
                    for ly, lx in ((my, mx), (k, k), (my - my // 3, mx - mx // 5)):
                        for flags in flag_sets:
                            check("unit", tile, xh, yh, (*flags, ly, lx), cfg, cfg.dt, k, k,
                                  f"{mx}x{my} {bc_class} {dtype}")
    print(f"[tile-kernels-vs-plain] K5: {cases['unit']} unit cases ok ({len(TILE_SHAPES)} tile"
          f" shapes x {len(BC_CLASSES)} BC classes x 3 dtypes x k in {STEPS_PER_PASS}, k <="
          f" the tile, x 3 true extents x {len(flag_sets)} carrier-tile flag sets)")

    for label, cfg_path, extra, mesh_xy in CARRIER_RUNS:
        run_cfg, dt, (my, mx), kh, run_f6, ks = carrier_run_geometry(cfg_path, extra, mesh_xy)
        ly, lx = run_f6[0][4:]
        f6s = sorted(set(run_f6) | {(*f, ly, lx) for f in flag_sets})
        cfgs = [("run's own", run_cfg, dt)]
        if my * mx <= SMALL_TILE:
            cfgs += [(c, make_cfg(mx, my, c), 0.1) for c in BC_CLASSES]
        k_set = sorted(k for k in {1, 3, kh} | ks if k <= kh)
        before = cases["main"]
        for dtype in (torch.float32, torch.float64, torch.bfloat16):
            w = edge_parked(torch, my + 2 * kh, mx + 2 * kh, seed=my + mx,
                            device=device).to(dtype)
            tile, xh, yh = slabs(torch, w, kh)
            for bc_name, cfg, cdt in cfgs:
                for k in k_set:
                    for f6 in f6s:
                        check("main", tile, xh, yh, f6, cfg, cdt, k, kh,
                              f"{label} {my}x{mx} {bc_name} BCs {dtype}")
        print(f"[tile-kernels-vs-plain] K5 on {label}'s {my}x{mx} carrier tile, KH={kh}, true"
              f" extent ({ly}, {lx}): {cases['main'] - before} cases ok ({len(cfgs)} BC"
              f" set(s) x 3 dtypes x k in {k_set} x {len(f6s)} flag sets)")
    errs = ", ".join(f"{d} {e:.3g}" for d, e in worst.items())
    total = cases["unit"] + cases["main"]
    print(f"[tile-kernels-vs-plain] K5: {total} cases ok ({cases['unit']} unit,"
          f" {cases['main']} at the carrier runs' tiles); max abs err {errs}"
          f" (f32 tol {K5_ATOL['float32']})")
    return total, worst


# The fuzz phase: a fixed default seed (``--fuzz-seed`` changes it) and case
# counts fixed here, never by the clock (about 60 s on an H100).
FUZZ_SEED = 20261017
FUZZ_CASES = {"K1": 2000, "K2": 1000, "K3": 2000, "K4": 2000, "K5": 2000}
FUZZ_MAX_SIDE = 600
FUZZ_MESHES = [(px, py) for px in range(1, 9) for py in range(1, 5)]  # up to 8x4


def fuzz_config(rng, nx, ny):
    """A config with random weights (D, v of both signs, dx, dy and dt
    inside the combined bound, so that values stay bounded and the
    absolute tolerances keep their meaning), one of the 81 BC mixes and
    compat in a quarter of the draws."""
    from climate_sim_tpu_torch.config import BCConfig, SimConfig, bc_from_string

    bcs = [rng.choice((D, N, P)) for _ in range(4)]
    diff = rng.uniform(0.0, 0.25)
    vx, vy = rng.uniform(-1.0, 1.0), rng.uniform(-1.0, 1.0)
    dx, dy = rng.choice((0.5, 1.0, 2.0)), rng.choice((0.5, 1.0, 2.0))
    denom = abs(vx) / dx + abs(vy) / dy + 2 * diff * (1 / dx**2 + 1 / dy**2)
    dt = rng.uniform(0.3, 0.95) / denom if denom else 0.1
    cfg = SimConfig(nx=nx, ny=ny, D=diff, vx=vx, vy=vy, dx=dx, dy=dy, dt=dt)
    cfg.bc = BCConfig(*(bc_from_string(b) for b in bcs))
    cfg.strict_reference_compat = rng.random() < 0.25
    return cfg


def fuzz_side(rng):
    """A tile side: small (1-40) or up to FUZZ_MAX_SIDE, half each."""
    return rng.randint(1, 40) if rng.random() < 0.5 else rng.randint(1, FUZZ_MAX_SIDE)


def fuzz_flags(rng):
    """The edge flags of a random tile of a random mesh up to 8x4."""
    px, py = rng.choice(FUZZ_MESHES)
    x, y = rng.randrange(px), rng.randrange(py)
    return (int(x == 0), int(x == px - 1), int(y == 0), int(y == py - 1))


def phase_fuzz(torch, device, seed=FUZZ_SEED):
    """K1-K5 against their plain versions on random draws from ``seed``,
    with the tolerances of phases 3 and 6; fields made on the card, mass
    parked against every edge.  K1: grids 4-600 on each side (a quarter of
    the widths one off a multiple of the band's output width), all 81 BC
    mixes, compat, k 1-32, f32/bf16/f64.  K2-K5: random tile shapes, the
    edge flags of random tiles of meshes up to 8x4 (K3 also unflagged, read
    through a strided view and written into a region of a larger output in
    half the draws), K4/K5 staging depths k-32 within the tile, and K5 true
    extents from k to the full tile."""
    import random

    from climate_sim_tpu_torch.ops import cuda_sharded as sh
    from climate_sim_tpu_torch.ops import cuda_stencil as cs

    t0 = time.perf_counter()
    dtypes = (torch.float32, torch.float64, torch.bfloat16)
    worst = {n: {"float32": 0.0, "float64": 0.0, "bfloat16": 0.0} for n in FUZZ_CASES}
    cases = {n: 0 for n in FUZZ_CASES}

    def field(rng, ny, nx, dtype):
        return edge_parked(torch, ny, nx, seed=rng.randrange(1 << 30), device=device).to(dtype)

    def check(name, label, kernel, plain, dtype):
        label = f"fuzz seed {seed} {name} {label}"
        try:
            got = kernel()
            torch.cuda.synchronize(device)
        except RuntimeError as e:
            fail(f"{label}: {e}")
        atol = K5_ATOL if name == "K5" else ATOL
        d, e = compare(torch, label, got, plain(), dtype, atol)
        worst[name][d] = max(worst[name][d], e)
        cases[name] += 1

    # The draw that found band widths the core refuses (odd k in 9-15 gave
    # widths of 16 mod 32), kept as a fixed case.
    cfg = make_cfg(326, 262, "D4")
    u = edge_parked(torch, 262, 326, seed=11, device=device)
    check("K1", "326x262 k=11 float64 (fixed)",
          lambda: cs.multistep_kernel_step(u, cfg, cfg.dt, 11),
          lambda: cs.multistep_pass_plain(u, cfg, cfg.dt, 11), torch.float64)
    rng = random.Random(seed)
    for _ in range(FUZZ_CASES["K1"]):
        k = rng.randint(1, cs.MAX_STEPS_PER_PASS)
        ny = rng.randint(4, FUZZ_MAX_SIDE)
        nx = rng.randint(4, FUZZ_MAX_SIDE)
        dtype = rng.choice(dtypes)
        if rng.random() < 0.25:  # one off a multiple of the band's output width
            out_w = cs.k1_geometry(ny, nx, k, dtype).width - 2 * k
            nx = min(FUZZ_MAX_SIDE, max(4, out_w * rng.randint(1, 4) + rng.choice((-1, 1))))
        cfg = fuzz_config(rng, nx, ny)
        u = field(rng, ny, nx, dtype)
        check("K1", f"{nx}x{ny} k={k} {dtype} bc={cfg.bc} compat={cfg.strict_reference_compat}",
              lambda: cs.multistep_kernel_step(u, cfg, cfg.dt, k),
              lambda: cs.multistep_pass_plain(u, cfg, cfg.dt, k), dtype)

    for _ in range(FUZZ_CASES["K2"]):
        my, mx = fuzz_side(rng), fuzz_side(rng)
        cfg, dtype = fuzz_config(rng, mx, my), rng.choice(dtypes)
        up = field(rng, my + 2, mx + 2, dtype)
        check("K2", f"{mx}x{my} {dtype}", lambda: sh.prepadded_kernel_step(up, cfg, cfg.dt),
              lambda: sh.prepadded_step_plain(up, cfg, cfg.dt), dtype)

    for _ in range(FUZZ_CASES["K3"]):
        my, mx = fuzz_side(rng), fuzz_side(rng)
        k = rng.randint(1, cs.MAX_STEPS_PER_PASS)
        kh = rng.randint(k, cs.MAX_STEPS_PER_PASS)
        cfg, dtype = fuzz_config(rng, mx, my), rng.choice(dtypes)
        flags = fuzz_flags(rng) if rng.random() < 0.75 else None
        extra = rng.choice((0, rng.randint(1, 64)))  # strided rows when > 0
        w = field(rng, my + 2 * kh, mx + 2 * kh + extra, dtype)[:, :mx + 2 * kh]
        out = None
        if rng.random() < 0.5:  # a region of a larger output
            big = torch.zeros((my + 3, mx + 5), dtype=dtype, device=device)
            out = big[1:1 + my, 2:2 + mx]
        check("K3", f"{mx}x{my} k={k} kh={kh} extra={extra} flags={flags} {dtype}",
              lambda: sh.tile_region_multistep(w, flags or sh.NO_FLAGS, cfg, cfg.dt, k, my,
                                               mx, flagged=flags is not None, khalo=kh,
                                               out=out),
              lambda: sh.region_pass_plain(w, cfg, cfg.dt, k, my, mx,
                                           flags or sh.NO_FLAGS, kh), dtype)

    for name in ("K4", "K5"):
        for _ in range(FUZZ_CASES[name]):
            my, mx = fuzz_side(rng), fuzz_side(rng)
            top = min(my, mx, cs.MAX_STEPS_PER_PASS)  # K4/K5 take kh <= the tile
            k = rng.randint(1, top)
            kh = rng.randint(k, top)
            cfg, dtype = fuzz_config(rng, mx, my), rng.choice(dtypes)
            tile, xh, yh = slabs(torch, field(rng, my + 2 * kh, mx + 2 * kh, dtype), kh)
            flags = fuzz_flags(rng)
            if name == "K4":
                check(name, f"{mx}x{my} k={k} kh={kh} flags={flags} {dtype}",
                      lambda: sh.sharded_tile_slab_multistep(tile, xh, yh, flags, cfg,
                                                             cfg.dt, k, khalo=kh),
                      lambda: sh.slab_pass_plain(tile, xh, yh, flags, cfg, cfg.dt, k, kh),
                      dtype)
                continue
            f6 = (*flags, rng.randint(min(k, my), my), rng.randint(min(k, mx), mx))
            check(name, f"{mx}x{my} k={k} kh={kh} flags6={f6} {dtype}",
                  lambda: sh.carrier_tile_slab_multistep(tile, xh, yh, f6, cfg, cfg.dt, k,
                                                         khalo=kh),
                  lambda: sh.carrier_pass_plain(tile, xh, yh, f6, cfg, cfg.dt, k, kh), dtype)

    for name in FUZZ_CASES:
        errs = ", ".join(f"{d} {e:.3g}" for d, e in worst[name].items())
        print(f"[fuzz] {name}: seed {seed}, {cases[name]} cases ok; max abs err {errs}")
    print(f"[fuzz] {sum(cases.values())} cases in {time.perf_counter() - t0:.1f} s")
    return cases, worst


def expected_tile_passes(cfg, px, py):
    """Passes per tile of a sharded run: spans between snapshots, pieces of
    at most 256 steps, passes of the tile's k (fixed once from the
    ceil(n/p) tile and out_every)."""
    import dataclasses

    from climate_sim_tpu_torch.ops.cuda_stencil import pick_steps_per_pass
    from climate_sim_tpu_torch.runtime import driver

    tile = dataclasses.replace(cfg, nx=-(-cfg.nx // px), ny=-(-cfg.ny // py))
    k = pick_steps_per_pass(tile, cfg.out_every or 8)
    return sum(-(-piece // k) for span in driver.span_lengths(cfg)
               for piece in driver.span_pieces(span))


def schedule_counts(cfg, kernel, per_step, warmup, px=2, py=2):
    """(timed passes a tile, launch counts) of a run of ``cfg`` on a px x py
    mesh with ``warmup`` untimed passes: ``kernel`` (None: torch ops only)
    5 times a tile and pass for K3, once for the others, and once a tile
    and step on a per-step path; every other kernel 0."""
    expect = cfg.steps if per_step else expected_tile_passes(cfg, px, py)
    want = {name: 0 for name in KERNEL_NAMES}
    if kernel:
        want[kernel] = (5 if kernel == "K3" else 1) * (expect + warmup) * px * py
    return expect, want


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
    path = {"K3": "overlap, K3", "K4": "slab, K4", "K5": "carrier, K5"}[kernel]
    if f"path: {path} CUDA kernel, chunks as CUDA graphs" not in out:
        fail(f"{label}: the run did not take the {path} CUDA path with captured chunks")
    if (kernel == "K5") != ("running the CARRIER path" in out):
        fail(f"{label}: the [info] CARRIER line is {'missing' if kernel == 'K5' else 'wrong'}")
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
    # The single-device K1 run of the same config, snapshots included: a
    # snapshot copied while the next span ran must hold its own step.
    ref_cfg = merged_config(cfg_path, [*args, f"--output.dir={os.path.join(tmp, label + '_k1')}"])
    with contextlib.redirect_stdout(io.StringIO()):
        ref = driver.run_simulation(ref_cfg, [device]).u
    with NetCDFFile(ref_cfg.resolved_output_path()) as ds:
        ref_frames = ds.variables["u"][:, :, :]
    err = float((res.u - ref).abs().max())
    snap_err = float(np.abs(frames - ref_frames).max())
    if not max(err, snap_err) <= SHARDED_ATOL:
        fail(f"{label}: vs the single-device K1 run: final {err:.3g}, snapshots"
             f" {snap_err:.3g} > {SHARDED_ATOL}")
    print(f"[sharded:{label}] {expect_snaps} snapshots + final read back; vs the"
          f" single-device K1 run: final field max abs err {err:.3g}, every snapshot"
          f" {snap_err:.3g} (tol {SHARDED_ATOL})")
    return counts[kernel], err, cfg.resolved_output_path()


def bench_config(n, ny=None):
    """bench_4096's config at n x ny (ny = n by default) with the kernel
    named, and its clamped dt."""
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.ops.stability import clamp_dt

    cfg = merged_config(BENCH_CFG, ["--kernel=pallas", f"--nx={n}", f"--ny={ny or n}"])
    return cfg, clamp_dt(cfg.dt, cfg.dx, cfg.dy, cfg.vx, cfg.vy, cfg.D)[0]


def bench_setup(torch, device, px=2, py=2, n=None):
    """bench_4096's config at n² (default 4096²) f32 with the kernel named,
    its clamped dt, its IC on the card and a px x py mesh of the card."""
    from climate_sim_tpu_torch.ops.init import apply_initial_condition
    from climate_sim_tpu_torch.parallel.mesh import make_mesh

    cfg, dt = bench_config(n or BENCH_GRID)
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
    want = {name: 0 for name in KERNEL_NAMES}
    want["K2"] = 100 * 4
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


def phase_padded_per_step(torch, device):
    """build_padded_advance on remainder tiles (split 2000 | 2001) at 4001²
    on a 2x2 mesh, PADDED_STEPS steps (a run's length, so K2's launches
    per run are counted, not computed), with torch ops (kernel=jnp) and
    with K2; each held against K1 at 4001²."""
    import dataclasses

    from climate_sim_tpu_torch.ops.cuda_stencil import build_multistep_advance
    from climate_sim_tpu_torch.parallel import halo
    from climate_sim_tpu_torch.parallel.mesh import gather_field, shard_field

    n = CARRIER_GRID
    cfg, dt, u0, mesh = bench_setup(torch, device, n=n)
    steps = PADDED_STEPS
    k1 = build_multistep_advance(cfg, dt)(steps)(u0)
    tiles = shard_field(u0, mesh)
    launches = 0
    for kernel, want_k2 in (("jnp", 0), ("pallas", steps * 4)):
        adv = halo.build_padded_advance(dataclasses.replace(cfg, kernel=kernel), mesh, dt)
        reset_counts()
        out = gather_field(adv(steps)(tiles), mesh)
        torch.cuda.synchronize(device)
        counts = read_counts()
        want = {name: 0 for name in KERNEL_NAMES}
        want["K2"] = want_k2
        if counts != want:
            fail(f"padded per-step {kernel}: launches {counts} != {want}")
        err = float((out - k1).abs().max())
        if out.shape != (n, n) or not torch.isfinite(out).all() or err > SHARDED_ATOL:
            fail(f"padded per-step {kernel}: {tuple(out.shape)}, max abs err vs K1"
                 f" {err:.3g} > {SHARDED_ATOL}")
        launches += counts["K2"]
        print(f"[padded-per-step] {n}² on 2x2 remainder tiles"
              f" {[tuple(t.shape) for row in tiles for t in row]}, {steps} steps, kernel={kernel}:"
              f" K2 launches {counts['K2']}; vs K1 max abs err {err:.3g} (tol {SHARDED_ATOL})")
    return launches


# phase_graphs: each captured mesh path against its eager run on 2x2 of
# the card: (path, grid side, dtypes); under the mixed (bench_4096's) and
# torus BCs, at each chunk length.
GRAPH_PATHS = (
    ("slab", BENCH_GRID, ("float32", "bfloat16", "float64")),
    ("overlap", BENCH_GRID, ("float32",)),
    ("per-step K2", BENCH_GRID, ("float32",)),
    ("carrier", CARRIER_GRID, ("float32", "bfloat16", "float64")),
)
GRAPH_BCS = ("mixed", "torus")
GRAPH_CHUNKS = (1, 7, 100, 256)
GRAPH_TIMED_CHUNK = 100


def graph_case(torch, path, n, bc, device):
    """(advance, mesh) of a phase_graphs path on 2x2 of the card at n² with
    the ``bc`` class, the kernel named."""
    import dataclasses

    from climate_sim_tpu_torch.config import BCConfig, BCType
    from climate_sim_tpu_torch.ops.step import make_interior_step
    from climate_sim_tpu_torch.parallel import halo
    from climate_sim_tpu_torch.parallel.mesh import make_mesh

    cfg, dt = bench_config(n)
    cfg = dataclasses.replace(cfg, dt=dt)
    if bc == "torus":
        cfg.bc = BCConfig(*(BCType.PERIODIC,) * 4)
    mesh = make_mesh(2, 2, [device] * 4)
    adv = {"slab": halo.build_sharded_multistep_advance,
           "overlap": halo.build_sharded_overlap_advance,
           "carrier": halo.build_carrier_slab_advance,
           "per-step K2": lambda c, m, d: halo.build_sharded_advance(
               c, m, d, make_interior_step(c, d))}[path](cfg, mesh, dt)
    if adv is None or adv.eager_why is not None:
        fail(f"graphs: {path} {bc} at {n}² on 2x2 of the card is not captured"
             f" ({adv and adv.eager_why})")
    return adv, mesh


def case_tiles(torch, adv, mesh, n, dtype, seed, device):
    """The tiles (carrier tiles on the carrier path) of an edge-parked
    field made on the card from ``seed``."""
    from climate_sim_tpu_torch.parallel.mesh import shard_field

    u = edge_parked(torch, n, n, seed, device).to(getattr(torch, dtype))
    return adv.embed(u) if hasattr(adv, "embed") else shard_field(u, mesh)


def chunk_ms(torch, device, fn, trials=3):
    """Best ms of ``trials`` calls of ``fn()``, each alone between CUDA
    events on an idle card (the host's enqueue included)."""
    best = float("inf")
    for _ in range(trials):
        torch.cuda.synchronize(device)
        start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        stop.record()
        torch.cuda.synchronize(device)
        best = min(best, start.elapsed_time(stop))
    return best


def same_tiles(torch, label, got, want):
    """Fail unless the tiles ``got`` equal ``want`` bit for bit."""
    for y, (grow, wrow) in enumerate(zip(got, want)):
        for x, (g, w) in enumerate(zip(grow, wrow)):
            if not torch.equal(g, w):
                err = float((g.double() - w.double()).abs().max())
                fail(f"graphs: {label}: tile ({y}, {x}) differs from the"
                     f" eager chunk's (max abs err {err:.3g})")


def traced_kernels(torch, devices, run, trace_path, key=lambda ev: ev["name"]):
    """Kernel events in a ``torch.profiler`` trace of one ``run()``, counted
    by ``key(event)`` (the kernel's name unless named), after one more
    ``run()`` in the profiler's warm-up step (which traces and drops its
    events, so none of the traced step's is lost to the tracer's start);
    each run is followed by a synchronize of every card of ``devices``."""
    import collections

    from torch.profiler import ProfilerActivity, profile, schedule

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=lambda prof: prof.export_chrome_trace(trace_path)) as prof:
        for _ in range(2):
            run()
            for d in devices:
                torch.cuda.synchronize(d)
            prof.step()
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    return collections.Counter(key(ev) for ev in events if ev.get("cat") == "kernel")


def phase_graphs(torch, device):
    """Each captured mesh path against its eager run (``disable_graphs()``)
    on 2x2 of the card: slab, overlap and per-step (K2) at 4096², the
    carrier (K5) at 4001²; f32 on every path, bf16 and f64 on slab and
    carrier; the mixed and torus BCs; chunks of 1, 7, 100 and 256 steps,
    one advance per dtype, so its chunks share one pool.  Each case: the
    replayed tiles bit-identical to the eager chunk's, and one replay's
    launches and ``mesh.copies`` equal to the eager chunk's; the capture
    (which raises unless the graph's stencil kernel nodes equal the
    launches its wrappers counted) takes its seconds and adds memory
    (static input and pool, from ``memory_reserved``), printed.  Once an
    advance holds all four lengths, each is replayed again in the reverse
    order and must give the same tiles.  On each path's f32 mixed 100-step
    chunk, a ``torch.profiler`` trace of one replay must hold as many
    stencil kernel events as the replay counted launches.  Then eager and
    graphed 100-step chunks in f32 (mixed BCs) in turns, best of 3 each,
    with the bare replay (no copy in or out) beside them.  Returns
    {path: {"eager": ms, "graphed": ms, "replay": ms}}."""
    import collections

    from climate_sim_tpu_torch.parallel.halo import CHUNK_KERNEL
    from climate_sim_tpu_torch.runtime import graphs

    t0 = time.perf_counter()
    cases, traced = 0, {}
    trace_dir = tempfile.mkdtemp(prefix="chip_smoke_graph_trace_")
    for path, n, dtypes in GRAPH_PATHS:
        for bc in GRAPH_BCS:
            for di, dtype in enumerate(dtypes):
                adv, mesh = graph_case(torch, path, n, bc, device)
                tiles = case_tiles(torch, adv, mesh, n, dtype, 40 + di, device)
                field = sum(t.numel() * t.element_size() for row in tiles for t in row)
                wants = {}
                for chunk in GRAPH_CHUNKS:
                    label = f"{path} {bc} {n}² {dtype} chunk={chunk}"
                    reset_counts()
                    copies0 = collections.Counter(mesh.copies)
                    with graphs.disable_graphs():
                        want = wants[chunk] = adv(chunk)(tiles)
                    torch.cuda.synchronize(device)
                    eager_counts = read_counts()
                    eager_copies = mesh.copies - copies0
                    fn = adv(chunk)
                    torch.cuda.empty_cache()
                    held0 = torch.cuda.memory_reserved(device)
                    t_cap = time.perf_counter()
                    nodes = fn.capture(tiles).kernel_nodes
                    torch.cuda.synchronize(device)
                    cap_s = time.perf_counter() - t_cap
                    held = torch.cuda.memory_reserved(device) - held0
                    reset_counts()
                    copies0 = collections.Counter(mesh.copies)
                    got = fn(tiles)
                    torch.cuda.synchronize(device)
                    got_counts, got_copies = read_counts(), mesh.copies - copies0
                    if got_counts != eager_counts or got_copies != eager_copies:
                        fail(f"graphs: {label}: a replay counted {got_counts},"
                             f" {dict(got_copies)}; the eager chunk {eager_counts},"
                             f" {dict(eager_copies)}")
                    same_tiles(torch, label, got, want)
                    cases += 1
                    launched = {k: v for k, v in got_counts.items() if v}
                    stencil_nodes = sum(v for (k, _), v in nodes.items() if CHUNK_KERNEL in k)
                    trace = ""
                    if bc == "mixed" and di == 0 and chunk == GRAPH_TIMED_CHUNK:
                        events = traced_kernels(torch, [device], lambda: fn(tiles),
                                                os.path.join(trace_dir, "trace.json"))
                        seen = sum(v for k, v in events.items() if CHUNK_KERNEL in k)
                        if seen != sum(got_counts.values()):
                            fail(f"graphs: {label}: a traced replay ran {seen} {CHUNK_KERNEL}"
                                 f" kernels; the replay counted {launched}")
                        traced[path] = seen
                        trace = f"; a traced replay ran {seen} {CHUNK_KERNEL} kernels"
                    print(f"[graphs] {label}: bit-identical to eager; per replay"
                          f" {launched} launches ({stencil_nodes} {CHUNK_KERNEL} nodes in"
                          f" the graph{trace}), {sum(got_copies.values())} copies;"
                          f" capture {cap_s:.3f} s, adds {held / 2**20:.0f} MiB"
                          f" = {held / field:.2f} fields (static input 1.00)")
                    del want, got, fn
                for chunk in reversed(GRAPH_CHUNKS):
                    same_tiles(torch, f"{path} {bc} {n}² {dtype} chunk={chunk} replayed"
                               f" after the longer chunks", adv(chunk)(tiles), wants[chunk])
                del adv, wants, tiles
                torch.cuda.empty_cache()
    shutil.rmtree(trace_dir, ignore_errors=True)
    print(f"[graphs] {cases} cases bit-identical to their eager runs, and again replayed in"
          f" the reverse order, in {time.perf_counter() - t0:.1f} s; traced replays ran"
          f" the counted launches: {traced}")

    ms = {}
    for path, n, _ in GRAPH_PATHS:
        adv, mesh = graph_case(torch, path, n, "mixed", device)
        tiles = case_tiles(torch, adv, mesh, n, "float32", 50, device)
        fn = adv(GRAPH_TIMED_CHUNK)
        graph = fn.capture(tiles).graph

        def eager():
            with graphs.disable_graphs():
                adv(GRAPH_TIMED_CHUNK)(tiles)

        runs = {"eager": eager, "graphed": lambda: fn(tiles),
                "replay": lambda: graphs.CUDA_GRAPHS.replay(graph)}
        turns = {name: [] for name in runs}
        eager()
        for name in ("eager", "graphed", "replay", "replay", "graphed", "eager"):
            turns[name].append(chunk_ms(torch, device, runs[name]))
        ms[path] = {name: min(v) for name, v in turns.items()}
        pts = n * n * GRAPH_TIMED_CHUNK
        print(f"[graphs] {path} {n}² f32 on 2x2 of one card, {GRAPH_TIMED_CHUNK}-step chunk,"
              f" best of 3 in turns: " + "; ".join(
                  f"{name} {' / '.join(f'{t:.3f}' for t in v)} ms"
                  f" ({pts / (min(v) * 1e6):.1f} Gpoint/s)" for name, v in turns.items())
              + f"; graphed/eager {ms[path]['eager'] / ms[path]['graphed']:.2f}x;"
              f" copy in and out {ms[path]['graphed'] - ms[path]['replay']:.3f} ms"
              f" ({1 - ms[path]['replay'] / ms[path]['graphed']:.1%} of the graphed chunk)")
        del adv, fn, graph, tiles
        torch.cuda.empty_cache()
    return ms


def phase_eager_files(torch, device, tmp, files):
    """Phase 7's bench_4096 slab run and its 4001² carrier run again under
    ``disable_graphs()``: the banner says eager, and each file is
    byte-identical to the graphed run's (``files[label]``)."""
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.runtime import driver, graphs

    for label, cfg_path, extra in (("bench_4096_2x2_slab", BENCH_CFG, BENCH_STEPS),
                                   CARRIER_RUNS[0][:3]):
        args = [*extra, "--mesh.x=2", "--mesh.y=2", "--kernel=pallas", "--write_final=true",
                f"--output.dir={os.path.join(tmp, label + '_eager')}"]
        cfg = merged_config(cfg_path, args)
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf), graphs.disable_graphs():
            driver.run_simulation(cfg, [device] * 4)
        out = buf.getvalue()
        if "eager chunks (graphs disabled)" not in out:
            fail(f"{label} under disable_graphs(): the banner does not say eager")
        same_file(f"{label} eager", cfg.resolved_output_path(), files[label])
        rate = re.search(r"^throughput: (.*)$", out, re.M).group(1)
        print(f"[graphs] {label} under disable_graphs(): file byte-identical to the"
              f" graphed run's; eager throughput: {rate}")


# A rank of a multi-process run: the port's CLI (one tile, the rank's own
# card), or run_simulation on ``tiles`` tiles of that card, with its chunks
# eager under disable_graphs() when the sixth argument says "eager"; prints
# the rank's launch counts, which start at 0 in the fresh process.
RANK_WORKER = """
import contextlib, json, sys
rank, port, nproc, tiles = (int(a) for a in sys.argv[1:5])
sys.path.insert(0, {here!r})
import chip_smoke
from climate_sim_tpu_torch.runtime import graphs
argv = ["--distributed=127.0.0.1:%d,%d,%d" % (port, nproc, rank), *sys.argv[6:]]
chip_smoke.reset_counts()
eager = graphs.disable_graphs() if sys.argv[5] == "eager" else contextlib.nullcontext()
with eager:
    rc = chip_smoke.rank_main(argv, tiles, rank)
print("RANK_COUNTS " + json.dumps(chip_smoke.read_counts()), flush=True)
sys.exit(rc)
""".format(here=HERE)


def rank_main(argv, tiles, rank):
    """RANK_WORKER's run: the CLI on one tile, else run_simulation on
    ``tiles`` tiles of the rank's card; its exit code."""
    from climate_sim_tpu_torch.runtime import cli, distributed, driver

    if tiles == 1:
        return cli.main(argv)
    import torch

    from climate_sim_tpu_torch.config import extract_config_path, merged_config

    dev = torch.device("cuda", rank % torch.cuda.device_count())
    torch.cuda.set_device(dev)
    driver.run_simulation(merged_config(extract_config_path(argv), argv), [dev] * tiles)
    distributed.shutdown()
    return 0


RANK_TIMEOUT_S = 300
# The multi-process runs: (label, config, overrides, ranks, tiles per rank,
# kernel).  Their overrides are those of phase 7's run of the same config
# (phase_sharded_run), so the files are held to phase 7's, byte for byte.
MP_RUNS = (
    ("bench_4096_4_ranks_slab", BENCH_CFG, BENCH_STEPS, 4, 1, "K4"),
    (f"bench_{CARRIER_GRID}_4_ranks_carrier", BENCH_CFG,
     [*BENCH_STEPS, f"--nx={CARRIER_GRID}", f"--ny={CARRIER_GRID}"], 4, 1, "K5"),
    ("bench_4096_2_ranks_x_2_tiles_overlap", BENCH_CFG, [*BENCH_STEPS, "--halo_overlap=true"],
     2, 2, "K3"),
)
RESTART_STEPS = ["--steps=200", "--out_every=100"]
# The runs one rank per card over NCCL (four cards): (label, config,
# overrides, kernel launched, per-step).  MP_RUNS' slab, carrier and
# overlap runs as 4 ranks x 1 tile; bench_4096 on the per-step path with
# torch ops (no kernel); and K2 on the remainder tiles of a grid the
# carrier cannot stage (three torus rows on two tiles, as in
# tests/test_torch_multiprocess.py, 2^20 columns a tile).
REMAINDER_GRID = (1 << 21, 3)  # (nx, ny)
NCCL_RUNS = (
    *((label.replace("2_ranks_x_2_tiles", "4_ranks"), cfg_path, extra, kernel, False)
      for label, cfg_path, extra, _, _, kernel in MP_RUNS),
    ("bench_4096_perstep_torch_ops", BENCH_CFG,
     ["--steps=100", "--out_every=50", "--kernel=jnp"], None, True),
    (f"bench_{REMAINDER_GRID[0]}x{REMAINDER_GRID[1]}_remainder_perstep", BENCH_CFG,
     [*BENCH_STEPS, f"--nx={REMAINDER_GRID[0]}", f"--ny={REMAINDER_GRID[1]}"], "K2", True),
)


# The NCCL runs also timed eager against captured, in turns.
NCCL_EAGER_TURNS = ("bench_4096_4_ranks_slab", f"bench_{CARRIER_GRID}_4_ranks_carrier",
                    "bench_4096_perstep_torch_ops")


def free_port():
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def one_card_env():
    """The environment that shows the ranks only this process's first
    card, so that they share it."""
    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    return {"CUDA_VISIBLE_DEVICES": visible.split(",")[0] if visible else "0"}


def run_ranks(nproc, tiles, args, env=None, timeout=RANK_TIMEOUT_S, eager=False):
    """``nproc`` ranks of RANK_WORKER on 127.0.0.1, all started together,
    with ``env`` added to this process's environment (their chunks eager
    with ``eager``); returns [(exit code, stdout, stderr, launch counts)].
    Every rank is killed if the group outlasts ``timeout``."""
    port = free_port()
    procs = [subprocess.Popen([sys.executable, "-c", RANK_WORKER, str(i), str(port),
                               str(nproc), str(tiles), "eager" if eager else "graphs",
                               *args], cwd=HERE,
                              env={**os.environ, **(env or {})},
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(nproc)]
    deadline = time.monotonic() + timeout
    results = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            m = re.search(r"^RANK_COUNTS (.*)$", out, re.M)
            results.append((p.returncode, out, err, json.loads(m.group(1)) if m else None))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return results


def check_ranks(label, results, transport):
    """Every rank exited 0 with its counts; only rank 0 logged (banner,
    transport, timing); no rank fell back from the native writer.  Returns
    rank 0's stdout and the launch counts summed over the ranks."""
    for r, (rc, out, err, counts) in enumerate(results):
        if rc != 0 or counts is None:
            fail(f"{label}: rank {r} exit code {rc}:\n{out[-2000:]}\n{err[-3000:]}")
        if "native snapshot writer unavailable" in err:
            fail(f"{label}: rank {r} fell back to the Python codec: {err[-1000:]}")
        logged = [ln for ln in out.splitlines() if not ln.startswith("RANK_COUNTS ")]
        if r and logged:
            fail(f"{label}: rank {r} logged {logged[:3]}")
    out0 = results[0][1]
    for want in ("climate-sim-tpu", f"transport: {transport}", "timing: total_max="):
        if want not in out0:
            fail(f"{label}: rank 0 did not log {want!r}")
    totals = {n: sum(res[3][n] for res in results) for n in KERNEL_NAMES}
    return out0, totals


def same_file(label, got, want):
    import filecmp

    if not filecmp.cmp(got, want, shallow=False):
        fail(f"{label}: {got} is not byte-identical to {want}")


GLOO = "gloo (host-staged; ranks share a card)"


def mp_run(tmp, label, cfg_path, args, nproc, tiles, kernel, transport, want_file,
           per_step=False, eager=False):
    """One multi-process run on a 2x2 mesh, checked; gloo runs share the
    first card.  ``kernel`` is the one kernel launched (None: torch ops
    only), 5 times a tile and pass for K3, once for the others, and once a
    tile and step on a per-step path.  Gloo ranks run eager chunks by the
    capture rule, NCCL ranks captured ones unless ``eager`` (under
    ``disable_graphs()``); the banner must say which.  Returns (the run's
    file, the launch counts summed over the ranks, its throughput line)."""
    from climate_sim_tpu_torch.config import merged_config

    px, py = 2, 2
    full = [f"--config={cfg_path}", "--kernel=pallas", *args, f"--mesh.x={px}",
            f"--mesh.y={py}", f"--output.dir={os.path.join(tmp, label)}", "--write_final=true"]
    cfg = merged_config(cfg_path, full)
    t0 = time.perf_counter()
    results = run_ranks(nproc, tiles, full, one_card_env() if transport == GLOO else None,
                        eager=eager)
    wall = time.perf_counter() - t0
    out0, counts = check_ranks(label, results, transport)
    chunks = ("eager chunks (gloo transport, host-staged)" if transport == GLOO else
              "eager chunks (graphs disabled)" if eager else "chunks as CUDA graphs")
    if chunks not in out0:
        fail(f"{label}: rank 0's banner does not say {chunks!r}")
    m = re.search(r"^passes: timed=(\d+) warmup=(\d+)$", out0, re.M)
    expect, want = schedule_counts(cfg, kernel, per_step, int(m.group(2)), px, py)
    per_pass = 5 if kernel == "K3" else 1
    if int(m.group(1)) != expect or counts != want:
        fail(f"{label}: launches over the ranks {counts} != {want}")
    same_file(label, cfg.resolved_output_path(), want_file)
    rate = re.search(r"^throughput: (.*)$", out0, re.M).group(1)
    timing = re.search(r"^timing: (.*)$", out0, re.M).group(1)
    unit = "steps" if per_step else "passes"
    what = (f"{kernel} launches {counts[kernel]} = {per_pass} x ({expect} timed +"
            f" {m.group(2)} warm-up {unit}) x {px * py} tiles" if kernel
            else f"no kernel launched ({expect} timed steps of torch ops)")
    print(f"[multiprocess:{label}] {nproc} ranks x {tiles} tile(s), transport {transport},"
          f" {chunks}:"
          f" exit 0 on every rank, {what}; file byte-identical to the single-process mesh"
          f" run; timing: {timing}; throughput: {rate}; {wall:.1f} s with process start")
    return cfg.resolved_output_path(), counts, rate


def phase_multiprocess(torch, device, tmp, refs):
    """The multi-process driver through ``--distributed=127.0.0.1:PORT,N,I``
    on the card: bench_4096 on 4 ranks (slab, K4), the carrier at 4001² on
    4 ranks (K5), 2 ranks x [cuda:0, cuda:0] with halo_overlap (K3), each
    with output on, and a 4-rank restart from the slab run's file.  Ranks
    on one card exchange over gloo through pinned host buffers.  Each run:
    exit 0 on every rank, the banner and timing on rank 0 only, no writer
    fallback, launches summed over the ranks equal to the pass schedule
    times the tiles (every other kernel 0), and a snapshot file
    byte-identical to the single-process mesh run of the same config
    (``refs[label]``, phase 7's; or the restart's, made here).  Returns the
    launch counts and the throughput lines."""
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.runtime import driver

    launches = {n: 0 for n in KERNEL_NAMES}
    rates = {}

    def run(label, cfg_path, args, nproc, tiles, kernel, want_file):
        path, counts, rates[label] = mp_run(tmp, label, cfg_path, args, nproc, tiles, kernel,
                                            GLOO, want_file)
        launches[kernel] += counts[kernel]
        return path

    slab_file = None
    for label, cfg_path, extra, nproc, tiles, kernel in MP_RUNS:
        ref = refs.get(label)
        if ref is None:
            raise SystemExit(f"chip_smoke: no single-process reference for {label}")
        path = run(label, cfg_path, extra, nproc, tiles, kernel, ref)
        slab_file = slab_file or path

    # The restart: 4 ranks read their regions of the slab run's last record.
    restart = [*MP_RUNS[0][2], *RESTART_STEPS, "--ic.mode=file", f"--ic.path={slab_file}"]
    ref_args = [*restart, "--mesh.x=2", "--mesh.y=2", "--kernel=pallas", "--write_final=true",
                f"--output.dir={os.path.join(tmp, 'restart_single')}"]
    ref_cfg = merged_config(BENCH_CFG, ref_args)
    with contextlib.redirect_stdout(io.StringIO()):
        driver.run_simulation(ref_cfg, [device] * 4)
    run("bench_4096_4_ranks_restart", BENCH_CFG, restart, 4, 1, "K4",
        ref_cfg.resolved_output_path())
    return launches, rates


def cards_replay_trace(torch, label, cfg, cards, tmp):
    """The GRAPH_TIMED_CHUNK-step chunk that ``cfg``'s run over ``cards``
    captures (one graph spanning the cards): one replay's launches, held to
    the stencil kernel events of a traced replay, which must lie on every
    card, as the graph's stencil kernel nodes must.  Prints the capture's
    seconds and the memory it added on each card."""
    from climate_sim_tpu_torch.parallel.halo import CHUNK_KERNEL
    from climate_sim_tpu_torch.runtime import driver, graphs

    with contextlib.redirect_stdout(io.StringIO()):
        u, adv, mesh, _, _ = driver.prepare(cfg, cards)
    distinct = mesh.distinct_devices()
    fn = adv(GRAPH_TIMED_CHUNK)
    if not isinstance(fn, graphs.GraphedChunk):
        fail(f"{label}: the {GRAPH_TIMED_CHUNK}-step chunk over {distinct} is not captured"
             f" ({adv.eager_why})")
    done = fn.capture(u)
    node_cards = {card for name, card in done.kernel_nodes if CHUNK_KERNEL in name}
    reset_counts()
    fn(u)
    for d in distinct:
        torch.cuda.synchronize(d)
    launched = sum(read_counts().values())
    events = traced_kernels(torch, distinct, lambda: fn(u),
                            os.path.join(tmp, f"{label}_trace.json"),
                            key=lambda ev: (ev["name"], ev.get("args", {}).get("device")))
    seen = {}
    for (name, dev), n in events.items():
        if CHUNK_KERNEL in name:
            seen[dev] = seen.get(dev, 0) + n
    on_every = sorted(seen) == sorted(d.index for d in distinct)
    if sum(seen.values()) != launched or (launched and not on_every) or \
            (launched and node_cards != set(distinct)):
        fail(f"{label}: a traced replay ran {CHUNK_KERNEL} kernels {seen} by card, the graph's"
             f" nodes lie on {sorted(map(str, node_cards))}; one replay counted {launched}"
             f" launches over {distinct}")
    added = ", ".join(f"{d} {n / 2**20:+.0f} MiB" for d, n in done.memory.items())
    print(f"[multiprocess:{label}] the {GRAPH_TIMED_CHUNK}-step chunk as one graph over"
          f" {len(distinct)} cards: a traced replay ran {launched} {CHUNK_KERNEL} kernels"
          f" ({seen} by card), as counted; capture {done.seconds:.3f} s, memory added {added}")


def phase_nccl(torch, tmp):
    """One process's tiles over several cards, and one rank per card over
    NCCL.  With two or more cards, each of NCCL_RUNS runs as one process
    over a 2x2 mesh of the cards (cuda:0-3 with four) in turns graphed,
    eager (``disable_graphs()``), eager, graphed: the graphed runs' banners
    say ``chunks as CUDA graphs`` (one graph spanning the cards), the eager
    runs' ``eager chunks (graphs disabled)``, and every file is
    byte-identical to the first's; then one traced replay of the path's
    100-step chunk (:func:`cards_replay_trace`).  With four or more cards,
    each also runs one rank per card over NCCL, held to the first
    single-process file byte for byte, with the checks of :func:`mp_run`;
    the ranks replay captured chunks.  The runs named in NCCL_EAGER_TURNS
    then run eager (``disable_graphs()`` in each rank) and captured again,
    in turns, each file byte-identical too.  Every run's launches equal
    its pass schedule times the tiles.  With fewer cards, a line that the
    phase needs them.  Returns the launch counts of the first, captured
    single-process run of each and of its NCCL ranks, and the throughput
    lines."""
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.runtime import driver, graphs

    launches = {n: 0 for n in KERNEL_NAMES}
    rates = {}
    n_cards = torch.cuda.device_count()
    if n_cards < 2:
        print(f"[multiprocess] {n_cards} card(s): one process over several cards needs 2,"
              f" the one-rank-per-card NCCL runs 4")
        return launches, rates
    cards = [torch.device("cuda", i % n_cards) for i in range(4)]
    for label, cfg_path, extra, kernel, per_step in NCCL_RUNS:
        one = f"{label}_{min(n_cards, 4)}_cards_single_process"
        turns = {"graphed": [], "eager": []}
        first = None
        for turn, eager in enumerate((False, True, True, False)):
            args = ["--kernel=pallas", *extra, "--mesh.x=2", "--mesh.y=2",
                    "--write_final=true", f"--output.dir={os.path.join(tmp, f'{one}_{turn}')}"]
            cfg = merged_config(cfg_path, args)
            buf = io.StringIO()
            reset_counts()
            with contextlib.redirect_stdout(buf), \
                    (graphs.disable_graphs() if eager else contextlib.nullcontext()):
                driver.run_simulation(cfg, cards)
            out = buf.getvalue()
            chunks = "eager chunks (graphs disabled)" if eager else "chunks as CUDA graphs"
            path = re.search(r"  path: (.*)$", out, re.M).group(1)
            if not path.endswith(chunks):
                fail(f"{one} turn {turn}: the banner's path is {path!r}, not {chunks!r}")
            m = re.search(r"^passes: timed=(\d+) warmup=(\d+)$", out, re.M)
            expect, want = schedule_counts(cfg, kernel, per_step, int(m.group(2)))
            if int(m.group(1)) != expect or read_counts() != want:
                fail(f"{one} turn {turn}: launches {read_counts()} != {want}")
            captures = re.findall(r"^  graph: (.*)$", out, re.M)
            if eager == bool(captures):
                fail(f"{one} turn {turn}: graph lines {captures} for {chunks}")
            if first is None:
                first = cfg.resolved_output_path()
                if kernel:
                    launches[kernel] += want[kernel]
                print(f"[multiprocess:{one}] path: {path}; launches {want} (the pass"
                      f" schedule); " + "; ".join(captures))
            else:
                same_file(f"{one} turn {turn}", cfg.resolved_output_path(), first)
            turns["eager" if eager else "graphed"].append(
                re.search(r"^throughput: (.*)$", out, re.M).group(1))
        rates[one], rates[f"{one}_eager"] = turns["graphed"], turns["eager"]
        print(f"[multiprocess:{one}] in turns (graphed, eager, eager, graphed), every file"
              f" byte-identical to the first: graphed {turns['graphed']}; eager {turns['eager']}")
        cards_replay_trace(torch, one, merged_config(cfg_path, ["--kernel=pallas", *extra,
                                                                "--mesh.x=2", "--mesh.y=2"]),
                           cards, tmp)
        if n_cards < 4:
            continue
        _, counts, rates[f"{label}_nccl"] = mp_run(
            tmp, f"{label}_nccl", cfg_path, extra, 4, 1, kernel, "nccl", first, per_step)
        if kernel:
            launches[kernel] += counts[kernel]
        if label not in NCCL_EAGER_TURNS:
            continue
        turns = {"graphed": [rates[f"{label}_nccl"]], "eager": []}
        for eager in (True, True, False):
            name = "eager" if eager else "graphed"
            _, _, rate = mp_run(tmp, f"{label}_nccl_{name}", cfg_path, extra, 4, 1, kernel,
                                "nccl", first, per_step, eager)
            turns[name].append(rate)
        rates[f"{label}_nccl_eager"] = turns["eager"]
        print(f"[multiprocess:{label}_nccl] in turns (graphed, eager, eager, graphed):"
              f" graphed {turns['graphed']}; eager {turns['eager']}")
    if n_cards < 4:
        print(f"[multiprocess] {n_cards} cards: the one-rank-per-card NCCL runs need 4")
    return launches, rates


TOOLS_IC_STEPS = 200
TOOLS_TIMEOUT_S = 600
# The file IC is the f64 Gaussian the preset computes in f32 on the card;
# the two f32 fields differ by a few f32 ulps of values <= 1, and diffusion
# does not grow that.
TOOLS_IC_ATOL = 1e-6


def load_script(name):
    """A script of ``scripts/`` as a module (its ``main`` then runs in this
    process, where the launch counters are readable)."""
    import importlib.util

    spec = importlib.util.spec_from_file_location(name, os.path.join(HERE, "scripts", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def captured(fn, *args):
    """``fn(*args)`` with its stdout captured; returns (result, stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = fn(*args)
    return rc, buf.getvalue()


def run_tool(args, timeout=TOOLS_TIMEOUT_S, env=None):
    """A script as its own process group, with ``env`` added to this
    process's environment, killed whole if it outlasts ``timeout`` (the
    scaling harness starts ranks of its own)."""
    p = subprocess.Popen([sys.executable, *args], cwd=HERE, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True, start_new_session=True,
                         env={**os.environ, **(env or {})})
    try:
        out, err = p.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(p.pid, 9)
        p.communicate()
        fail(f"{' '.join(args)} outlasted {timeout} s")
    return p.returncode, out, err


def phase_tools(torch, device, tmp):
    """The port's tools on the card, each through its own entry point:
    ``torch_generate_ic`` at 4096² and a file-IC run through the CLI, held
    to the preset run; ``torch_hw_conformance`` at its defaults (every path
    x BC class against the f64 oracle); ``torch_run_benchmark`` on the
    ``cuda`` platform (4096², one card) and the ``multiproc`` platform
    (strong 1/2/4 ranks at 1024², weak 1/4 ranks of 512² tiles); then
    ``torch_hw_rates``.  Returns
    the launch counts of the runs made in this process (the harness's
    ranks are processes of their own, uncounted)."""
    import numpy as np

    from climate_sim_tpu_torch.io.netcdf import NetCDFFile
    from climate_sim_tpu_torch.runtime.cli import main as cli_main

    t0 = time.perf_counter()
    reset_counts()
    ic_path = os.path.join(tmp, "tools_ic", "ic_global.nc")
    rc, out = captured(load_script("torch_generate_ic").main,
                       [f"--nx={BENCH_GRID}", f"--ny={BENCH_GRID}", f"--out={ic_path}"])
    if rc != 0:
        fail(f"torch_generate_ic exit code {rc}")
    print(f"[tools] {out.strip()}")
    finals = {}
    for label, extra in (("preset", []), ("file IC", ["--ic.mode=file", f"--ic.path={ic_path}"])):
        args = [f"--config={BENCH_CFG}", f"--nx={BENCH_GRID}", f"--ny={BENCH_GRID}",
                f"--steps={TOOLS_IC_STEPS}",
                f"--out_every={TOOLS_IC_STEPS}", "--write_final=true",
                f"--output.dir={os.path.join(tmp, 'tools_' + label.replace(' ', '_'))}", *extra]
        rc, out = captured(cli_main, args)
        if rc != 0:
            fail(f"tools: the {label} run through the CLI exited {rc}")
        m = re.search(r"^throughput: (.*)$", out, re.M)
        with NetCDFFile(os.path.join(tmp, "tools_" + label.replace(" ", "_"), "snapshots.nc")) as ds:
            finals[label] = ds.variables["u"][-1, :, :]
        print(f"[tools] {label} run, {BENCH_GRID}², {TOOLS_IC_STEPS} steps through the CLI:"
              f" throughput {m.group(1)}")
    err = float(np.abs(finals["file IC"] - finals["preset"]).max())
    if not np.isfinite(finals["file IC"]).all() or err > TOOLS_IC_ATOL:
        fail(f"tools: the file-IC run vs the preset run: max abs err {err:.3g} > {TOOLS_IC_ATOL}")
    print(f"[tools] file-IC run vs preset run, final field: max abs err {err:.3g}"
          f" (tol {TOOLS_IC_ATOL})")

    rc, out = captured(load_script("torch_hw_conformance").main, [])
    m = re.search(r"^hw_conformance: (\d+) cases: (.*)$", out, re.M)
    rows = [ln.split() for ln in out.splitlines() if ln.startswith(("ok ", "FAIL "))]
    by_path = {}
    for row in rows:
        by_path[row[2]] = by_path.get(row[2], 0) + 1
    for row in rows:
        if row[0] == "FAIL":
            print(f"[tools] conformance FAIL {' '.join(row[1:])}")
    if rc != 0 or m is None or m.group(2) != "ALL OK" or int(m.group(1)) != len(rows):
        fail(f"torch_hw_conformance exit code {rc}: {m.group(0) if m else 'no summary line'}")
    worst = max(float(row[3].split("=")[1]) for row in rows)
    print(f"[tools] {m.group(0)} (rows by path: {by_path}; largest rel_err {worst:.3g})")

    for label, args in (
        ("cuda", ["--platform=cuda", "--strong-ranks", "1", "--strong-nx", str(BENCH_GRID),
                  "--strong-ny", str(BENCH_GRID), "--skip-weak"]),
        ("multiproc", ["--platform=multiproc", "--strong-ranks", "1", "2", "4",
                       "--strong-nx", "1024", "--strong-ny", "1024", "--weak-ranks", "1", "4",
                       "--weak-tile-nx", "512", "--weak-tile-ny", "512"]),
    ):
        out_dir = os.path.join(tmp, f"bench_torch_{label}")
        rc, out, err = run_tool([os.path.join("scripts", "torch_run_benchmark.py"), *args,
                                 "--steps", "200", f"--out-dir={out_dir}",
                                 f"--config={BENCH_CFG}"])
        if rc != 0:
            fail(f"torch_run_benchmark --platform={label} exit code {rc}:\n{out[-2000:]}\n"
                 f"{err[-3000:]}")
        names = sorted(os.listdir(out_dir))
        want = 2 if label == "cuda" else 3
        if len(names) != want:
            fail(f"torch_run_benchmark --platform={label} wrote {names}")
        for name in names:
            with open(os.path.join(out_dir, name)) as f:
                for line in f:
                    if not line.startswith("#"):
                        kind = re.sub(r"_\d{8}_\d{6}\.csv$", "", name)
                        print(f"[tools] {kind}: {line.rstrip()}")

    rc, out = captured(load_script("torch_hw_rates").main, [])
    for line in out.strip().splitlines():
        print(f"[tools] hw_rates {line}")
    if rc != 0:
        fail(f"torch_hw_rates exit code {rc}")
    counts = read_counts()
    print(f"[tools] launches in this process: {counts}; {time.perf_counter() - t0:.1f} s")
    return counts


STUDY_ROWS = 12  # the bf16 study's 4 BC classes x 3 horizons
# The field comparisons each path bench prints at its defaults: slab,
# overlap and perstep beside single; the carrier beside K1 at 2 sizes.
STUDY_DIFFS = {"torch_sharded_path_bench": 3, "torch_carrier_bench": 2}


def phase_study(torch, device, tmp):
    """The port's study tools on the card, each through its entry point at
    its defaults: ``torch_bf16_study`` (bf16 against f32 from one bf16 IC,
    4 BC classes x 3 horizons at 1024², then f32 and bf16 throughput at
    4096², all through K1); ``torch_sharded_path_bench`` (single, slab,
    overlap and perstep on a 1x1 mesh of the card at 4096²) and
    ``torch_carrier_bench --single`` (the carrier and K1 at 4000² and
    5000²), each path's field after one chunk within SHARDED_ATOL of
    K1's; then bench_4096 through the driver, 1000 steps with output on,
    read back through ``climate_sim_tpu_torch.visualization`` (numpy
    only): frame 0 the IC and the last frame the run's own field, bit for
    bit.  Returns the launch counts of the phase, apart from the paths'."""
    import numpy as np

    from climate_sim_tpu_torch import visualization as vis
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.ops.init import gaussian_hotspot
    from climate_sim_tpu_torch.runtime import driver

    t0 = time.perf_counter()
    reset_counts()
    rc, out = captured(load_script("torch_bf16_study").main, [])
    k1 = read_counts()["K1"]
    for line in out.strip().splitlines():
        print(f"[study] bf16_study {line}")
    rows = [ln.split() for ln in out.splitlines()[2:] if len(ln.split()) == 5]
    perf = re.findall(r"^perf (f32|bf16): (\S+) Gpt/s", out, re.M)
    if (rc != 0 or len(rows) != STUDY_ROWS or [p for p, _ in perf] != ["f32", "bf16"]
            or not all(np.isfinite(float(v)) for row in rows for v in row[2:])):
        fail(f"torch_bf16_study exit code {rc}: {len(rows)} error rows, perf lines {perf}")
    if k1 < 1 or any(n for name, n in read_counts().items() if name != "K1"):
        fail(f"torch_bf16_study launched {read_counts()}, not K1 alone")
    print(f"[study] bf16_study: {len(rows)} error rows, bf16/f32 throughput"
          f" {float(perf[1][1]) / float(perf[0][1]):.3f}; K1 launches {k1}")

    for name, args in (("torch_sharded_path_bench", []),
                       ("torch_carrier_bench", ["--single"])):
        rc, out = captured(load_script(name).main, args)
        for line in out.strip().splitlines():
            print(f"[study] {name.removeprefix('torch_')} {line}")
        diffs = [float(d) for d in re.findall(r"max abs diff (\S+)$", out, re.M)]
        if (rc != 0 or "unavailable" in out or len(diffs) != STUDY_DIFFS[name]
                or not all(d <= SHARDED_ATOL for d in diffs)):
            fail(f"{name} exit code {rc}: field differences {diffs} (tol {SHARDED_ATOL})")

    label = "study_bench_4096"
    args = [*BENCH_STEPS, "--kernel=pallas", "--write_final=true",
            f"--output.dir={os.path.join(tmp, label)}"]
    cfg = merged_config(BENCH_CFG, args)
    with contextlib.redirect_stdout(io.StringIO()):
        res = driver.run_simulation(cfg, device)
    run_dir = os.path.dirname(cfg.resolved_output_path())
    steps = vis.list_available_steps(run_dir)
    meta = vis.load_metadata(run_dir)
    first = vis.load_global(run_dir, steps[0])
    with vis.SnapshotReader(run_dir) as reader:
        last = reader.frame(steps[-1])
    ic = gaussian_hotspot(cfg, torch.float32, device).to(torch.float64).cpu().numpy()
    final = res.u.to(torch.float64).cpu().numpy()
    want_steps = -(-cfg.steps // cfg.out_every) + 1
    if len(steps) != want_steps or not np.array_equal(first, ic) or not np.array_equal(last, final):
        fail(f"{label}: read back through climate_sim_tpu_torch.visualization: {len(steps)}"
             f" frames (want {want_steps}), frame 0 == IC {np.array_equal(first, ic)}, last"
             f" frame == the run's field {np.array_equal(last, final)}")
    print(f"[study] {label}: {len(steps)} frames read back through"
          f" climate_sim_tpu_torch.visualization ({len(meta)} attributes); frame 0 is the"
          f" IC and the last the run's own field, bit for bit")
    counts = read_counts()
    print(f"[study] launches in this phase: {counts}; {time.perf_counter() - t0:.1f} s")
    return counts


# The exchange-latency runs: (ranks, mesh y, tile, --load).  Gloo ranks
# share the first card; with four cards, NCCL ranks one per card.
GLOO_LATENCY_RUNS = ((4, 2, 2048, False), (4, 2, 2048, True))
NCCL_LATENCY_RUNS = ((2, 1, 4096, False), (2, 1, 4096, True),
                     (4, 2, 4096, False), (4, 2, 4096, True))
# scripts/exchange_latency.py's JSON keys, then the port's two.
LATENCY_KEYS = ("ranks", "mesh", "tile", "iters", "load", "raw_s", "iter_cost_coll_s",
                "iter_cost_ctrl_s", "exchange_cost_per_iter_s", "rounds_per_iter",
                "per_round_s", "transport", "batches_per_iter")
LATENCY_TIMEOUT_S = 300
# The injection sweep: a 2x2 mesh of the card at 4096², L in ms.
BOUND_ARGS = ["--device=cuda", "--devices=4", "--tile=2048", "--latencies-ms", "0", "0.5",
              "1", "2", "--passes=12", "--trials=5"]
BOUND_PATHS = ("slab", "overlap", "carrier torus")


def exchange_latency_runs(runs, transport, env=None):
    """``scripts/torch_exchange_latency.py`` for each ``(ranks, mesh y,
    tile, load)`` of ``runs``, each checked: exit 0, one JSON line with
    every key, JAX's ``rounds_per_iter`` (one a mesh axis longer than 1),
    ``transport`` and at least one batch a round.  Returns the lines."""
    results = []
    for ranks, mesh_y, tile, load in runs:
        args = [os.path.join("scripts", "torch_exchange_latency.py"), f"--ranks={ranks}",
                f"--mesh-y={mesh_y}", f"--tile={tile}", *(["--load"] if load else [])]
        rc, out, err = run_tool(args, LATENCY_TIMEOUT_S, env)
        label = " ".join(args[1:])
        lines = out.strip().splitlines()
        if rc != 0 or len(lines) != 1:
            fail(f"torch_exchange_latency {label} exit code {rc}:\n{out[-2000:]}\n{err[-3000:]}")
        res = json.loads(lines[0])
        px, py = ranks // mesh_y, mesh_y
        rounds = (1 if px > 1 else 0) + (1 if py > 1 else 0)
        if (tuple(res) != LATENCY_KEYS or res["rounds_per_iter"] != rounds
                or res["transport"] != transport
                or res["batches_per_iter"] < res["rounds_per_iter"]):
            fail(f"torch_exchange_latency {label}: {res}")
        per_batch_us = res["exchange_cost_per_iter_s"] / res["batches_per_iter"] * 1e6
        print(f"[latency] {label}: {res['transport']}, {res['rounds_per_iter']} rounds and"
              f" {res['batches_per_iter']} batches an iteration, {res['per_round_s'] * 1e6:.2f}"
              f" us a round, {per_batch_us:.2f} us a batch; {json.dumps(res)}")
        results.append(res)
    return results


def phase_latency(torch, device, tmp):
    """The exchange-latency model on the card: ``torch_exchange_latency`` with
    4 ranks sharing the card over gloo (2x2, 2048² tiles, face-only and
    ``--load``), then ``torch_latency_bound`` on a 2x2 mesh of the card at
    4096² with L in {0, 0.5, 1, 2} ms and the model fed the gloo runs'
    latency a batch.  Fails on a missing key, a ``rounds_per_iter`` off
    JAX's formula, a depth that is not 2, or a slope outside [depth - 0.5,
    batches + 1].  Returns the launch counts of the phase (K3, K4 and K5
    of the injection runs), apart from the paths'."""
    t0 = time.perf_counter()
    gloo = exchange_latency_runs(GLOO_LATENCY_RUNS, GLOO, one_card_env())
    lat_us = [r["exchange_cost_per_iter_s"] / r["batches_per_iter"] * 1e6 for r in gloo]
    reset_counts()
    model = [f"{v:.3f}" for v in lat_us if v > 0]
    rc, out = captured(load_script("torch_latency_bound").main,
                       [*BOUND_ARGS, *(["--model-latency-us", *model] if model else [])])
    for line in out.strip().splitlines():
        print(f"[latency] bound {line}")
    if rc != 0:
        fail(f"torch_latency_bound exit code {rc}")
    for path in BOUND_PATHS:
        m = re.search(rf"^{path}: slope dT_pass/dL = (\S+); injected sleeps a pass (\S+);"
                      rf" depth (\d+), batches (\d+)$", out, re.M)
        if m is None:
            fail(f"torch_latency_bound printed no slope for {path}")
        slope, depth, batches = float(m.group(1)), int(m.group(3)), int(m.group(4))
        if depth != 2 or not depth - 0.5 <= slope <= batches + 1:
            fail(f"torch_latency_bound {path}: slope {slope} outside [depth - 0.5, batches"
                 f" + 1] = [{depth - 0.5}, {batches + 1}], or depth {depth} != 2")
    if model and "eff = " not in out:
        fail("torch_latency_bound printed no eff(L) rows")
    counts = read_counts()
    print(f"[latency] launches in this phase: {counts}; {time.perf_counter() - t0:.1f} s")
    return counts


def phase_latency_nccl(torch):
    """With four or more cards, NCCL_LATENCY_RUNS (one rank a card, 2 ranks on
    1x2 and 4 on 2x2, 4096² tiles, face-only and ``--load``); with fewer,
    a line that they need 4."""
    n_cards = torch.cuda.device_count()
    if n_cards < 4:
        print(f"[latency] {n_cards} card(s): the NCCL latency runs need 4")
        return []
    return exchange_latency_runs(NCCL_LATENCY_RUNS, "nccl")


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


def graph_ms(torch, device, fn, reps):
    """Mean ms of ``fn()`` over ``reps`` calls captured in one CUDA graph,
    from CUDA events around a replay after a warm-up replay: the card's
    time for the launches, without the host's Python between them (a
    kernel wrapper takes ~0.04 ms of host time a launch, more than K2's
    device time).  ``fn`` must not synchronise with the host."""
    side = torch.cuda.Stream(device)
    side.wait_stream(torch.cuda.current_stream(device))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(device).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize(device)
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    stop.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(stop) / reps


def bound(nbytes, flops, dtype=None):
    """(least ms cuda:0 could take, what sets it): the bytes the function
    must move (each input read once, each output written once) over the
    memory rate, or its operations over the peak rate of ``dtype``'s
    arithmetic (float32 unless given; bf16 computes in float32), from
    ``benchproto.bound_s`` and the card's published peaks."""
    import torch

    from climate_sim_tpu_torch.benchproto import bound_s

    s, by = bound_s(nbytes, flops, dtype or torch.float32, torch.cuda.get_device_name(0))
    return s * 1e3, by


def nbytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def in_turns(torch, device, fns, order, reps, graphed=()):
    """Mean ms per call of each named fn, measured in ``order`` (each name
    twice, e.g. a, b, b, a), the names in ``graphed`` by CUDA graph replay
    (:func:`graph_ms`), the rest by events around a loop; returns
    {name: [ms, ms]}."""
    ms = {name: [] for name in fns}
    for name in order:
        timer = graph_ms if name in graphed else events_ms
        ms[name].append(timer(torch, device, fns[name], reps[name]))
    return ms


def phase_tile_timing(torch, device):
    """K2-K5 per pass beside their plain versions and bounds: K2-K4 on a
    2048² tile (bench BCs, f32, k = 8, a corner tile's flags), K5 on the
    2009x2001 carrier tile of 4001² on 2x2 (the corner edge tile's flags)
    in turns with K4; K2 beside conv2d with its five weights as a 3x3
    cross.  Then the rates of the 2x2 slab and overlap paths at 4096² and
    of the 2x2 carrier path at 4001² on one card beside K1's at both
    sizes, 100-step chunks, true points only; each measured in turns."""
    import torch.nn.functional as F

    from climate_sim_tpu_torch.benchproto import FLOPS_PER_POINT_STEP
    from climate_sim_tpu_torch.ops import cuda_sharded as sh
    from climate_sim_tpu_torch.ops.cuda_stencil import build_multistep_advance, stencil_constants
    from climate_sim_tpu_torch.parallel import halo
    from climate_sim_tpu_torch.parallel.mesh import shard_field

    m, k, flags = TIMING_TILE, 8, (1, 0, 1, 0)
    cfg = make_cfg(2 * m, 2 * m, "bench")
    w = edge_parked(torch, m + 2 * k, m + 2 * k, seed=11, device=device).to(torch.float32)
    tile, xh, yh = slabs(torch, w, k)
    up = w[k - 1:-(k - 1), k - 1:-(k - 1)].contiguous()
    cy, cx = CARRIER_TILE
    wc_ = edge_parked(torch, cy + 2 * k, cx + 2 * k, seed=12, device=device).to(torch.float32)
    ctile, cxh, cyh = slabs(torch, wc_, k)
    f6 = (0, 1, 0, 1, *CARRIER_EDGE)
    pairs = {
        "K2": (lambda: sh.prepadded_kernel_step(up, cfg, cfg.dt),
               lambda: sh.prepadded_step_plain(up, cfg, cfg.dt)),
        "K3": (lambda: sh.tile_region_multistep(w, flags, cfg, cfg.dt, k, m, m),
               lambda: sh.region_pass_plain(w, cfg, cfg.dt, k, m, m, flags)),
        "K4": (lambda: sh.sharded_tile_slab_multistep(tile, xh, yh, flags, cfg, cfg.dt, k),
               lambda: sh.slab_pass_plain(tile, xh, yh, flags, cfg, cfg.dt, k)),
        "K5": (lambda: sh.carrier_tile_slab_multistep(ctile, cxh, cyh, f6, cfg, cfg.dt, k),
               lambda: sh.carrier_pass_plain(ctile, cxh, cyh, f6, cfg, cfg.dt, k)),
    }
    cells = m * m
    bounds = {
        "K2": bound(nbytes(up) + 4 * cells, FLOPS_PER_POINT_STEP * cells),
        "K3": bound(nbytes(w) + 4 * cells, FLOPS_PER_POINT_STEP * k * cells),
        "K4": bound(nbytes(tile, xh, yh, tile), FLOPS_PER_POINT_STEP * k * cells),
        "K5": bound(nbytes(ctile, cxh, cyh, ctile), FLOPS_PER_POINT_STEP * k * cy * cx),
    }
    # Kernel windows of ~8-15 ms of device time each, so that the card's
    # clocks settle within a window; kernels (and conv2d) by CUDA graph
    # replay, the plain versions by events.
    k2 = pairs["K2"][0]
    for name, reps in (("K2", 500), ("K3", 150)):
        kern, plain = pairs[name]
        ms = in_turns(torch, device, {"kernel": kern, "plain": plain},
                      ("plain", "kernel", "kernel", "plain"), {"kernel": reps, "plain": 5},
                      graphed=("kernel",))
        pairs[name] = ms
    ms = in_turns(torch, device,
                  {"K4": pairs["K4"][0], "K5": pairs["K5"][0],
                   "K4 plain": pairs["K4"][1], "K5 plain": pairs["K5"][1]},
                  ("K4 plain", "K5 plain", "K4", "K5", "K5", "K4", "K5 plain", "K4 plain"),
                  {"K4": 150, "K5": 150, "K4 plain": 5, "K5 plain": 5}, graphed=("K4", "K5"))
    for name in ("K4", "K5"):
        pairs[name] = {"kernel": ms[name], "plain": ms[f"{name} plain"]}

    # K2's one PyTorch call: conv2d of the padded tile with the weights as
    # a 3x3 cross (cross-correlation: row 0 is ym, column 0 is xm), TF32 off.
    wc, wxm, wxp, wym, wyp = stencil_constants(cfg, cfg.dt).weights
    cross = torch.tensor([[0.0, wym, 0.0], [wxm, wc, wxp], [0.0, wyp, 0.0]],
                         dtype=torch.float32, device=device)[None, None]
    tf32 = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        def conv():
            return F.conv2d(up[None, None], cross)[0, 0]

        err = float((conv() - sh.prepadded_kernel_step(up, cfg, cfg.dt)).abs().max())
        if err > ATOL["float32"]:
            fail(f"conv2d vs K2: max abs err {err:.3g}")
        ms = in_turns(torch, device, {"K2": k2, "conv2d": conv},
                      ("K2", "conv2d", "conv2d", "K2"), {"K2": 500, "conv2d": 500},
                      graphed=("K2", "conv2d"))
    finally:
        torch.backends.cudnn.allow_tf32 = tf32
    library = {"K2": sum(ms["conv2d"]) / 2}
    print(f"[timing] K2's library call conv2d (3x3 cross, TF32 off) on the {m + 2}² padded"
          f" tile: {' / '.join(f'{t:.4f}' for t in ms['conv2d'])} ms (K2 in the same turns"
          f" {' / '.join(f'{t:.4f}' for t in ms['K2'])} ms); agrees with K2 to {err:.3g}")

    times = {}
    for name, v in pairs.items():
        kern_ms, plain_ms = sum(v["kernel"]) / 2, sum(v["plain"]) / 2
        times[name] = (kern_ms, plain_ms)
        steps = 1 if name == "K2" else k
        shape = f"{cy}x{cx} carrier tile" if name == "K5" else f"{m}² tile"
        pts = (cy * cx if name == "K5" else cells) * steps
        b, by = bounds[name]
        print(f"[timing] {name} on a {shape}, f32, {steps} step(s) per pass:"
              f" kernel {' / '.join(f'{t:.4f}' for t in v['kernel'])} ms, plain"
              f" {' / '.join(f'{t:.4f}' for t in v['plain'])} ms per pass"
              f" ({pts / (kern_ms * 1e6):.1f} Gpoint/s); bound {b:.4f} ms ({by}),"
              f" {b / kern_ms:.1%} of it reached")

    bcfg, dt, u0, mesh = bench_setup(torch, device)
    ccfg, cdt, cu0, _ = bench_setup(torch, device, n=CARRIER_GRID)
    tiles = shard_field(u0, mesh)
    k1_adv = build_multistep_advance(bcfg, dt)
    k1c_adv = build_multistep_advance(ccfg, cdt)
    slab_adv = halo.build_sharded_multistep_advance(bcfg, mesh, dt)
    over_adv = halo.build_sharded_overlap_advance(bcfg, mesh, dt)
    car_adv = halo.build_carrier_slab_advance(ccfg, mesh, cdt)
    carrier = car_adv.embed(cu0)
    runs = {"K1": lambda: k1_adv(100)(u0), "slab": lambda: slab_adv(100)(tiles),
            "overlap": lambda: over_adv(100)(tiles),
            f"K1 {CARRIER_GRID}²": lambda: k1c_adv(100)(cu0),
            "carrier": lambda: car_adv(100)(carrier)}
    order = ("K1", f"K1 {CARRIER_GRID}²", "carrier", "slab", "overlap",
             "overlap", "slab", "carrier", f"K1 {CARRIER_GRID}²", "K1")
    ms = in_turns(torch, device, runs, order, {name: 5 for name in runs})
    rates = {}
    for name, v in ms.items():
        n = CARRIER_GRID if name in ("carrier", f"K1 {CARRIER_GRID}²") else BENCH_GRID
        rates[name] = n * n * 100 / (sum(v) / len(v) * 1e6)
    for name, v in ms.items():
        where = " (2x2 mesh of one card)" if name in ("slab", "overlap", "carrier") else " (single device)"
        size = f"{CARRIER_GRID if name in ('carrier', f'K1 {CARRIER_GRID}²') else BENCH_GRID}²"
        print(f"[timing] {size} f32 bench BCs, 100-step chunk, {name}{where}:"
              f" {' / '.join(f'{t:.3f}' for t in v)} ms, {rates[name]:.1f} Gpoint/s"
              f" ({rates[name] / rates['K1']:.2f}x K1 at {BENCH_GRID}²,"
              f" {rates[name] / rates[f'K1 {CARRIER_GRID}²']:.2f}x K1 at {CARRIER_GRID}²)")
    return times, rates, bounds, library


def phase_profile(torch, device, tmp, label, args, n_devices, kernel):
    """A 1000-step bench_4096 run through the driver with ``args`` on
    ``[device] * n_devices``, output off, unprofiled and then with
    ``profile_dir``: the kernel time by name from the trace (which must
    hold ``kernel``'s events; on a mesh of the card, replayed from graphs,
    exactly as many as the timed passes' counted launches), ``kernel``'s
    launches, and the busy share of each wall."""
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.runtime import driver

    walls, rates = {}, {}
    prof_dir = os.path.join(tmp, f"profile_{label}".replace(" ", "_"))
    for how in ("unprofiled", "profiled"):
        run_args = [*args, "--output.enable=false"]
        if how == "profiled":
            run_args.append(f"--profile_dir={prof_dir}")
        buf = io.StringIO()
        reset_counts()
        with contextlib.redirect_stdout(buf):
            driver.run_simulation(merged_config(BENCH_CFG, run_args), [device] * n_devices)
        out = buf.getvalue()
        walls[how] = float(re.search(r"^timing: total_max=(\S+) s", out, re.M).group(1))
        launches = read_counts()[kernel]
        rates[how] = re.search(r"^throughput: (.*)$", out, re.M).group(1)
    with open(os.path.join(prof_dir, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    by_name = {}
    for ev in events:
        if ev.get("cat") == "kernel":
            key = f"band_kernel ({kernel})" if "band_kernel" in ev["name"] else ev["name"][:60]
            n, us = by_name.get(key, (0, 0.0))
            by_name[key] = (n + 1, us + ev.get("dur", 0.0))
    total_ms = sum(us for _, us in by_name.values()) / 1e3
    k_n, k_us = by_name.get(f"band_kernel ({kernel})", (0, 0.0))
    if not k_n:
        fail(f"profile {label}: the trace holds no {kernel} kernel event"
             f" ({len(by_name)} kernel names traced)")
    # The trace spans the timed loop: the launches less the warm-up's.
    timed, warm = (int(v) for v in re.search(r"^passes: timed=(\d+) warmup=(\d+)$",
                                             out, re.M).groups())
    want = launches * timed // (timed + warm)
    if "chunks as CUDA graphs" in out and k_n != want:
        fail(f"profile {label}: the trace holds {k_n} {kernel} events of replayed"
             f" graphs; the run counted {launches} launches, {want} of them timed")
    print(f"[profile] {label}, 1000 steps, output off: timing wall {walls['unprofiled']:.4f} s"
          f" unprofiled, {walls['profiled']:.4f} s profiled; {kernel} launches {launches}"
          f" (incl. warm-up; {want} timed), {k_us / 1e3:.2f} ms of {kernel} in {k_n}"
          f" traced launches;"
          f" kernel time {total_ms:.1f} ms, busy {total_ms / 1e3 / walls['profiled']:.1%}"
          f" of the profiled wall, {total_ms / 1e3 / walls['unprofiled']:.1%} of the"
          f" unprofiled")
    print(f"[profile] {label} throughput: {rates['unprofiled']} unprofiled;"
          f" {rates['profiled']} profiled")
    for key, (n, us) in sorted(by_name.items(), key=lambda kv: -kv[1][1])[:6]:
        print(f"[profile]   {us / 1e3:8.2f} ms in {n:5d} launches: {key}")
    return walls, total_ms


def multiprocess_only(torch, device, nccl_only) -> int:
    """``python3 chip_smoke.py --multiprocess-only``: phase 7's three
    references and the multi-process phase alone, then the NCCL runs (on
    four cards); ``--nccl-only``: the NCCL runs and their single-process
    references alone, then the NCCL exchange-latency runs.  Ends with a JSON line of the launches and
    throughput lines, not the ``ok`` line of a full run."""
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches, rates = {n: 0 for n in KERNEL_NAMES}, {}
        if not nccl_only:
            refs = {}
            for run, ref in zip(MP_RUNS, ("bench_4096_2x2_slab", CARRIER_RUNS[0][0],
                                          "bench_4096_2x2_overlap")):
                label, cfg_path, extra, _, _, kernel = run
                refs[label] = phase_sharded_run(torch, device, ref, cfg_path, extra, (2, 2),
                                                kernel, tmp)[2]
            launches, rates = phase_multiprocess(torch, device, tmp, refs)
        nccl_launches, nccl_rates = phase_nccl(torch, tmp)
        if nccl_only:
            phase_latency_nccl(torch)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"multiprocess": {
        "launches": {n: launches[n] + nccl_launches[n] for n in KERNEL_NAMES},
        "throughput": {**rates, **nccl_rates}}}))
    return 0


def graphs_only(torch, device) -> int:
    """``python3 chip_smoke.py --graphs-only``: ``phase_graphs``, then
    phase 7's bench_4096 slab run and 4001² carrier run, each with its
    checks and again under ``disable_graphs()`` (files byte-identical).
    Ends with a JSON line of the eager and graphed chunk times, not the
    ``ok`` line of a full run."""
    ms = phase_graphs(torch, device)
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        files = {}
        for label, cfg_path, extra, mesh_xy, kernel in (
            ("bench_4096_2x2_slab", BENCH_CFG, BENCH_STEPS, (2, 2), "K4"),
            (*CARRIER_RUNS[0], "K5"),
        ):
            files[label] = phase_sharded_run(torch, device, label, cfg_path, extra, mesh_xy,
                                             kernel, tmp)[2]
        phase_eager_files(torch, device, tmp, files)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(json.dumps({"graphs": {"chunk_ms": ms}}))
    return 0


def fuzz_seed_arg(argv):
    """``argv`` without ``--fuzz-seed N`` / ``--fuzz-seed=N``, and the seed
    (FUZZ_SEED when absent)."""
    rest, seed, i = [], FUZZ_SEED, 0
    while i < len(argv):
        if argv[i] == "--fuzz-seed" and i + 1 < len(argv):
            seed, i = int(argv[i + 1]), i + 2
            continue
        if argv[i].startswith("--fuzz-seed="):
            seed = int(argv[i].split("=", 1)[1])
        else:
            rest.append(argv[i])
        i += 1
    return rest, seed


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
    args, fuzz_seed = fuzz_seed_arg(sys.argv[1:])

    name, smi = phase_device(torch)
    phase_build()
    if args == ["--fuzz-only"]:
        fuzz_cases, _ = phase_fuzz(torch, device, fuzz_seed)
        print(json.dumps({"fuzz": {"seed": fuzz_seed, "cases": fuzz_cases}}))
        return 0
    if args in (["--multiprocess-only"], ["--nccl-only"]):
        return multiprocess_only(torch, device, args[0] == "--nccl-only")
    if args == ["--graphs-only"]:
        return graphs_only(torch, device)
    if args == ["--parity-only"]:
        print(json.dumps({"parity": phase_parity(torch, device)}))
        return 0
    for flag, phase in (("--tools-only", phase_tools), ("--study-only", phase_study),
                        ("--latency-only", phase_latency),
                        ("--bench-only", bench_after_timing)):
        if args == [flag]:
            tmp = tempfile.mkdtemp(prefix="chip_smoke_")
            try:
                counts = phase(torch, device, tmp)
            finally:
                shutil.rmtree(tmp, ignore_errors=True)
            print(json.dumps({flag.removeprefix("--").removesuffix("-only"):
                              {"launches": counts}}))
            return 0
    cases, worst = phase_kernel_vs_plain(torch, device)
    tile_cases, tile_worst = phase_tile_kernels_vs_plain(torch, device)
    tile_cases["K5"], tile_worst["K5"] = phase_carrier_kernel_vs_plain(torch, device)
    fuzz_cases, fuzz_worst = phase_fuzz(torch, device, fuzz_seed)
    launches = {n: 0 for n in KERNEL_NAMES}
    tmp = tempfile.mkdtemp(prefix="chip_smoke_")
    try:
        launches["K1"] += phase_main_path(
            torch, device, "bench_4096", BENCH_CFG,
            ["--steps=1000", "--out_every=500"], tmp,
        )
        launches["K1"] += phase_main_path(torch, device, "dev", DEV_CFG, [], tmp)
        files = {}
        for label, cfg_path, extra, mesh_xy, kernel in (
            ("bench_4096_2x2_slab", BENCH_CFG, BENCH_STEPS, (2, 2), "K4"),
            ("bench_4096_2x2_overlap", BENCH_CFG, [*BENCH_STEPS, "--halo_overlap=true"],
             (2, 2), "K3"),
            ("dev_1x4", DEV_CFG, [], (1, 4), "K4"),
            ("dev_4x1", DEV_CFG, [], (4, 1), "K4"),
            *((*run, "K5") for run in CARRIER_RUNS),
        ):
            n, _, files[label] = phase_sharded_run(
                torch, device, label, cfg_path, extra, mesh_xy, kernel, tmp)
            launches[kernel] += n
        phase_eager_files(torch, device, tmp, files)
        launches["K2"] += phase_per_step(torch, device)[0]
        launches["K2"] += phase_padded_per_step(torch, device)
        phase_graphs(torch, device)
        # The multi-process runs, each held to phase 7's run of its config.
        refs = dict(zip((run[0] for run in MP_RUNS),
                        (files["bench_4096_2x2_slab"], files[CARRIER_RUNS[0][0]],
                         files["bench_4096_2x2_overlap"])))
        mp_launches, _ = phase_multiprocess(torch, device, tmp, refs)
        nccl_launches, _ = phase_nccl(torch, tmp)
        for n in KERNEL_NAMES:
            launches[n] += mp_launches[n] + nccl_launches[n]
        # The tools' launches (their timing loops included) stand beside the
        # paths' own counts, never in them.
        tools = phase_tools(torch, device, tmp)
        for n, count in phase_study(torch, device, tmp).items():
            tools[n] += count
        for n, count in phase_latency(torch, device, tmp).items():
            tools[n] += count
        phase_latency_nccl(torch)
        k1_times = phase_timing(torch, device)
        for n, count in phase_bench(torch, device, k1_times["float32"][0]).items():
            tools[n] += count
        tile_times, _, bounds, library = phase_tile_timing(torch, device)
        phase_profile(torch, device, tmp, f"bench_{BENCH_GRID} single device",
                      ["--kernel=pallas"], 1, "K1")
        phase_profile(torch, device, tmp, f"carrier {CARRIER_GRID}² on 2x2",
                      ["--kernel=pallas", f"--nx={CARRIER_GRID}", f"--ny={CARRIER_GRID}",
                       "--mesh.x=2", "--mesh.y=2"], 4, "K5")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)

    sources = {"K1": "multistep_stencil.cu", "K2": "region_stencil.cu",
               "K3": "region_stencil.cu", "K4": "slab_stencil.cu",
               "K5": "slab_stencil.cu"}
    replaces = {"K1": 1309, "K2": 1371, "K3": 1418, "K4": 1525, "K5": 1588}
    titles = {"K1": "K1 multistep_stencil", "K2": "K2 prepadded_kernel_step",
              "K3": "K3 tile_region_multistep", "K4": "K4 sharded_tile_slab_multistep",
              "K5": "K5 carrier_tile_slab_multistep"}
    all_cases = {"K1": cases, **tile_cases}
    all_worst = {"K1": worst, **tile_worst}
    all_times = {"K1": k1_times["float32"][:2], **tile_times}
    all_bounds = {"K1": k1_times["float32"][2], **bounds}
    for n in KERNEL_NAMES:
        if launches[n] < 1:
            fail(f"{n} was launched no time on its path")
        if tools[n] < 1:
            fail(f"{n} was launched no time by the tools")
    kernels = {"kernels": [{
        "name": titles[n],
        "route": "cuda",
        "source": f"climate_sim_tpu_torch/csrc/{sources[n]}",
        "replaces": f"climate_sim_tpu/ops/pallas_stencil.py:{replaces[n]}",
        "launches": launches[n],
        "tools_launches": tools[n],
        "max_abs_err": all_worst[n]["float32"],
        "max_abs_err_by_dtype": all_worst[n],
        **({"ms_by_dtype": {d: t[0] for d, t in k1_times.items()}} if n == "K1" else {}),
        "cases": all_cases[n],
        "fuzz_cases": fuzz_cases[n],
        "fuzz_max_abs_err_by_dtype": fuzz_worst[n],
        "ms": all_times[n][0],
        "plain_ms": all_times[n][1],
        "bound_ms": all_bounds[n][0],
        "bound_by": all_bounds[n][1],
        "library_ms": library.get(n),
    } for n in KERNEL_NAMES]}
    print(json.dumps(kernels))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
