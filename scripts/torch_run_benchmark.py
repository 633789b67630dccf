#!/usr/bin/env python3
"""Strong/weak scaling harness for the PyTorch port.

The port's counterpart of ``scripts/run_benchmark.py``, which mirrors the
reference's ``scripts/run_benchmark.sh`` protocol and CSV schema
(reference: run_benchmark.sh:31-91): strong scaling on a fixed grid over a
rank sweep, weak scaling with a fixed per-rank tile, speedup S=T1/Tp,
efficiency E=S/p and Karp-Flatt (1/S-1/p)/(1-1/p) annotations.  Every
measurement runs the port's CLI (``python -m climate_sim_tpu_torch``) and
parses its ``timing: total_max=... worst_avg_step=...`` line.

Platforms:

* ``multiproc`` (default) — p processes of the CLI joined with
  ``--distributed=127.0.0.1:PORT,p,i``, one mesh tile each: the
  ``mpirun -np p`` analogue.  On cards rank i takes
  ``cuda:(i % device count)``, over NCCL or gloo as the port's transport
  decides (ranks sharing a card exchange through pinned host buffers); with
  ``--device=cpu`` the ranks run gloo on the CPU.  Each rank is pinned to
  core ``i % cores`` with one intra-op thread.
* ``multiproc_nocomm`` — the contention control: p INDEPENDENT
  single-process runs, each on 1/p of the grid's larger axis (the last run
  takes the remainder lines, as the reference's decomposition does),
  started together and pinned like ``multiproc``, with no communication.
* ``cuda`` — one process over the cards with ``--max_devices=p``; rank
  counts are capped at the card count.  It needs a card and never runs on
  the CPU.

``--device`` is ``cuda`` (the default) or ``cpu``; without a card the
``cuda`` device fails before any run and writes nothing.  Unrecognised
``--key=value`` tokens pass through to the CLI (``--config=...``).

Outputs (the JAX harness's names and columns, with a leading ``platform``
column), under ``--out-dir`` (default ``outputs/bench_torch``):
    strong_<ts>.csv
    strong_annotated_<ts>.csv
    weak_<ts>.csv
"""

from __future__ import annotations

import argparse
import datetime
import math
import os
import re
import shutil
import subprocess
import sys
import tempfile
from typing import List, Tuple

REPO_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_TIMING_RE = re.compile(r"timing: total_max=([0-9.eE+-]+)")
RUN_TIMEOUT_S = 1800


def _free_port() -> int:
    import socket

    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _sim_args(nx: int, ny: int, steps: int, extra: List[str]) -> List[str]:
    return [
        sys.executable, "-m", "climate_sim_tpu_torch",
        f"--nx={nx}", f"--ny={ny}", f"--steps={steps}",
        "--out_every=1000000",  # timing runs write no mid-run snapshots
        "--output.enable=false",
    ] + extra


def _cli_env(device: str) -> dict:
    env = dict(os.environ)
    if device == "cpu":
        env["CLIMATE_SIM_PLATFORM"] = "cpu"
    else:
        env.pop("CLIMATE_SIM_PLATFORM", None)
    return env


def nocomm_split(n: int, p: int) -> List[int]:
    """The lines of each of ``p`` independent runs over an axis of ``n``:
    ``n // p`` each, the last one the remainder too (the reference's
    decomposition, decomp.cpp:29-30), so the runs cover the whole grid."""
    from climate_sim_tpu_torch.parallel.mesh import split_sizes

    return split_sizes(n, p)


def _visible_cards() -> List[str]:
    """The CUDA_VISIBLE_DEVICES entries of this process's cards."""
    import torch

    visible = os.environ.get("CUDA_VISIBLE_DEVICES")
    names = visible.split(",") if visible else []
    return names[:torch.cuda.device_count()] or [str(i) for i in range(torch.cuda.device_count())]


def run_multiproc(p: int, nx: int, ny: int, steps: int, extra: List[str],
                  device: str, nocomm: bool = False) -> Tuple[float, float]:
    """p CLI processes, the ``mpirun -np p`` analogue; returns rank 0's
    MAX-over-ranks timing.  ``nocomm=True``: p independent runs on 1/p of
    the grid each (:func:`nocomm_split`), the slowest run's timing."""
    port = _free_port()
    env = _cli_env(device)
    # One core per rank, like `mpirun -np p` with one PE per rank: without
    # this, each rank's intra-op thread pool uses every core and the sweep
    # measures thread-vs-process contention instead of scaling.
    env["OMP_NUM_THREADS"] = "1"
    ncores = os.cpu_count() or 1
    pin = shutil.which("taskset") is not None
    cards = _visible_cards() if device == "cuda" and nocomm else []
    # Each rank's output goes to its own temp file, NOT a pipe: draining p
    # pipes sequentially can deadlock when a non-zero rank emits more than
    # the pipe buffer (it blocks on write, never reaches the end-of-run
    # barrier, and rank 0 never exits).
    outfiles = [tempfile.TemporaryFile(mode="w+") for _ in range(p)]
    split = nocomm_split(ny if ny >= nx else nx, p) if nocomm else None

    def rank_args(i):
        if not nocomm:
            return _sim_args(nx, ny, steps, extra) + [f"--distributed=127.0.0.1:{port},{p},{i}"]
        # independent runs: split the LARGER axis p ways (the same per-rank
        # interior work as the mesh run, zero comm)
        if ny >= nx:
            return _sim_args(nx, split[i], steps, extra)
        return _sim_args(split[i], ny, steps, extra)

    def rank_env(i):
        if not cards:
            return env
        # An independent run takes every card it sees as a mesh: show it
        # only its own, as a rank of ``multiproc`` takes cuda:(i % count).
        return {**env, "CUDA_VISIBLE_DEVICES": cards[i % len(cards)]}

    procs = [
        subprocess.Popen(
            (["taskset", "-c", str(i % ncores)] if pin else []) + rank_args(i),
            cwd=REPO_ROOT, env=rank_env(i), stdout=outfiles[i],
            stderr=subprocess.STDOUT, text=True,
        )
        for i in range(p)
    ]
    try:
        for pr in procs:
            pr.wait(timeout=RUN_TIMEOUT_S)
    except subprocess.TimeoutExpired:
        for pr in procs:  # kill the exact PIDs we started, never by pattern
            if pr.poll() is None:
                pr.kill()
        for pr in procs:
            pr.wait()
        raise
    outs = []
    for f in outfiles:
        f.seek(0)
        outs.append(f.read())
        f.close()
    for i, (pr, o) in enumerate(zip(procs, outs)):
        if pr.returncode != 0:
            raise RuntimeError(
                f"multiproc rank {i}/{p} failed (exit {pr.returncode}):\n{o[-2000:]}"
            )
    if nocomm:
        # independent runs: the slowest one is the honest analogue of the
        # mesh run's MAX-over-ranks timing
        totals = []
        for i, o in enumerate(outs):
            m = _TIMING_RE.search(o)
            if not m:
                raise RuntimeError(f"no timing line in nocomm rank-{i} output:\n{o[-2000:]}")
            totals.append(float(m.group(1)))
        total = max(totals)
        return total, total / steps
    m = _TIMING_RE.search(outs[0])
    if not m:
        raise RuntimeError(f"no timing line in rank-0 output:\n{outs[0][-2000:]}")
    total = float(m.group(1))
    return total, total / steps


def run_one(p: int, nx: int, ny: int, steps: int, platform: str,
            extra: List[str], device: str) -> Tuple[float, float]:
    """One measurement -> (total_time, perstep_time)."""
    if platform == "multiproc":
        return run_multiproc(p, nx, ny, steps, extra, device)
    if platform == "multiproc_nocomm":
        return run_multiproc(p, nx, ny, steps, extra, device, nocomm=True)
    # cuda: cap the device count per measurement, else every row would use
    # all attached cards.
    args = _sim_args(nx, ny, steps, extra) + [f"--max_devices={p}"]
    out = subprocess.run(args, cwd=REPO_ROOT, env=_cli_env("cuda"), capture_output=True,
                         text=True, timeout=RUN_TIMEOUT_S)
    if out.returncode != 0:
        raise RuntimeError(
            f"run p={p} nx={nx} ny={ny} failed (exit {out.returncode}):\n{out.stderr[-2000:]}"
        )
    m = _TIMING_RE.search(out.stdout)
    if not m:
        raise RuntimeError(f"no timing line in output:\n{out.stdout[-2000:]}")
    total = float(m.group(1))
    return total, total / steps


def annotate_strong(rows: list[tuple]) -> tuple[list[tuple], int]:
    """Annotate with S=T1/Tp, E=S/p, Karp-Flatt.  The baseline is the
    SMALLEST rank count in the sweep (not blindly rows[0]); if that is
    p0 > 1, T1 is extrapolated as p0*T_p0 (ideal-linear at the baseline)
    so the columns keep their standard meaning — the caller records the
    extrapolation in a CSV comment.  Returns (annotated_rows, p0)."""
    base = min(rows, key=lambda r: r[0])
    p0 = base[0]
    t1 = base[4] * p0
    ann = []
    for (p, nx, ny, steps, total, perstep) in rows:
        s = t1 / total if total > 0 else 0.0
        e = s / p if p else 0.0
        kf = ((1.0 / s - 1.0 / p) / (1.0 - 1.0 / p)) if (p > 1 and s > 0) else 0.0
        ann.append((p, nx, ny, steps, total, perstep, s, e, kf))
    return ann, p0


def weak_efficiency(t1: float, total: float, p: int, nx: int, ny: int,
                    tile_nx: int, tile_ny: int) -> float:
    """E_w = T1/Tp at ~constant work per rank (ideal = 1).  The sqrt-rounded
    grid can give rank p slightly more work per rank than rank 1, so the
    times are normalised by the actual per-rank load; ``t1`` is the first
    row's time normalised to one tile."""
    return t1 * (nx * ny / p) / (tile_nx * tile_ny) / total


def _card_count() -> int:
    """The visible card count; 0 without a card."""
    import torch

    return torch.cuda.device_count() if torch.cuda.is_available() else 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--platform", choices=["multiproc", "multiproc_nocomm", "cuda"],
                    default="multiproc",
                    help="multiproc = p CLI processes joined by --distributed (default);"
                         " multiproc_nocomm = p INDEPENDENT pinned runs on 1/p grids (the"
                         " contention control); cuda = one process over the cards")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="where the runs go (cpu: CLIMATE_SIM_PLATFORM=cpu, multiproc only)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--strong-nx", type=int, default=1024)
    ap.add_argument("--strong-ny", type=int, default=1024)
    ap.add_argument("--strong-ranks", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--weak-tile-nx", type=int, default=256)
    ap.add_argument("--weak-tile-ny", type=int, default=256)
    ap.add_argument("--weak-ranks", type=int, nargs="+", default=[1, 4, 16])
    ap.add_argument("--out-dir", default=os.path.join(REPO_ROOT, "outputs", "bench_torch"))
    ap.add_argument("--skip-weak", action="store_true")
    args, extra = ap.parse_known_args(argv)
    # Unrecognized --key=value tokens pass through to the simulation CLI.
    args.extra = extra

    if args.platform == "cuda" and args.device == "cpu":
        print("run_benchmark: --platform=cuda runs on the cards; --device=cpu needs a"
              " multiproc platform", file=sys.stderr)
        return 2
    if args.device == "cuda":
        n = _card_count()
        if n == 0:
            print("run_benchmark: --device=cuda but torch.cuda.is_available() is False;"
                  " pass --device=cpu for CPU ranks", file=sys.stderr)
            return 1
        if args.platform == "cuda":
            args.strong_ranks = sorted({min(p, n) for p in args.strong_ranks})
            args.weak_ranks = sorted({min(p, n) for p in args.weak_ranks})

    ncores = os.cpu_count() or 1
    warn_note = ""
    if args.platform == "multiproc":
        over = [p for p in args.strong_ranks + args.weak_ranks if p > ncores]
        if over:
            warn_note = (f"# WARNING: ranks {sorted(set(over))} exceed "
                         f"{ncores} cores — those rows measure "
                         "oversubscription, not scaling\n")
            print(warn_note.strip(), flush=True)
        # Collectives between ranks on the CPU, and between ranks that
        # share a card, ride TCP loopback (~ms per exchange): rows whose
        # per-rank per-step compute is comparable to that latency measure
        # coordination latency, not scaling.
        warn_note += (
            "# NOTE: multiproc collectives ride TCP loopback (~ms); rows "
            "with small per-rank tiles are latency-dominated — compare "
            "per-rank work against perstep_time before reading speedup "
            "(large-tile sweeps measure bandwidth scaling instead)\n"
        )

    os.makedirs(args.out_dir, exist_ok=True)
    ts = datetime.datetime.now().strftime("%Y%m%d_%H%M%S")
    strong_csv = os.path.join(args.out_dir, f"strong_{ts}.csv")
    strong_annot = os.path.join(args.out_dir, f"strong_annotated_{ts}.csv")
    weak_csv = os.path.join(args.out_dir, f"weak_{ts}.csv")

    header = "platform,ranks,nx,ny,steps,total_time,perstep_time"
    plat = args.platform

    rows = []
    for p in args.strong_ranks:
        print(f"== strong: p={p} ==", flush=True)
        total, perstep = run_one(p, args.strong_nx, args.strong_ny, args.steps,
                                 args.platform, args.extra, args.device)
        rows.append((p, args.strong_nx, args.strong_ny, args.steps, total, perstep))
    with open(strong_csv, "w") as f:
        f.write(f"# strong scaling: Nx={args.strong_nx}, Ny={args.strong_ny}, "
                f"steps={args.steps}\n{warn_note}{header}\n")
        for r in rows:
            f.write(plat + "," + ",".join(str(v) for v in r) + "\n")
    ann, p0 = annotate_strong(rows)
    with open(strong_annot, "w") as f:
        f.write(f"# strong scaling: Nx={args.strong_nx}, Ny={args.strong_ny}, "
                f"steps={args.steps}\n{warn_note}")
        if p0 != 1:
            f.write(f"# NOTE: sweep has no p=1 row; T1 extrapolated as "
                    f"{p0}*T_{p0} (ideal-linear baseline at p={p0})\n")
        f.write(f"{header},speedup,efficiency,karp_flatt\n")
        for r in ann:
            f.write(plat + "," + ",".join(str(v) for v in r) + "\n")
    print(f"Annotated strong-scaling results written to {strong_annot}")

    if not args.skip_weak:
        tile_nx, tile_ny = args.weak_tile_nx, args.weak_tile_ny
        with open(weak_csv, "w") as f:
            f.write(f"# weak scaling: tile={tile_nx}x{tile_ny}, "
                    f"steps={args.steps}\n{warn_note}{header},weak_efficiency\n")
            t1 = None
            for p in args.weak_ranks:
                k = math.ceil(math.sqrt(p))
                nx, ny = tile_nx * k, tile_ny * k
                print(f"== weak: p={p}, Nx={nx}, Ny={ny} ==", flush=True)
                total, perstep = run_one(p, nx, ny, args.steps, args.platform, args.extra,
                                         args.device)
                if t1 is None:
                    t1 = total * (tile_nx * tile_ny) / (nx * ny / p)
                ew = weak_efficiency(t1, total, p, nx, ny, tile_nx, tile_ny)
                f.write(f"{plat},{p},{nx},{ny},{args.steps},{total},{perstep},{ew}\n")

    print(f"\nWrote:\n  {strong_csv}\n  {strong_annot}")
    if not args.skip_weak:
        print(f"  {weak_csv}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
