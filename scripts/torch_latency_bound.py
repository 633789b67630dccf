#!/usr/bin/env python3
"""Latency injection: bound the port's weak-scaling efficiency against
exchange LATENCY, and the overlap path's breakeven.

The port's counterpart of ``scripts/latency_bound.py``.  A pass of a mesh
path serializes some number n of exchange latencies L, so with one tile a
rank

    eff(L) = T_pass / (T_pass + n * L).

Two n's bound it (``climate_sim_tpu_torch/parallel/analysis.py``): the
exchange depth of the pass, what the dataflow allows, and its batch
count, the ``halo._deliver`` calls that move a payload (each a
rendezvous across ranks), what the port pays.

This script measures the slope directly.  It runs the paths on a tile
mesh of ``--devices`` tiles (``choose_mesh_shape``) that all lie on one
device (the CPU, or ``cuda:0`` with ``--device cuda``), with
``halo._deliver`` swapped, for the run and restored after it, for a
wrapper that holds the host for L (a busy wait: ``time.sleep`` overshoots
short requests; the ``host wait`` lines compare the two) once for each
batch that moves a payload.  The per-pass time over the sweep of
``--latencies-ms`` gives the slope dT_pass/dL (``np.polyfit``) for the
slab path (K4), the overlap path (K3)
and the staged carrier torus (K5 on an all-periodic grid one line short
of the mesh on each axis, where the wrap-head batches widen the gap
between batches and depth most).  The host waits, so the slope is the
batch count: the host issues a pass's batches in turn.

Every chunk runs eagerly, under ``disable_graphs()``: the injected wait is
host code that runs once per batch, and a captured chunk (a CUDA graph)
runs no host code between its batches, so it could not be injected; the
model's T_pass is the eager pass whose batches it injects on.

The model then takes T_pass of a k=8 pass from a rate:
``--hw-slab-gpts`` / ``--hw-overlap-gpts``, or, with ``--device cuda``
and neither given, the slab and overlap rates measured here on a 2x2
mesh of the card at 4096²; and L from ``--model-latency-us`` (e.g. what
``scripts/torch_exchange_latency.py`` measured).  For each tile and L it
prints eff(L) with n = depth and n = batches, and the breakeven latency
past which overlap beats slab, L* = (T_overlap - T_slab) / (n_slab -
n_overlap).  On the CPU with no rates it prints the slopes only.

Usage:
    python scripts/torch_latency_bound.py [--devices 8] [--tile 256]
        [--latencies-ms 0 2 5 10] [--passes 6] [--trials 3]
        [--hw-slab-gpts G] [--hw-overlap-gpts G] [--model-latency-us L ...]
        [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

STEPS_PER_PASS = 8  # k of a pass at the model's tiles (pick_steps_per_pass)
RATE_GRID = 4096  # the 2x2 mesh of the card the rates are measured on
RATE_CHUNK = 400  # steps a timed chunk of that measurement
PATHS = ("slab", "overlap", "carrier torus")


def path_cfg(path: str, nx: int, ny: int, steps: int):
    """The JAX script's config (D/N/D/N BCs) for slab and overlap; an
    all-periodic grid one line short of ``nx`` x ``ny`` for the carrier
    torus, so that both axes stage wrap heads and tail-mirrors."""
    from climate_sim_tpu_torch.config import BCConfig, BCType, SimConfig

    D, N, P = BCType.DIRICHLET, BCType.NEUMANN, BCType.PERIODIC
    torus = path == "carrier torus"
    cfg = SimConfig(nx=nx - torus, ny=ny - torus, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                    steps=steps, out_every=steps)
    cfg.bc = BCConfig(*((P,) * 4 if torus else (D, N, D, N)))
    return cfg


def build(path: str, cfg, mesh, device):
    """(advance, its tiles of the Gaussian IC), or (None, None) where the
    path declines the shape."""
    import torch

    from climate_sim_tpu_torch.ops.init import gaussian_hotspot
    from climate_sim_tpu_torch.parallel import halo
    from climate_sim_tpu_torch.parallel.mesh import shard_field

    build_path = {"slab": halo.build_sharded_multistep_advance,
                  "overlap": halo.build_sharded_overlap_advance,
                  "carrier torus": halo.build_carrier_slab_advance}[path]
    adv = build_path(cfg, mesh, cfg.dt)
    if adv is None:
        return None, None
    u = gaussian_hotspot(cfg, torch.float32, device)
    return adv, (adv.embed(u) if path == "carrier torus" else shard_field(u, mesh))


def structure(path: str, cfg, px: int, py: int) -> Optional[Tuple[int, int]]:
    """(exchange depth, exchange batches) of one pass of ``path`` at
    ``cfg`` on a CPU mesh of the same shape; None where it declines."""
    import torch

    from climate_sim_tpu_torch.parallel.analysis import (
        exchange_batches, exchange_critical_depth,
    )
    from climate_sim_tpu_torch.parallel.mesh import make_mesh

    cpu = torch.device("cpu")
    mesh = make_mesh(px, py, [cpu] * (px * py))
    adv, tiles = build(path, cfg, mesh, cpu)
    if adv is None:
        return None
    k = adv.steps_per_pass
    depth = exchange_critical_depth(adv(k), tiles)
    _, tiles = build(path, cfg, mesh, cpu)
    return depth, exchange_batches(adv(k), tiles)


def delay(seconds: float) -> None:
    """Hold the host for ``seconds``: a busy wait on the clock, since
    ``time.sleep`` can overshoot a sub-millisecond request by more than
    the request, which would read as a larger slope (the ``host wait``
    lines print both)."""
    end = time.perf_counter() + seconds
    while time.perf_counter() < end:
        pass


def wait_accuracy(latencies_ms: List[float], reps: int = 20) -> List[str]:
    """For each L > 0 of the sweep, the median ms that :func:`delay` and
    ``time.sleep`` hold the host for."""
    lines = []
    for lat_ms in sorted({v for v in latencies_ms if v > 0}):
        held = {}
        for name, fn in (("busy wait", delay), ("time.sleep", time.sleep)):
            runs = []
            for _ in range(reps):
                t0 = time.perf_counter()
                fn(lat_ms / 1e3)
                runs.append(time.perf_counter() - t0)
            held[name] = sorted(runs)[reps // 2] * 1e3
        lines.append(f"host wait L={lat_ms:.2f} ms: " + ", ".join(
            f"{name} {ms:.3f} ms" for name, ms in held.items()) + f" (median of {reps})")
    return lines


def measure(path: str, cfg, mesh, device, latencies_ms: List[float], trials: int
            ) -> Optional[Tuple[List[Tuple[float, float]], float]]:
    """[(L ms, T_pass ms)] over the sweep with one wait of L for each batch
    that moves a payload, and the waits a pass; None where the path
    declines the shape."""
    from climate_sim_tpu_torch.benchproto import time_best_of
    from climate_sim_tpu_torch.parallel.analysis import on_each_batch

    adv, tiles = build(path, cfg, mesh, device)
    if adv is None:
        return None
    passes = adv.pass_count(cfg.steps)
    fn = adv(cfg.steps)
    state = {"lat": 0.0, "sleeps": 0}

    def sleep():
        state["sleeps"] += 1
        delay(state["lat"])

    rows = []
    with on_each_batch(sleep):
        for lat_ms in latencies_ms:
            state["lat"] = lat_ms / 1e3
            best, tiles = time_best_of(fn, tiles, 1, trials)
            rows.append((lat_ms, best / passes * 1e3))
    sleeps = state["sleeps"] / (len(latencies_ms) * (trials + 1) * passes)
    return rows, sleeps


def measure_rates(device, trials: int) -> Dict[str, float]:
    """Gpoint/s of the slab and overlap paths on a 2x2 mesh of ``device`` at
    RATE_GRID², no injection."""
    from climate_sim_tpu_torch.benchproto import time_best_of
    from climate_sim_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh(2, 2, [device] * 4)
    rates = {}
    for path in ("slab", "overlap"):
        cfg = path_cfg(path, RATE_GRID, RATE_GRID, RATE_CHUNK)
        adv, tiles = build(path, cfg, mesh, device)
        best, _ = time_best_of(adv(RATE_CHUNK), tiles, 1, trials)
        rates[path] = RATE_GRID * RATE_GRID * RATE_CHUNK / best / 1e9
    return rates


def slope(rows: List[Tuple[float, float]]) -> float:
    """Least-squares dT_pass/dL: the latencies a pass serializes."""
    import numpy as np

    if len(rows) < 2:
        return 0.0
    return float(np.polyfit([r[0] for r in rows], [r[1] for r in rows], 1)[0])


def model_lines(tiles: List[int], rates: Dict[str, float], latencies_us: List[float],
                struct: Dict[str, Tuple[int, int]]) -> List[str]:
    """eff(L) for each tile, path and L with n = depth and n = batches, then
    the breakeven L* of overlap against slab for each n."""
    lines = []
    for tile in tiles:
        t = {p: STEPS_PER_PASS * tile * tile / (rates[p] * 1e9) for p in rates}
        lines.append(f"  {tile}² tile, k={STEPS_PER_PASS} pass: " + ", ".join(
            f"T_{p} {t[p] * 1e6:.1f} us at {rates[p]:.2f} Gpt/s" for p in rates))
        for p in rates:
            depth, batches = struct[p]
            for lat_us in latencies_us:
                lat = lat_us * 1e-6
                lines.append(
                    f"    {p:8s} L={lat_us:9.3f} us: eff = {t[p] / (t[p] + depth * lat):7.2%}"
                    f" (n = depth {depth}), {t[p] / (t[p] + batches * lat):7.2%}"
                    f" (n = batches {batches})")
        for i, name in ((0, "depth"), (1, "batches")):
            dn = struct["slab"][i] - struct["overlap"][i]
            dt_us = (t["overlap"] - t["slab"]) * 1e6
            if dn:
                lines.append(f"    breakeven (n = {name}): L* = {dt_us / dn:.1f} us")
            else:
                lines.append(f"    breakeven (n = {name}): none, both paths serialize"
                             f" {struct['slab'][i]}; overlap's pass is {dt_us:.1f} us"
                             f" longer at every L")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--devices", type=int, default=8, help="tiles of the mesh")
    ap.add_argument("--tile", type=int, default=256, help="per-tile extent")
    ap.add_argument("--latencies-ms", type=float, nargs="+", default=[0.0, 2.0, 5.0, 10.0])
    ap.add_argument("--passes", type=int, default=6,
                    help="k=8 passes (8 steps each) per measurement")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--hw-slab-gpts", type=float, default=None,
                    help="the slab path's rate for the model, Gpoint/s")
    ap.add_argument("--hw-overlap-gpts", type=float, default=None,
                    help="the overlap path's rate for the model, Gpoint/s")
    ap.add_argument("--model-latency-us", type=float, nargs="+", default=[],
                    help="per-round latencies L for the model's eff(L) rows, us")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)
    if (a.hw_slab_gpts is None) != (a.hw_overlap_gpts is None):
        ap.error("--hw-slab-gpts and --hw-overlap-gpts go together")

    from climate_sim_tpu_torch.runtime.graphs import disable_graphs

    with disable_graphs():
        return run(a)


def run(a) -> int:
    """The measurements and the model, every chunk eager."""
    import torch

    from climate_sim_tpu_torch.parallel.mesh import choose_mesh_shape, make_mesh

    if a.device == "cuda":
        if not torch.cuda.is_available():
            print("latency_bound: --device=cuda but torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
    else:
        device = torch.device("cpu")
    px, py = choose_mesh_shape(a.devices, a.tile * 4, a.tile * 4)
    nx, ny = a.tile * px, a.tile * py
    steps = STEPS_PER_PASS * a.passes
    mesh = make_mesh(px, py, [device] * (px * py))
    print(f"mesh x={px} y={py} of {device}, grid {nx}x{ny} ({a.tile}² per tile),"
          f" {steps} steps; carrier torus {nx - 1}x{ny - 1}", flush=True)

    for line in wait_accuracy(a.latencies_ms):
        print(line, flush=True)
    struct, slopes = {}, {}
    for path in PATHS:
        cfg = path_cfg(path, nx, ny, steps)
        s = structure(path, cfg, px, py)
        if s is None:
            print(f"{path}: unavailable for this shape", flush=True)
            continue
        struct[path] = s
        print(f"{path}: exchange_critical_depth {s[0]}, exchange_batches {s[1]}"
              " (one pass, parallel/analysis.py)", flush=True)
        rows, sleeps = measure(path, cfg, mesh, device, a.latencies_ms, a.trials)
        for lat_ms, t_ms in rows:
            print(f"{path}: L={lat_ms:6.2f} ms  T_pass={t_ms:8.3f} ms", flush=True)
        slopes[path] = slope(rows)
        print(f"{path}: slope dT_pass/dL = {slopes[path]:.2f}; injected sleeps a pass"
              f" {sleeps:g}; depth {s[0]}, batches {s[1]}", flush=True)

    if "slab" not in struct or "overlap" not in struct:
        print("model: slab or overlap unavailable, no model", flush=True)
        return 1
    if a.hw_slab_gpts is not None:
        rates = {"slab": a.hw_slab_gpts, "overlap": a.hw_overlap_gpts}
        source = "--hw-slab-gpts / --hw-overlap-gpts"
    elif device.type == "cuda":
        rates = measure_rates(device, a.trials)
        source = (f"measured here, 2x2 mesh of {torch.cuda.get_device_name(device)}"
                  f" at {RATE_GRID}², chunks of {RATE_CHUNK} steps")
    else:
        print("model: no card figures (give --hw-slab-gpts and --hw-overlap-gpts, or"
              " run with --device cuda); the slopes above are the result", flush=True)
        return 0
    print(f"model: eff(L) = T_pass / (T_pass + n*L); rates {source}: "
          + ", ".join(f"{p} {r:.2f} Gpt/s" for p, r in rates.items()), flush=True)
    if not a.model_latency_us:
        print("model: no --model-latency-us, no eff(L) rows", flush=True)
    for line in model_lines(sorted({a.tile, 4096}), rates, a.model_latency_us, struct):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
