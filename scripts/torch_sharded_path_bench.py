#!/usr/bin/env python3
"""Per-tile throughput of the PyTorch port's mesh paths on one card.

The port's counterpart of ``scripts/sharded_path_bench.py``.  A 1x1 mesh
of the card (``make_mesh(1, 1, [device])``) runs each mesh path's whole
machinery (the exchange, the band windows, the per-tile launches) with no
neighbour: a size-1 axis delivers each tile its own part and copies
nothing.  So a path's rate here is its own per-tile cost, kernels plus the
host's work per pass, without the exchange between tiles; beside K1's rate
in the same process, the difference is that host work a pass.

Paths timed at --nx/--ny per tile (default 4096²), bench_config's mixed
BCs, f32, the kernels selected (``kernel=pallas``):

  single    build_single_device_advance (K1, no mesh): the ceiling
  slab      build_sharded_multistep_advance (K4, one slab exchange a pass)
  overlap   build_sharded_overlap_advance (K3: interior + 4 bands a pass)
  perstep   build_sharded_advance with make_interior_step (K2, the width-1
            exchange every step); the JAX script's perstep times its
            default interior step instead, jnp ops

The timing is the port's protocol (``climate_sim_tpu_torch/benchproto.py``):
chunks of ``--chunk`` steps, ``--reps`` chained chunks a window (0: scaled
to a window of 2e11 point updates, as in the JAX script), the best of
``--trials`` windows timed with CUDA events.  After the rates, each path's
ratio to ``single``, the time a pass it adds to K1's, and the largest
difference of its field from single's after one chunk from the same IC.

Runs on cuda:0 unless ``--device=cpu`` is given (the kernels' plain
versions: the rates mean nothing there); without a card it exits nonzero.

Usage:  python scripts/torch_sharded_path_bench.py [--nx 4096 --ny 4096]
        [--chunk 2000] [--reps 0] [--trials 3]
        [--paths single slab overlap perstep] [--bc bench] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Dict, List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

PATHS = ("single", "slab", "overlap", "perstep")


def bench_cfg(nx: int, ny: int, chunk: int, bc: str = "bench"):
    """``bench_config`` with the kernels selected and ``bc``'s BC class."""
    from climate_sim_tpu_torch.benchproto import bench_config
    from climate_sim_tpu_torch.config import BCConfig, BCType

    cfg = dataclasses.replace(bench_config(nx, ny, chunk), kernel="pallas")
    if bc != "bench":
        D, N, P = BCType.DIRICHLET, BCType.NEUMANN, BCType.PERIODIC
        cfg.bc = BCConfig(*{
            "dirichlet": (D, D, D, D),
            "one_sided_y": (D, N, P, D),
            "one_sided_x": (P, D, N, D),
            "both_one_sided": (P, D, P, N),
        }[bc])
    return cfg


def build(path: str, cfg, mesh, device):
    """(advance, initial state) of ``path``, or (None, None) where the path
    declines the shape."""
    import torch

    from climate_sim_tpu_torch.ops.init import gaussian_hotspot
    from climate_sim_tpu_torch.ops.step import build_single_device_advance, make_interior_step
    from climate_sim_tpu_torch.parallel import halo
    from climate_sim_tpu_torch.parallel.mesh import shard_field

    u0 = gaussian_hotspot(cfg, torch.float32, device)
    if path == "single":
        return build_single_device_advance(cfg, cfg.dt, device), u0
    if path == "slab":
        adv = halo.build_sharded_multistep_advance(cfg, mesh, cfg.dt)
    elif path == "overlap":
        adv = halo.build_sharded_overlap_advance(cfg, mesh, cfg.dt)
    else:
        adv = halo.build_sharded_advance(cfg, mesh, cfg.dt, make_interior_step(cfg, cfg.dt))
    if adv is None:
        return None, None
    return adv, shard_field(u0, mesh)


def measure(cfg, paths, chunk: int, reps: int, trials: int, device
            ) -> Dict[str, Optional[Tuple[float, float, object, int]]]:
    """{path: (Gpoint/s, seconds of one chunk, field after one chunk from
    the IC as one tensor, passes a chunk)}, None for a path that declines
    the shape."""
    from climate_sim_tpu_torch.benchproto import time_best_of, warm_up
    from climate_sim_tpu_torch.parallel.mesh import gather_field, make_mesh

    mesh = make_mesh(1, 1, [device])
    out = {}
    for path in paths:
        adv, u0 = build(path, cfg, mesh, device)
        if adv is None:
            out[path] = None
            continue
        fn = adv(chunk)
        first = warm_up(fn, u0)
        best, _ = time_best_of(fn, first, reps, trials)
        field = first if path == "single" else gather_field(first, mesh)
        out[path] = (cfg.nx * cfg.ny * chunk * reps / best / 1e9, best / reps, field,
                     adv.pass_count(chunk))
    return out


def compare_lines(results) -> List[str]:
    """Each path beside ``single``: the rate's ratio, the ms a pass added
    to K1's (the path's own passes a chunk), and the largest difference of
    its field after one chunk."""
    single = results.get("single")
    if single is None:
        return []
    lines = []
    for path, res in results.items():
        if path == "single" or res is None:
            continue
        passes = res[3]
        gap_ms = (res[1] - single[1]) * 1e3 / passes
        err = float((res[2] - single[2]).abs().max())
        lines.append(f"{path} vs single: {res[0] / single[0]:.3f}x, {gap_ms:.4f} ms a pass"
                     f" more ({passes} passes a chunk); field after one chunk: max abs"
                     f" diff {err:.3g}")
    return lines


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--ny", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=0,
                    help="chained chunks a window; 0 = a window of 2e11 point updates")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--paths", nargs="+", default=list(PATHS), choices=PATHS)
    ap.add_argument("--bc", default="bench",
                    choices=["bench", "dirichlet", "one_sided_y", "one_sided_x",
                             "both_one_sided"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)

    import torch

    from climate_sim_tpu_torch.benchproto import auto_reps

    if a.device == "cuda":
        if not torch.cuda.is_available():
            print("sharded_path_bench: --device=cuda but torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    cfg = bench_cfg(a.nx, a.ny, a.chunk, a.bc)
    reps = a.reps or auto_reps(a.nx, a.ny, a.chunk)
    if "perstep" in a.paths:
        print("[bench] perstep times make_interior_step with kernel=pallas: one K2 launch"
              " a tile and step", file=sys.stderr)
    results = measure(cfg, a.paths, a.chunk, reps, a.trials, device)
    for path, res in results.items():
        if res is None:
            print(f"{path}: unavailable for this shape", flush=True)
        else:
            print(f"{path}: {res[0]:.2f} Gpt/s/shard (reps={reps})", flush=True)
    for line in compare_lines(results):
        print(line, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
