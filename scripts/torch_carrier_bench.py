#!/usr/bin/env python3
"""Carrier-path throughput of the PyTorch port on one card (a 1x1 mesh).

The port's counterpart of ``scripts/carrier_bench.py``: the carrier path
(K5, one launch a tile and pass, the true edge at runtime flags) on a 1x1
mesh of the card at each size, and with ``--single`` the single-device
path (K1) on the same grid, for comparison.  The JAX package pads a 1x1
carrier to its TPU alignment; the port plans with no alignment, so on one
tile the carrier is the grid itself and the rate is K5's own per-tile cost
with its staging a pass.  On the card each chunk is one replay of a
captured CUDA graph, as the driver runs it
(``climate_sim_tpu_torch/runtime/graphs.py``).

The timing is the port's protocol (``climate_sim_tpu_torch/benchproto.py``):
chunks of ``--chunk`` steps, ``--reps`` chained chunks a window (0: scaled
to a window of 2e11 point updates), the best of ``--trials`` windows timed
with CUDA events; true points only.  With ``--single``, a last line gives
the largest difference between the two paths' fields after one chunk from
the same IC.

Runs on cuda:0 unless ``--device=cpu`` is given (the kernels' plain
versions: the rates mean nothing there); without a card it exits nonzero.

Usage:  python scripts/torch_carrier_bench.py [--sizes 4000 5000]
        [--bc mixed|torus|one_sided_y|one_sided_x] [--chunk 2000 --reps 0]
        [--single] [--precision f32|bf16] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--sizes", type=int, nargs="+", default=[4000, 5000])
    ap.add_argument("--bc", default="mixed",
                    choices=["mixed", "torus", "one_sided_y", "one_sided_x"])
    ap.add_argument("--chunk", type=int, default=2000)
    ap.add_argument("--reps", type=int, default=0,
                    help="chained chunks a window; 0 = a window of 2e11 point updates")
    ap.add_argument("--trials", type=int, default=3)
    ap.add_argument("--steps-per-pass", type=int, default=0)
    ap.add_argument("--single", action="store_true",
                    help="also time the single-device path on the same grid")
    ap.add_argument("--precision", default="f32", choices=["f32", "bf16"],
                    help="bf16 = storage mode")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)

    import torch

    from climate_sim_tpu_torch.benchproto import auto_reps, bench_config, time_best_of, warm_up
    from climate_sim_tpu_torch.config import BCConfig, BCType
    from climate_sim_tpu_torch.ops.init import gaussian_hotspot
    from climate_sim_tpu_torch.ops.step import build_single_device_advance
    from climate_sim_tpu_torch.parallel.halo import build_carrier_slab_advance
    from climate_sim_tpu_torch.parallel.mesh import gather_field, make_mesh

    if a.device == "cuda":
        if not torch.cuda.is_available():
            print("carrier_bench: --device=cuda but torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
    else:
        device = torch.device("cpu")
    D, N, P = BCType.DIRICHLET, BCType.NEUMANN, BCType.PERIODIC
    bcs = {
        "mixed": (D, N, D, N),
        "torus": (P, P, P, P),
        "one_sided_y": (D, N, P, D),
        "one_sided_x": (D, P, N, D),
    }[a.bc]
    dtype = torch.bfloat16 if a.precision == "bf16" else torch.float32

    mesh = make_mesh(1, 1, [device])
    for n in a.sizes:
        reps = a.reps or auto_reps(n, n, a.chunk)
        cfg = dataclasses.replace(bench_config(n, n, a.chunk), kernel="pallas",
                                  steps_per_pass=a.steps_per_pass)
        cfg.bc = BCConfig(*bcs)
        adv = build_carrier_slab_advance(cfg, mesh, cfg.dt)
        if adv is None:
            print(f"{n}^2 {a.bc}: carrier unavailable", flush=True)
            continue
        u0 = gaussian_hotspot(cfg, dtype, device)
        fn = adv(a.chunk)
        first = warm_up(fn, adv.embed(u0))
        best, _ = time_best_of(fn, first, reps, a.trials)
        g = n * n * a.chunk * reps / best / 1e9
        ncy, ncx = adv.carrier_shape
        print(f"{n}^2 {a.bc}: carrier {g:.2f} Gpt/s "
              f"(carrier {ncx}x{ncy}, reps={reps})", flush=True)
        if a.single:
            s = build_single_device_advance(cfg, cfg.dt, device)(a.chunk)
            s_first = warm_up(s, u0)
            bs, _ = time_best_of(s, s_first, reps, a.trials)
            print(f"{n}^2 {a.bc}: single  "
                  f"{n * n * a.chunk * reps / bs / 1e9:.2f} Gpt/s", flush=True)
            diff = (gather_field(adv.extract(first), mesh).to(torch.float64)
                    - s_first.to(torch.float64)).abs().max()
            print(f"{n}^2 {a.bc}: carrier vs single, field after one chunk: max abs diff"
                  f" {float(diff):.3g}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
