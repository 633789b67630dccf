#!/usr/bin/env python3
"""bf16 storage mode of the PyTorch port: error growth against f32, and
throughput.

The port's counterpart of ``scripts/bf16_study.py``.  ``precision: bf16``
keeps the field in bf16 and computes in f32; on a card K1 rounds once a
pass, on JAX's ``pick_steps_per_pass`` schedule, so the port rounds at the
steps the JAX kernel rounds at.  Two readings:

1. error growth: max-abs and relative-L2 error of the bf16 run against
   the f32 run from the SAME bf16-cast IC, per BC class, at each horizon;
   both evolve through ``build_single_device_advance`` in chunks of at
   most 2000 steps;
2. throughput: grid points a second at ``--perf-size``² for f32 and bf16
   over ``--perf-steps`` steps in 2000-step chunks, with the port's
   protocol (``climate_sim_tpu_torch/benchproto.py``: one warm-up chunk,
   then the best of 3 windows timed with CUDA events).

Runs on cuda:0 (K1) unless ``--device=cpu`` is given; there the kernel is
not selected and each step runs torch ops with one bf16 rounding a step,
as the JAX script does on the CPU.  Without a card ``--device=cuda`` exits
nonzero.

Usage:  python scripts/torch_bf16_study.py [--horizons 1000 10000 60000]
        [--err-size 1024] [--perf-size 4096] [--perf-steps 6000]
        [--skip-perf] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional, Tuple

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CHUNK = 2000


def bc_classes():
    from climate_sim_tpu_torch.config import BCType

    D, N, P = BCType.DIRICHLET, BCType.NEUMANN, BCType.PERIODIC
    return {
        "dirichlet4": (D, D, D, D),
        "torus": (P, P, P, P),
        "mixed": (D, N, P, P),
        "one_sided_y": (P, P, P, D),
    }


def cfg_for(bcs, n: int, steps: int, kernel: str = "auto"):
    from climate_sim_tpu_torch.config import BCConfig, SimConfig

    cfg = SimConfig(nx=n, ny=n, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                    steps=steps, out_every=min(steps, CHUNK), kernel=kernel)
    cfg.bc = BCConfig(*bcs)
    return cfg


def evolve(u0, cfg, steps: int, device):
    """``u0`` advanced ``steps`` steps in chunks of at most 2000, as a
    float64 numpy array."""
    import numpy as np
    import torch

    from climate_sim_tpu_torch.ops.step import build_single_device_advance

    adv = build_single_device_advance(cfg, cfg.dt, device)
    u, n = u0, 0
    while n < steps:
        kk = min(CHUNK, steps - n)
        u = adv(kk)(u)
        n += kk
    return np.asarray(u.to(torch.float64).cpu().numpy())


def error_row(bcs, n: int, steps: int, device) -> Tuple[float, float, float]:
    """(max abs error, relative L2 error, max |f32|) of the bf16 run
    against the f32 run from the same bf16-cast IC."""
    import numpy as np
    import torch

    from climate_sim_tpu_torch.ops.init import gaussian_hotspot

    cfg = cfg_for(bcs, n, steps)
    u_b = gaussian_hotspot(cfg, torch.bfloat16, device)
    f = evolve(u_b.to(torch.float32), cfg, steps, device)
    b = evolve(u_b, cfg, steps, device)
    d = np.abs(b - f)
    rel_l2 = float(np.sqrt((d ** 2).sum() / max((f ** 2).sum(), 1e-30)))
    return float(d.max()), rel_l2, float(np.abs(f).max())


def perf(n: int, steps: int, device) -> List[Tuple[str, float]]:
    """[(precision, Gpoint/s)] for f32 and bf16 at n², mixed BCs."""
    import torch

    from climate_sim_tpu_torch.benchproto import time_best_of
    from climate_sim_tpu_torch.ops.init import gaussian_hotspot
    from climate_sim_tpu_torch.ops.step import build_single_device_advance

    cfg = cfg_for(bc_classes()["mixed"], n, steps)
    out = []
    for prec, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        u0 = gaussian_hotspot(cfg, dtype, device)
        adv = build_single_device_advance(cfg, cfg.dt, device)
        best, _ = time_best_of(adv(CHUNK), u0, max(1, steps // CHUNK), 3)
        out.append((prec, n * n * steps / best / 1e9))
    return out


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--horizons", type=int, nargs="+", default=[1000, 10000, 60000])
    ap.add_argument("--err-size", type=int, default=1024)
    ap.add_argument("--perf-size", type=int, default=4096)
    ap.add_argument("--perf-steps", type=int, default=6000)
    ap.add_argument("--skip-perf", action="store_true")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)

    import torch

    if a.device == "cuda":
        if not torch.cuda.is_available():
            print("bf16_study: --device=cuda but torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        kind = torch.cuda.get_device_name(device)
    else:
        device = torch.device("cpu")
        kind = "cpu"

    print(f"device={kind}  err grid {a.err_size}^2, horizons {a.horizons}")
    print(f"{'bc':12s} {'steps':>6s} {'max_abs_err':>12s} {'rel_l2':>10s} {'f32_max':>9s}")
    for name, bcs in bc_classes().items():
        for steps in a.horizons:
            err, rel_l2, fmax = error_row(bcs, a.err_size, steps, device)
            print(f"{name:12s} {steps:6d} {err:12.3e} {rel_l2:10.3e} {fmax:9.3e}", flush=True)

    if a.skip_perf:
        return 0
    for prec, g in perf(a.perf_size, a.perf_steps, device):
        print(f"perf {prec}: {g:.2f} Gpt/s at {a.perf_size}^2 "
              f"({a.perf_steps} steps, best of 3)", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
