#!/usr/bin/env python3
"""Hardware conformance sweep of the PyTorch port: every kernel path x BC
class on the card, against a float64 oracle.

The port's counterpart of ``scripts/hw_conformance.py``, with its case
list and names.  ``chip_smoke.py`` holds each kernel to its plain version;
this holds each PATH (the kernel inside its advance, exchange and
staging) to the port's ``ops/step.py::reference_step`` run in float64 on
the CPU, which the tests hold to the JAX package:

  paths:  single (K1, build_single_device_advance) |
          sharded_multistep (K4) | sharded_overlap (K3) |
          sharded_perstep (K2, make_interior_step with kernel=pallas),
            each on a 2x2 mesh of the card, on grids it divides |
          carrier (K5: embed -> advance -> extract) |
          padded_perstep (K2 on the reference's remainder tiles,
            build_padded_advance, the driver's path where the carrier
            declines), both on a 3x3 mesh of the card
  BCs:    all-dirichlet | all-neumann | torus | mixed | one-sided-y |
          one-sided-x | both axes one-sided (four corner orientations) |
          reference-compat
  plus an odd grid, indivisible-carrier grids, k = 16, a wide grid and
  bf16 storage (the JAX list's names; some grids were chosen for TPU
  geometry, and on the card they are still valid shapes).

Every case grid is even, so a 2x2 mesh divides them all; the 3x3 mesh
is one they do not divide, so the carrier stages a real pad and the
remainder tiles are uneven.  A mesh path whose builder declines the case
has no row.

Prints one line per (case, path) and a final summary WITH THE EXECUTED
ROW COUNT; quote that number.  An exception in a path is a FAIL row, and
any FAIL exits 1.  ``--device`` is ``cuda`` (cuda:0, the default) or
``cpu`` (the kernels' plain versions); a missing card fails, never falls
back.  ``--grid-scale`` divides the fixed grids, so that a CPU run can
take them small.

Usage:  python scripts/torch_hw_conformance.py [--nx 512 --ny 256 --steps 16]
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import sys
from typing import Callable, Dict, List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from climate_sim_tpu_torch.config import BCConfig, BCType, SimConfig  # noqa: E402
from climate_sim_tpu_torch.ops.init import gaussian_hotspot  # noqa: E402
from climate_sim_tpu_torch.ops.step import (  # noqa: E402
    build_single_device_advance,
    make_interior_step,
    reference_step,
)
from climate_sim_tpu_torch.parallel.halo import (  # noqa: E402
    build_carrier_slab_advance,
    build_padded_advance,
    build_sharded_advance,
    build_sharded_multistep_advance,
    build_sharded_overlap_advance,
)
from climate_sim_tpu_torch.parallel.mesh import (  # noqa: E402
    divisible,
    gather_field,
    make_mesh,
    shard_field,
)

D, N, P = BCType.DIRICHLET, BCType.NEUMANN, BCType.PERIODIC
BCS = {
    "dirichlet4": (D, D, D, D),
    "neumann4": (N, N, N, N),
    "torus": (P, P, P, P),
    "mixed": (D, N, P, P),
    "one_sided_y": (P, P, P, D),
    "one_sided_x": (P, D, N, D),
    # all four corner orientations: the wrap patches differ per side
    "both_os_lb": (P, D, P, N),
    "both_os_rt": (D, P, N, P),
    "both_os_lt": (P, N, D, P),
    "both_os_rb": (N, P, P, D),
}
# bf16 storage (f32 arithmetic, one rounding per pass) against the f64
# oracle of the same cast IC: the per-step paths round every step, ~steps
# * 2^-9 of the scale (the JAX gate's bound, measured 2.9e-2 at 16 steps).
BF16_TOL = 4e-2


def cases(nx: int, ny: int, scale: int):
    """(name, BCs, nx, ny, mode): mode False, True (compat), "k16" or
    "bf16".  The JAX list; ``scale`` divides its fixed grids."""
    def g(n):
        return max(2, n // scale)

    out = [(name, bcs, nx, ny, False) for name, bcs in BCS.items()]
    out.append(("compat_mixed", BCS["mixed"], nx, ny, True))
    out.append(("odd_grid_mixed", BCS["mixed"], g(120), g(72), False))
    out.append(("carrier_mixed", BCS["mixed"], g(1000), g(504), False))
    out.append(("carrier_torus", BCS["torus"], g(1000), g(504), False))
    out.append(("k16_mixed", BCS["mixed"], g(1024), g(512), "k16"))
    out.append(("wide_knee_mixed", BCS["mixed"], g(6144), g(256), False))
    out.append(("carrier_os_y", (D, N, P, D), g(1000), g(504), False))
    out.append(("carrier_os_x", (D, P, N, D), g(1000), g(504), False))
    out.append(("bf16_mixed", BCS["mixed"], nx, ny, "bf16"))
    out.append(("bf16_dirichlet4", BCS["dirichlet4"], nx, ny, "bf16"))
    out.append(("bf16_os_y", (D, N, P, D), nx, ny, "bf16"))
    out.append(("carrier_byexp", BCS["mixed"], g(1000), g(1252), False))
    out.append(("carrier_byexp_t", BCS["torus"], g(1000), g(1252), False))
    out.append(("bf16_carrier", BCS["mixed"], g(1000), g(504), "bf16"))
    return out


def _run_tiles(adv, u, mesh, steps):
    return gather_field(adv(steps)(shard_field(u, mesh)), mesh)


def path_single(cfg, u, meshes, steps):
    return build_single_device_advance(cfg, cfg.dt, u.device)(steps)(u)


def path_sharded_multistep(cfg, u, meshes, steps):
    mesh = meshes["even"]
    if not divisible(mesh, cfg.nx, cfg.ny):
        return None
    return _run_tiles(build_sharded_multistep_advance(cfg, mesh, cfg.dt), u, mesh, steps)


def path_sharded_overlap(cfg, u, meshes, steps):
    mesh = meshes["even"]
    adv = build_sharded_overlap_advance(cfg, mesh, cfg.dt)
    return None if adv is None else _run_tiles(adv, u, mesh, steps)


def path_sharded_perstep(cfg, u, meshes, steps):
    mesh = meshes["even"]
    if not divisible(mesh, cfg.nx, cfg.ny):
        return None
    adv = build_sharded_advance(cfg, mesh, cfg.dt, make_interior_step(cfg, cfg.dt))
    return _run_tiles(adv, u, mesh, steps)


def path_carrier(cfg, u, meshes, steps):
    mesh = meshes["uneven"]
    car = build_carrier_slab_advance(cfg, mesh, cfg.dt)
    if car is None:
        return None
    return gather_field(car.extract(car(steps)(car.embed(u))))


def path_padded_perstep(cfg, u, meshes, steps):
    mesh = meshes["uneven"]
    return _run_tiles(build_padded_advance(cfg, mesh, cfg.dt), u, mesh, steps)


# name -> fn(cfg, IC on the device, {"even": 2x2, "uneven": 3x3}, steps):
# the field after ``steps`` steps, or None where the path takes no such case.
PATHS: Dict[str, Callable] = {
    "single": path_single,
    "sharded_multistep": path_sharded_multistep,
    "sharded_overlap": path_sharded_overlap,
    "sharded_perstep": path_sharded_perstep,
    "carrier": path_carrier,
    "padded_perstep": path_padded_perstep,
}


def oracle(u: torch.Tensor, cfg: SimConfig, steps: int) -> np.ndarray:
    """``steps`` of ``reference_step`` in float64 on the CPU."""
    r = u.detach().to("cpu", torch.float64)
    for _ in range(steps):
        r = reference_step(r, cfg, cfg.dt)
    return r.numpy()


def resolve(device: str) -> Optional[torch.device]:
    if device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", 0)


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--ny", type=int, default=256)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--tol", type=float, default=5e-5)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--grid-scale", type=int, default=1,
                    help="divide the fixed case grids by this (small CPU runs)")
    args = ap.parse_args(argv)

    device = resolve(args.device)
    if device is None:
        print("hw_conformance: --device=cuda but torch.cuda.is_available() is False",
              file=sys.stderr)
        return 2
    if device.type == "cpu":
        print("[hw_conformance] running on the CPU: this checks the paths with the"
              " kernels' plain versions, not the CUDA kernels", file=sys.stderr)
    meshes = {"even": make_mesh(2, 2, [device] * 4), "uneven": make_mesh(3, 3, [device] * 9)}

    failures = 0
    rows = 0
    for name, bcs, nx, ny, mode in cases(args.nx, args.ny, args.grid_scale):
        cfg = SimConfig(nx=nx, ny=ny, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                        steps=args.steps, out_every=args.steps, kernel="pallas",
                        strict_reference_compat=mode is True,
                        steps_per_pass=16 if mode == "k16" else 0)
        cfg.bc = BCConfig(*bcs)
        u = gaussian_hotspot(cfg, torch.float32)
        # park mass against edges so edge handling is visible
        u = u + 0.4 * torch.roll(u, ny // 2 - 2, 0) + 0.4 * torch.roll(u, nx // 2 - 2, 1)
        tol = args.tol
        if mode == "bf16":
            u = u.to(torch.bfloat16)  # the oracle sees the same cast IC
            tol = BF16_TOL
        ref = oracle(u, cfg, args.steps)
        scale = max(1.0, float(np.abs(ref).max()))
        u = u.to(device)

        for path, fn in PATHS.items():
            try:
                out = fn(dataclasses.replace(cfg), u, meshes, args.steps)
                if out is None:
                    continue
                if device.type == "cuda":
                    torch.cuda.synchronize(device)
                got = out.to("cpu", torch.float64).numpy()
                err = float(np.abs(got - ref).max()) / scale if got.shape == ref.shape \
                    else float("nan")
                ok = bool(np.isfinite(err) and err <= tol)
            except Exception as e:
                err, ok = float("nan"), False
                print(f"EXC  {name:16s} {path:18s} {type(e).__name__}: {e}", file=sys.stderr)
            status = "ok  " if ok else "FAIL"
            print(f"{status} {name:16s} {path:18s} rel_err={err:.2e}", flush=True)
            rows += 1
            failures += 0 if ok else 1

    print(f"hw_conformance: {rows} cases: "
          f"{'ALL OK' if not failures else f'{failures} FAILURES'}", flush=True)
    return 1 if failures else 0


if __name__ == "__main__":
    raise SystemExit(main())
