"""Time the port's streaming core at several band geometries on one CUDA card.

    python3 scripts/torch_band_sweep.py

The kernels' C entry points take the band width (threads a block) and the
segment height (output rows a block) from their wrappers, which take them
from ``ops/cuda_stencil.py::band_geometry``.  This script calls the entry
points directly with other geometries, on the shapes of the main paths,
f32, bench BCs, timing the launches of a CUDA graph replay
(``chip_smoke.graph_ms``), twice each:

* K1 on a 4096² field at k = 8;
* K2 on a 2050² padded tile (one step), with ``conv2d`` computing the same
  function (the five weights as a 3x3 cross, TF32 off) beside it;
* K4 on a 2048² tile and its slabs at k = 8 (a corner tile's flags);

and, for each kernel, its wrapper at the default geometry, timed by graph
replay and by CUDA events around a loop of calls: where the loop's time
exceeds the replay's, the wrappers' host time a launch sets the pace.
Prints ``SWEEP <kernel> <width>x<rows>: ms / ms`` lines, the default
geometry marked, after the card's name and power limit.  Without a CUDA
card the script exits non-zero.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GEOMETRIES = {
    "K1": [(256, 128), (256, 64), (128, 128), (128, 96), (128, 64), (128, 48), (96, 64),
           (64, 64)],
    "K2": [(256, 16), (128, 32), (128, 16), (128, 8), (96, 16), (64, 16)],
    "K4": [(256, 40), (128, 96), (128, 64), (128, 48), (96, 64), (64, 64)],
}


def main() -> int:
    sys.path.insert(0, REPO)
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("torch_band_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from climate_sim_tpu_torch.ops import cuda_sharded as sh
    from climate_sim_tpu_torch.ops import cuda_stencil as cs
    from climate_sim_tpu_torch.ops._build import load_library

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    lib = load_library().lib

    def stream():  # the current stream: a graph capture swaps in its own
        return torch.cuda.current_stream(dev).cuda_stream

    cfg = smoke.make_cfg(4096, 4096, "bench")
    weights = cs._stencil_weights(cfg.dt, cfg.D, cfg.vx, cfg.vy, cfg.dx, cfg.dy)
    fixes = sh._fixes(cfg)

    u = smoke.edge_parked(torch, 4096, 4096, seed=7, device=dev).float()
    o1 = torch.empty_like(u)
    up = smoke.edge_parked(torch, 2050, 2050, seed=3, device=dev).float()
    o2 = torch.empty((2048, 2048), device=dev)
    w = smoke.edge_parked(torch, 2064, 2064, seed=11, device=dev).float()
    tile, xh, yh = smoke.slabs(torch, w, 8)
    o4 = torch.empty_like(tile)
    direct = {
        "K1": lambda g: lambda: lib.climate_multistep_stencil(
            u.data_ptr(), o1.data_ptr(), 4096, 4096, 8, 0, *weights, *fixes, 0.0, *g, stream()),
        "K2": lambda g: lambda: lib.climate_prepadded_step(
            up.data_ptr(), o2.data_ptr(), 2048, 2048, 0, *weights, *g, stream()),
        "K4": lambda g: lambda: lib.climate_slab_multistep(
            tile.data_ptr(), xh.data_ptr(), yh.data_ptr(), o4.data_ptr(), 2048, 2048, 8, 8, 0,
            *weights, *fixes, 1, 0, 1, 0, 0.0, *g, stream()),
    }
    wrapper = {
        "K1": lambda: cs.multistep_kernel_step(u, cfg, cfg.dt, 8),
        "K2": lambda: sh.prepadded_kernel_step(up, cfg, cfg.dt),
        "K4": lambda: sh.sharded_tile_slab_multistep(tile, xh, yh, (1, 0, 1, 0), cfg, cfg.dt, 8),
    }
    defaults = {"K1": cs.band_geometry(4096, 4096, 8)[:2],
                "K2": cs.band_geometry(2048, 2048, 1)[:2],
                "K4": cs.band_geometry(2048, 2048, 8)[:2]}
    reps = {"K1": 100, "K2": 500, "K4": 200}
    for name, geos in GEOMETRIES.items():
        for g in geos:
            err = direct[name](g)()
            if err:
                raise SystemExit(f"{name} {g}: CUDA error {err}")
            t = [smoke.graph_ms(torch, dev, direct[name](g), reps[name]) for _ in range(2)]
            mark = " (default)" if tuple(g) == tuple(defaults[name]) else ""
            print(f"SWEEP {name} {g[0]}x{g[1]}{mark}: {t[0]:.4f} / {t[1]:.4f} ms", flush=True)
        t = [timer(torch, dev, wrapper[name], reps[name])
             for timer in (smoke.graph_ms, smoke.events_ms, smoke.events_ms, smoke.graph_ms)]
        print(f"SWEEP {name} wrapper at {defaults[name][0]}x{defaults[name][1]}: graph replay"
              f" {t[0]:.4f} / {t[3]:.4f} ms, events around a loop of calls"
              f" {t[1]:.4f} / {t[2]:.4f} ms", flush=True)
    torch.backends.cudnn.allow_tf32 = False
    wc, wxm, wxp, wym, wyp = weights
    cross = torch.tensor([[0.0, wym, 0.0], [wxm, wc, wxp], [0.0, wyp, 0.0]],
                         dtype=torch.float32, device=dev)[None, None]
    t = [smoke.graph_ms(torch, dev, lambda: F.conv2d(up[None, None], cross), 500)
         for _ in range(2)]
    print(f"SWEEP conv2d on the 2050² padded tile: {t[0]:.4f} / {t[1]:.4f} ms", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
