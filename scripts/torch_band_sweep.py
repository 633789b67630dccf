"""Time the port's streaming core at several band geometries on one CUDA card.

    python3 scripts/torch_band_sweep.py [--k1-only]

The kernels' C entry points take the band width (window columns a block)
and the segment height (output rows a block) from their wrappers, which
take them from ``ops/cuda_stencil.py::band_geometry`` (K2-K5) and
``k1_geometry`` (K1).  This script calls the entry points directly with
other geometries, bench BCs, timing the launches of a CUDA graph replay
(``chip_smoke.graph_ms``), twice each:

* K1 (whose passes up to 8 steps run the wide body, ``WIDE_COLUMNS[dtype]``
  columns a thread) on a 4096² field at k = 8 in f32, bf16 and f64 and at
  k = 4 in f32, and on the smaller grids users run (2048² and 1024² f32,
  ``configs/dev.yaml``'s 512² f32, ``configs/parity_f64.yaml``'s 256²
  f64, k = 8): for every block of whole warps up to ``WIDE_THREADS``
  threads, with as many segments as fill 1, 2, 3, 4, 6 or 12 blocks an SM
  (up to ``WIDE_WARPS_PER_SM`` warps), and on grids up to 2048² also
  segments of 4, 8, 16 and 32 rows.  Each geometry's output is held bit
  for bit to that of ``k1_geometry``'s;
* K2 on a 2050² padded tile (one step), with ``conv2d`` computing the same
  function (the five weights as a 3x3 cross, TF32 off) beside it;
* K4 on a 2048² tile and its slabs at k = 8 (a corner tile's flags);

and, for each kernel, its wrapper at the default geometry, timed by graph
replay and by CUDA events around a loop of calls: where the loop's time
exceeds the replay's, the wrappers' host time a launch sets the pace.
Prints ``SWEEP <kernel> <width>x<rows>xc<cpt>: ms / ms`` lines (K1's with
its grid, dtype and k, its grid of blocks, the warps on the busiest SM,
its halo factor and ``wide_cost``), the default geometry marked, after
the card's name and power limit; ``--k1-only`` stops after K1.  The
one-column body is timed at these shapes by ``scripts/torch_kernel_ab.py``
on a checkout from before the wide body.  Without a CUDA card the script
exits non-zero.
"""

from __future__ import annotations

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# (grid side, dtype, k) of K1's cases.
K1_CASES = [(4096, "float32", 8), (4096, "bfloat16", 8), (4096, "float64", 8),
            (4096, "float32", 4), (2048, "float32", 8), (1024, "float32", 8),
            (512, "float32", 8), (256, "float64", 8)]
GEOMETRIES = {
    "K2": [(256, 16), (128, 32), (128, 16), (128, 8), (96, 16), (64, 16)],
    "K4": [(256, 40), (128, 96), (128, 64), (128, 48), (96, 64), (64, 64)],
}


def main(argv) -> int:
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

    for n, dname, k in K1_CASES:
        cfg = smoke.make_cfg(n, n, "bench")
        weights, fixes = cs.stencil_constants(cfg, cfg.dt)
        dtype = getattr(torch, dname)
        u = smoke.edge_parked(torch, n, n, seed=7, device=dev).to(dtype)
        o1 = torch.empty_like(u)
        default = cs.k1_geometry(n, n, k, dtype)
        cpt = default.cpt
        geos = [default]
        for t in range(32, cs.WIDE_THREADS + 1, 32):
            width = t * cpt
            if width <= 2 * k:
                continue
            bands = -(-n // (width - 2 * k))
            heights = [-(-n // max(1, min(n // cs.WIDE_MIN_ROWS, cs.SMS * m // bands)))
                       for m in (1, 2, 3, 4, 6, 12) if m * t <= cs.WIDE_WARPS_PER_SM * 32]
            if n <= 2048:
                heights += [4, 8, 16, 32]
            for rows in heights:
                g = cs.K1Geometry(width, rows, bands, -(-n // rows), cpt)
                if g not in geos:
                    geos.append(g)
        for g in geos:
            def launch(g=g):
                return lib.climate_multistep_stencil(
                    u.data_ptr(), o1.data_ptr(), n, n, k, cs._DTYPE_CODES[dtype],
                    *weights, *fixes, 0.0, g.width, g.rows, stream())
            err = launch()
            if err:
                raise SystemExit(f"K1 {n}² {dname} k={k} {g}: CUDA error {err}")
            torch.cuda.synchronize(dev)
            if g is default:
                first = o1.clone()
            same = "same bits" if torch.equal(o1, first) else (
                f"DIFFERS by {float((o1.double() - first.double()).abs().max()):.3g}")
            t = [smoke.graph_ms(torch, dev, launch, 100) for _ in range(2)]
            halo = g.bands * g.width * g.segments * (g.rows + 2 * k) / n**2
            warps = -(-g.bands * g.segments // cs.SMS) * (g.width // cpt // 32)
            mark = " (default)" if g is default else ""
            print(f"SWEEP K1 {n}² {dname} k={k} {g.width}x{g.rows}xc{cpt}{mark}: {t[0]:.4f} /"
                  f" {t[1]:.4f} ms; {g.bands}x{g.segments} blocks, {warps} warps an SM,"
                  f" halo x{halo:.3f}, cost {cs.wide_cost(g, k)}; {same}", flush=True)
        t = [timer(torch, dev, lambda: cs.multistep_kernel_step(u, cfg, cfg.dt, k), 100)
             for timer in (smoke.graph_ms, smoke.events_ms, smoke.events_ms, smoke.graph_ms)]
        print(f"SWEEP K1 {n}² {dname} k={k} wrapper at {default.width}x{default.rows}xc"
              f"{cpt}: graph replay {t[0]:.4f} / {t[3]:.4f} ms, events around a loop"
              f" of calls {t[1]:.4f} / {t[2]:.4f} ms", flush=True)
    if "--k1-only" in argv:
        return 0
    cfg = smoke.make_cfg(4096, 4096, "bench")
    weights, fixes = cs.stencil_constants(cfg, cfg.dt)
    up = smoke.edge_parked(torch, 2050, 2050, seed=3, device=dev).float()
    o2 = torch.empty((2048, 2048), device=dev)
    w = smoke.edge_parked(torch, 2064, 2064, seed=11, device=dev).float()
    tile, xh, yh = smoke.slabs(torch, w, 8)
    o4 = torch.empty_like(tile)
    direct = {
        "K2": lambda g: lambda: lib.climate_prepadded_step(
            up.data_ptr(), o2.data_ptr(), 2048, 2048, 0, *weights, *g, stream()),
        "K4": lambda g: lambda: lib.climate_slab_multistep(
            tile.data_ptr(), xh.data_ptr(), yh.data_ptr(), o4.data_ptr(), 2048, 2048, 8, 8, 0,
            *weights, *fixes, 1, 0, 1, 0, 0.0, *g, stream()),
    }
    wrapper = {
        "K2": lambda: sh.prepadded_kernel_step(up, cfg, cfg.dt),
        "K4": lambda: sh.sharded_tile_slab_multistep(tile, xh, yh, (1, 0, 1, 0), cfg, cfg.dt, 8),
    }
    defaults = {"K2": cs.band_geometry(2048, 2048, 1)[:2],
                "K4": cs.band_geometry(2048, 2048, 8)[:2]}
    reps = {"K2": 500, "K4": 200}
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
    raise SystemExit(main(sys.argv[1:]))
