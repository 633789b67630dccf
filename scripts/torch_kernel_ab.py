"""Time the PyTorch port's kernels and its main path in several checkouts,
in turns, on one CUDA card.

    python3 scripts/torch_kernel_ab.py ROOT [ROOT ...]

Each ROOT is a checkout that holds ``climate_sim_tpu_torch/`` (this one, or
an unpacked ``git archive`` of another commit in a git-ignored directory).
List each ROOT as often as it is to be timed, in the order of the turns,
e.g. ``_scratch/parent . . _scratch/parent``.  For each ROOT in turn, a
fresh process imports that checkout's package (which builds its kernels
into its own ``_build/``) and times, f32 unless named, the launches of one
CUDA graph replay (``chip_smoke.graph_ms``: the card's time, not the
wrappers' host time):

* K1 on a 4096² field, bench BCs, k = 8, in float32, bfloat16 and float64,
  and at k = 8 on the smaller grids users run: 2048², 1024² and
  ``configs/dev.yaml``'s 512² in float32, ``configs/parity_f64.yaml``'s
  256² in float64;
* K2 on a 2050² padded tile, and ``conv2d`` computing the same function
  (the five weights, from the checkout's ``cuda_stencil.stencil_constants``,
  as a 3x3 cross, TF32 off) beside it;
* K3 on a 2048² region of a 2064² window, and on its 8-column band;
* K4 on a 2048² tile and its slabs, K5 on the 2009x2001 carrier tile of
  4001² on 2x2 (the corner tile's flags and true extent);

then runs ``configs/bench_4096.yaml`` through that checkout's CLI, 1000
steps, output off, and reads its ``throughput:`` line.  Each turn prints
one line ``TURN {json}`` with the times in ms and the rate in Gpoint/s;
the first line is the card's name and power limit from nvidia-smi.
Without a CUDA card the script exits non-zero.
"""

from __future__ import annotations

import importlib.util
import json
import os
import re
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def time_kernels(root: str) -> dict:
    """The kernel times of the package under ``root``, in this process."""
    sys.path.insert(0, root)
    import torch
    import torch.nn.functional as F

    import climate_sim_tpu_torch

    # This checkout's chip_smoke (its helpers import the package lazily, so
    # they reach the one under ``root``), not the one ``root`` may hold.
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(REPO, "chip_smoke.py"))
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from climate_sim_tpu_torch.ops import cuda_sharded as sh
    from climate_sim_tpu_torch.ops import cuda_stencil as cs

    if not climate_sim_tpu_torch.__file__.startswith(root):
        raise SystemExit(f"imported {climate_sim_tpu_torch.__file__}, not the one in {root}")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    def ms(fn, reps):
        return smoke.graph_ms(torch, dev, fn, reps)

    out = {}
    cfg = smoke.make_cfg(4096, 4096, "bench")
    base = smoke.edge_parked(torch, 4096, 4096, seed=7, device=dev)
    for name, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16),
                        ("float64", torch.float64)):
        u = base.to(dtype)
        out[f"K1_{name}"] = ms(lambda: cs.multistep_kernel_step(u, cfg, cfg.dt, 8), 100)
    for n, dtype in ((2048, torch.float32), (1024, torch.float32), (512, torch.float32),
                     (256, torch.float64)):
        ncfg = smoke.make_cfg(n, n, "bench")
        u = smoke.edge_parked(torch, n, n, seed=7, device=dev).to(dtype)
        out[f"K1_{n}_{str(dtype)[6:]}"] = ms(
            lambda: cs.multistep_kernel_step(u, ncfg, ncfg.dt, 8), 200)

    m, k, flags = 2048, 8, (1, 0, 1, 0)
    tcfg = smoke.make_cfg(2 * m, 2 * m, "bench")
    w = smoke.edge_parked(torch, m + 2 * k, m + 2 * k, seed=11, device=dev).to(torch.float32)
    tile, xh, yh = smoke.slabs(torch, w, k)
    up = w[k - 1:-(k - 1), k - 1:-(k - 1)].contiguous()
    cy, cx = smoke.CARRIER_TILE
    wc_ = smoke.edge_parked(torch, cy + 2 * k, cx + 2 * k, seed=12, device=dev).to(torch.float32)
    ctile, cxh, cyh = smoke.slabs(torch, wc_, k)
    f6 = (0, 1, 0, 1, *smoke.CARRIER_EDGE)
    wc, wxm, wxp, wym, wyp = cs.stencil_constants(tcfg, tcfg.dt).weights
    cross = torch.tensor([[0.0, wym, 0.0], [wxm, wc, wxp], [0.0, wyp, 0.0]],
                         dtype=torch.float32, device=dev)[None, None]
    torch.backends.cudnn.allow_tf32 = False
    out["K2"] = ms(lambda: sh.prepadded_kernel_step(up, tcfg, tcfg.dt), 500)
    out["conv2d"] = ms(lambda: F.conv2d(up[None, None], cross)[0, 0], 500)
    out["K3"] = ms(lambda: sh.tile_region_multistep(w, flags, tcfg, tcfg.dt, k, m, m), 200)
    out["K3_8_columns"] = ms(
        lambda: sh.tile_region_multistep(w, flags, tcfg, tcfg.dt, k, m, 8), 500)
    out["K4"] = ms(lambda: sh.sharded_tile_slab_multistep(tile, xh, yh, flags, tcfg,
                                                          tcfg.dt, k), 200)
    out["K5"] = ms(lambda: sh.carrier_tile_slab_multistep(ctile, cxh, cyh, f6, tcfg,
                                                          tcfg.dt, k), 200)
    return out


def run_cli(root: str) -> float:
    """Gpoint/s from the ``throughput:`` line of a 1000-step bench_4096 run
    through the CLI of the checkout under ``root``, output off."""
    proc = subprocess.run(
        [sys.executable, "-m", "climate_sim_tpu_torch", "--config=configs/bench_4096.yaml",
         "--steps=1000", "--output.enable=false"],
        cwd=root, capture_output=True, text=True, timeout=600, check=True,
    )
    m = re.search(r"^throughput: (\S+) Mpoint/s total", proc.stdout, re.M)
    if m is None:
        raise SystemExit(f"no throughput line from {root}:\n{proc.stdout}{proc.stderr}")
    return float(m.group(1)) / 1e3


def main(argv) -> int:
    if len(argv) == 3 and argv[1] == "--turn":
        root = os.path.abspath(argv[2])
        res = {"root": argv[2], **time_kernels(root)}
        res["throughput_gpoint_s"] = run_cli(root)
        print("TURN " + json.dumps(res), flush=True)
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("torch_kernel_ab: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0], flush=True)
    for root in argv[1:]:
        subprocess.run([sys.executable, os.path.abspath(__file__), "--turn", root],
                       check=True, timeout=1200)
    return 0


if __name__ == "__main__":
    raise SystemExit(main(sys.argv))
