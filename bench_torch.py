"""Headline benchmark of the PyTorch port: grid points a second on one
card, 4096² diffusion+advection (the counterpart of ``bench.py``).

    python3 bench_torch.py                  # cuda:0, the headline
    python3 bench_torch.py --device=cpu --nx 64 --ny 64 --chunk 10 --reps 2 --trials 1

Prints exactly ONE JSON line on stdout, ``bench.py``'s four keys in its
order:

  {"metric": ..., "value": N, "unit": "points/s", "vs_baseline": N}

The workload and window are ``bench.py``'s: ``bench_config`` at 4096²
(mixed BCs), the Gaussian IC in float32, ``build_single_device_advance``
in chunks of 100 steps (K1 passes on a card), 600 chained chunks a trial
(6e4 steps, 1.0e12 point updates), best of 3 trials, after one untimed
chunk that builds and loads the kernel library.  Trials are timed with
CUDA events (``climate_sim_tpu_torch/benchproto.py``).

``vs_baseline`` keeps ``bench.py``'s definition: the rate over one
step's memory line, the card's bandwidth over 8 bytes a point (a float32
read and write a step).  K1 does up to 8 steps a memory pass, so it may
exceed 1: it is a ratio, not a share of any bound.  The roofline share is
printed on stderr beside it: the least time the card could take for a
chunk (one read and one write of the field, or the stencil's operations
over every point and step at the float32 rate, whichever is longer; see
``benchproto.chunk_work``) over the measured time a chunk, at most 1.
The share of the K1 pass schedule's bound (each pass reading and writing
the field once) follows it, labelled as such: it moves with the steps a
pass the port chooses, so it is no roofline.

The bandwidth is the card's own, from ``benchproto.DEVICE_PEAKS``; a
card missing there stops the run.  On a machine without a card it exits
non-zero; ``--device=cpu`` runs the plain per-step path on the host
and prints ``vs_baseline: null`` (the host has no bandwidth figure).
``--nx --ny --chunk --reps --trials`` exist for small runs; their
defaults are ``bench.py``'s constants, and a run at another size names
its size in the metric.
"""

from __future__ import annotations

import argparse
import json
import sys

NX = NY = 4096
CHUNK = 100  # steps per chained program
REPS = 600  # timed chunks a trial -> 60000 steps
TRIALS = 3


def arg_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    ap.add_argument("--nx", type=int, default=NX)
    ap.add_argument("--ny", type=int, default=NY)
    ap.add_argument("--chunk", type=int, default=CHUNK)
    ap.add_argument("--reps", type=int, default=REPS)
    ap.add_argument("--trials", type=int, default=TRIALS)
    return ap


def metric_name(nx: int, ny: int) -> str:
    size = "4096sq" if (nx, ny) == (NX, NY) else f"{nx}x{ny}"
    return f"grid_points_per_s_per_chip_{size}_diffadv"


def main(argv=None) -> int:
    a = arg_parser().parse_args(argv)

    import torch

    from climate_sim_tpu_torch import benchproto
    from climate_sim_tpu_torch.ops import cuda_stencil
    from climate_sim_tpu_torch.ops.init import gaussian_hotspot
    from climate_sim_tpu_torch.ops.step import build_single_device_advance, select_kernel

    if a.device == "cuda":
        if not torch.cuda.is_available():
            print("bench_torch: --device=cuda but torch.cuda.is_available() is False",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)  # CUDA events record on its current stream
        name, n_devices = torch.cuda.get_device_name(device), torch.cuda.device_count()
        bw = benchproto.peaks(name).bytes_per_s  # an unknown card stops here
    else:
        device, name, n_devices, bw = torch.device("cpu"), "cpu", 1, None

    cfg = benchproto.bench_config(a.nx, a.ny, a.chunk)
    print(f"[bench] device={name} n={n_devices} kernel={select_kernel(cfg, device)}",
          file=sys.stderr)
    advance = build_single_device_advance(cfg, cfg.dt, device)
    if device.type == "cuda" and not advance.uses_kernel:
        raise RuntimeError("the advance on the card does not run K1")
    u = gaussian_hotspot(cfg, torch.float32, device)
    cuda_stencil.multistep_kernel_step.launches = 0
    best, _u = benchproto.time_best_of(advance(a.chunk), u, a.reps, a.trials)
    launches = cuda_stencil.multistep_kernel_step.launches

    steps = a.reps * a.chunk
    pts_per_s = a.nx * a.ny * steps / best
    value = round(pts_per_s, 1)
    line = bw / 8.0 if bw else None  # 8 bytes/point/step (f32 read+write)
    result = {
        "metric": metric_name(a.nx, a.ny),
        "value": value,
        "unit": "points/s",
        "vs_baseline": round(value / line, 4) if line else None,
    }
    print(f"[bench] {steps} steps in {best:.4f}s (best of {a.trials}) ->"
          f" {pts_per_s / 1e9:.2f} Gpoint/s", file=sys.stderr)
    if line:
        w = benchproto.chunk_work(cfg, a.chunk, torch.float32)
        chunk_s = best / a.reps
        print(f"[bench] vs_baseline {result['vs_baseline']}: x the one-step 8 B/point line"
              f" ({bw / 1e9:.0f} GB/s / 8 B = {line / 1e9:.2f} Gpoint/s), a ratio, not a"
              " share of any bound", file=sys.stderr)
        for label, nbytes in (("roofline", w.field_bytes),
                              (f"pass-schedule ({w.passes} passes)", w.pass_bytes)):
            bound, by = benchproto.bound_s(nbytes, w.flops, torch.float32, name)
            print(f"[bench] {label} bound of a {a.chunk}-step chunk: {nbytes:.4g} B,"
                  f" {w.flops:.4g} operations -> {bound * 1e3:.4f} ms ({by});"
                  f" {label.split()[0]} share={bound / chunk_s:.4f}", file=sys.stderr)
    else:
        print("[bench] vs_baseline null: the host has no bandwidth figure, so no bound",
              file=sys.stderr)
    print(f"[bench] K1 launches={launches}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
