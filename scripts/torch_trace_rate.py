#!/usr/bin/env python3
"""Device-side sustained throughput of the PyTorch port from a profiler
trace.

The port's counterpart of ``scripts/trace_rate.py``: capture a
``torch.profiler`` trace around ``reps`` chained chunks of the port's
single-device advance (K1 on a card) at ``bench_config`` (4096², chunks of
100 steps, 3 chunks by default), then read the chunks straight from the
device timeline: the kernel events (``cat == "kernel"``), or, on the CPU
only, the plain version's top-level operator events (``cat == "cpu_op"``);
a card's trace without kernel events (no CUPTI) is an error, and so is
one whose stencil kernel events differ from the launches the kernel
wrappers counted in its chunks: the tracer lost launches in some calls,
so such a trace is taken again, up to three times in all.
Every chunk issues the same launches, so the events, in time order, split
into ``reps`` equal runs, one a chunk.  A chunk's time is the device's time
for it, its kernels' summed durations, as the JAX tool reads a chunk's
program duration; the rate is computed from it, so it is a kernel-time
rate and cannot show the card idle inside a chunk.  The chunk's span, from
its first event's start to its last one's end, is printed beside it: the
profiler adds host time to every launch, and where that outruns a kernel
the card idles inside the span (K1 at bench_4096 on an NVIDIA H100 80GB
HBM3 at 700 W: busy about half of it when the trace started at the
chunks, 98.6-98.8% after the warm-up step); the busy share printed beside the
span is the only reading of that idle time, and it is the profiler's, not
the unprofiled run's.

Usage:
    python scripts/torch_trace_rate.py --nx 4096 --ny 4096 [--chunk 100 --reps 3]
    python scripts/torch_trace_rate.py --analyze_only DIR_OR_TRACE.json --reps N
Prints one line per metric: ms/chunk, the device's Gpoint/s from its
kernel time, max inter-chunk gap, and the chunk's span with the device's
busy share of it.
``--device`` is ``cuda`` (cuda:0, the default) or ``cpu``; a missing card
fails, never falls back.
"""

from __future__ import annotations

import argparse
import dataclasses
import glob
import json
import os
import sys
import tempfile
from typing import List, Optional

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


TRIES = 3


def stencil_launches() -> int:
    """The stencil kernel's launches counted so far by K1-K5's wrappers."""
    from climate_sim_tpu_torch.ops.cuda_stencil import multistep_kernel_step
    from climate_sim_tpu_torch.parallel.halo import _CHUNK_WRAPPERS

    return multistep_kernel_step.launches + sum(fn.launches for fn in _CHUNK_WRAPPERS)


def stencil_events(trace_path: str) -> int:
    """The stencil kernel's events in a chrome trace."""
    from climate_sim_tpu_torch.parallel.halo import CHUNK_KERNEL

    with open(trace_path) as f:
        return sum(1 for e in json.load(f)["traceEvents"]
                   if e.get("cat") == "kernel" and CHUNK_KERNEL in e.get("name", ""))


def capture(nx: int, ny: int, chunk: int, reps: int, trace_path: str,
            bc: str = "bench", device: str = "cuda") -> int:
    """Write a chrome trace of ``reps`` chained ``chunk``-step calls of the
    advance, after one untimed chunk (the kernel library's build and load)
    and ``reps`` more in the profiler's warm-up step, which is traced and
    dropped.  Returns the stencil launches the traced chunks counted."""
    import torch

    from climate_sim_tpu_torch.benchproto import bench_config, sync, warm_up
    from climate_sim_tpu_torch.config import BCConfig, BCType
    from climate_sim_tpu_torch.ops.init import gaussian_hotspot
    from climate_sim_tpu_torch.ops.step import build_single_device_advance

    dev = torch.device("cuda", 0) if device == "cuda" else torch.device("cpu")
    cfg = dataclasses.replace(bench_config(nx, ny, chunk), kernel="pallas")
    D, N, P = BCType.DIRICHLET, BCType.NEUMANN, BCType.PERIODIC
    if bc != "bench" and not bc.startswith("carrier"):
        cfg.bc = BCConfig(*{
            "dirichlet": (D, D, D, D),
            "torus": (P, P, P, P),
            "one_sided_y": (D, N, P, D),
            "one_sided_x": (P, D, N, D),
            "both_one_sided": (P, D, P, N),
        }[bc])
    if bc.startswith("carrier"):
        # the carrier path on a 2x2 mesh of the card (a grid 2x2 does not
        # divide); bc "carrier" = mixed D/N, "carrier_torus" = periodic^4
        from climate_sim_tpu_torch.parallel.halo import build_carrier_slab_advance
        from climate_sim_tpu_torch.parallel.mesh import make_mesh

        cfg.bc = BCConfig(*((P, P, P, P) if bc == "carrier_torus" else (D, N, D, N)))
        adv = build_carrier_slab_advance(cfg, make_mesh(2, 2, [dev] * 4), cfg.dt)
        if adv is None:
            raise SystemExit(f"carrier unavailable for {nx}x{ny}")
        fn = adv(chunk)
        u = adv.embed(gaussian_hotspot(cfg, torch.float32, dev))
    else:
        fn = build_single_device_advance(cfg, cfg.dt, dev)(chunk)
        u = gaussian_hotspot(cfg, torch.float32, dev)
    u = warm_up(fn, u)

    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=activities,
            schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
            on_trace_ready=lambda p: p.export_chrome_trace(trace_path)) as prof:
        for _ in range(2):
            before = stencil_launches()
            for _ in range(reps):
                u = fn(u)
            sync(u)
            launched = stencil_launches() - before
            prof.step()
    return launched


def device_events(events: List[dict], device: str = "cuda"):
    """("kernel", the kernel events) when the trace has any; else, for a
    CPU trace, ("cpu_op", the operator events not nested in another on
    their thread).  A card's trace without kernel events raises."""
    spans = [e for e in events if e.get("ph") == "X"]
    kernels = [e for e in spans if e.get("cat") == "kernel"]
    if kernels:
        return "kernel", kernels
    if device != "cpu":
        raise ValueError("the trace has no kernel events: the profiler did not trace"
                         " the card (a CPU trace needs --device=cpu)")
    ops = sorted((e for e in spans if e.get("cat") == "cpu_op"),
                 key=lambda e: (e.get("tid"), e["ts"], -e.get("dur", 0)))
    top, ends = [], {}
    for e in ops:
        if e["ts"] >= ends.get(e.get("tid"), float("-inf")):
            top.append(e)
            ends[e.get("tid")] = e["ts"] + e.get("dur", 0)
    return "cpu_op", top


def trace_file(path: str) -> str:
    """``path`` itself, or the last ``*.json`` trace in that directory."""
    if os.path.isfile(path):
        return path
    paths = sorted(glob.glob(os.path.join(path, "*.json")))
    if not paths:
        raise FileNotFoundError(f"no chrome trace under {path}")
    return paths[-1]


def analyze(trace_path: str, nx: int, ny: int, chunk: int, chunks: int,
            device: str = "cuda"):
    """The chunks of a trace of ``chunks`` chained ``chunk``-step calls on
    an (ny, nx) grid, captured on ``device``: ms a chunk (its events'
    summed durations), Gpoint/s from that time, the longest gap between one
    chunk's last event and the next one's first, and a chunk's span with
    the busy share of it."""
    with open(trace_file(trace_path)) as f:
        kind, evs = device_events(json.load(f)["traceEvents"], device)
    if not evs or len(evs) % chunks:
        raise ValueError(f"{len(evs)} {kind} events do not split into {chunks} equal chunks")
    evs.sort(key=lambda e: e["ts"])
    per = len(evs) // chunks
    groups = [evs[i * per:(i + 1) * per] for i in range(chunks)]
    spans = [(g[0]["ts"], max(e["ts"] + e.get("dur", 0) for e in g)) for g in groups]
    span_us = sum(b - a for a, b in spans) / chunks
    gaps = [nxt[0] - prev[1] for prev, nxt in zip(spans, spans[1:])]
    by_name = {}
    for e in evs:
        by_name[e["name"]] = by_name.get(e["name"], 0.0) + e.get("dur", 0)
    per_chunk_us = sum(by_name.values()) / chunks
    return {
        "program": max(by_name, key=by_name.get),
        "events": kind,
        "events_per_chunk": per,
        "n_chunks": chunks,
        "ms_per_chunk": per_chunk_us / 1e3,
        "device_gpts": nx * ny * chunk / (per_chunk_us / 1e6) / 1e9,
        "max_gap_ms": (max(gaps) / 1e3) if gaps else 0.0,
        "span_ms_per_chunk": span_us / 1e3,
        "busy_share": per_chunk_us / span_us,
    }


def main(argv: Optional[List[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--nx", type=int, default=4096)
    ap.add_argument("--ny", type=int, default=4096)
    ap.add_argument("--chunk", type=int, default=100)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--trace_dir", default=None,
                    help="keep the trace here (default: a temporary directory)")
    ap.add_argument("--analyze_only", default=None,
                    help="skip capture; analyze this trace (or the last *.json in this dir)"
                         " of --reps chunks, captured on --device")
    ap.add_argument("--bc", default="bench",
                    choices=["bench", "dirichlet", "torus", "one_sided_y",
                             "one_sided_x", "both_one_sided",
                             "carrier", "carrier_torus"],
                    help="BC class (the one-sided classes trace the wrap patches)")
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    a = ap.parse_args(argv)

    with tempfile.TemporaryDirectory(prefix="tracerate_") as tmp:
        path = a.analyze_only
        if path is None:
            import torch

            if a.device == "cuda" and not torch.cuda.is_available():
                print("trace_rate: --device=cuda but torch.cuda.is_available() is False",
                      file=sys.stderr)
                return 2
            outdir = a.trace_dir or tmp
            os.makedirs(outdir, exist_ok=True)
            path = os.path.join(outdir, "trace.json")
            for attempt in range(1, TRIES + 1):
                launched = capture(a.nx, a.ny, a.chunk, a.reps, path, a.bc, a.device)
                traced = stencil_events(path)
                if traced == launched:
                    break
                print(f"trace_rate: the trace holds {traced} of the {launched} stencil"
                      f" launches of its chunks (try {attempt} of {TRIES})", file=sys.stderr)
            else:
                raise ValueError(f"{TRIES} traces lost stencil launches")
        r = analyze(path, a.nx, a.ny, a.chunk, a.reps, a.device)
    print(f"program: {r['program']}  chunks: {r['n_chunks']}"
          f"  ({r['events_per_chunk']} {r['events']} events a chunk)")
    print(f"ms/chunk({a.chunk} steps): {r['ms_per_chunk']:.3f}")
    print(f"device rate (kernel time): {r['device_gpts']:.1f} Gpoint/s")
    print(f"max inter-chunk gap: {r['max_gap_ms']:.3f} ms")
    print(f"chunk span: {r['span_ms_per_chunk']:.3f} ms"
          f" (device busy {100 * r['busy_share']:.1f}% of it)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
