"""The walls and rates of the port's multi-process driver and snapshot
writers, in turns, on the CUDA cards of one machine.

    python3 scripts/torch_multiprocess_rates.py [ITEM ...]

Runs the items below that are named (1-4), or all of them.  Every run
is ``configs/bench_4096.yaml`` at 4096², 1000 steps unless named, f32,
through the port's driver (in this process) or its CLI with
``--distributed=127.0.0.1:PORT,N,I`` (one process per rank,
``chip_smoke.run_ranks``); each number is read from the run's own
``timing:`` and ``throughput:`` lines.

1. Output off: 4 ranks sharing cuda:0 (gloo, host-staged) against the
   single-process 2x2 mesh of cuda:0, turns single, ranks, ranks, single.
   With four or more cards also: K1 on cuda:0, the single-process 2x2 mesh
   over four cards (its chunks one CUDA graph that spans the cards), the
   same mesh eager (``disable_graphs()``) and 4 ranks one per card (NCCL),
   turns K1, mesh, eager mesh, ranks, ranks, eager mesh, mesh, K1.
2. Output on, ``--out_every=100`` (10 records), one device: the native
   writer against the Python codec (``use_native=False``), turns native,
   python, python, native; then each once with ``profile_dir`` for the
   kernel time in the trace, and the busy share is that over the
   unprofiled wall.
3. Output on as in 2: 4 ranks sharing cuda:0 writing their own regions
   against the single-process 2x2 mesh of cuda:0, turns ranks, mesh, mesh,
   ranks.
4. Output off, 200 steps, ``profile_dir``: rank 0's trace of 4 ranks on
   cuda:0 (gloo) and, with four cards, one per card (NCCL): the kernel
   time by name, the device copies, and the host's CUDA runtime calls and
   operators by total time (operators nest, so their totals overlap).
   Then the single-process 2x2 mesh of cuda:0 and, with four cards, over
   the four (each 200-step span one replayed graph): the same totals, and
   for each card its kernels' and copies' count, busy ms (the union of
   their intervals) and span ms (first start to last end), and the first
   40 device events in time order.

The first line is the card's name and power limit from nvidia-smi; each
turn prints ``RUN {json}``.  Without a CUDA card the script exits non-zero.
"""

from __future__ import annotations

import contextlib
import functools
import io
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "configs", "bench_4096.yaml")
BASE = ["--steps=1000", "--out_every=500", "--kernel=pallas"]
OFF = [*BASE, "--output.enable=false"]
ON = ["--steps=1000", "--out_every=100", "--kernel=pallas"]
MESH = ["--mesh.x=2", "--mesh.y=2"]


def parse(out: str) -> dict:
    wall = float(re.search(r"^timing: total_max=(\S+) s", out, re.M).group(1))
    rate = float(re.search(r"^throughput: (\S+) Mpoint/s total", out, re.M).group(1))
    return {"wall_s": wall, "gpoint_s": rate / 1e3}


def in_process(devices, args, writer=None, profile_dir=None, eager=False) -> dict:
    """A driver run in this process; ``writer`` replaces the driver's
    whole-field snapshot writer; ``eager`` runs it under
    ``disable_graphs()``."""
    from climate_sim_tpu_torch.config import merged_config
    from climate_sim_tpu_torch.runtime import driver, graphs

    if profile_dir:
        args = [*args, f"--profile_dir={profile_dir}"]
    cfg = merged_config(BENCH, args)
    buf = io.StringIO()
    saved = driver.SnapshotWriter
    driver.SnapshotWriter = writer or saved
    try:
        with contextlib.redirect_stdout(buf), \
                (graphs.disable_graphs() if eager else contextlib.nullcontext()):
            driver.run_simulation(cfg, devices)
    finally:
        driver.SnapshotWriter = saved
    return parse(buf.getvalue())


def ranks(smoke, nproc, args, share_a_card=True) -> dict:
    """A run of ``nproc`` ranks through the CLI, all on the first card, or
    one per card."""
    env = smoke.one_card_env() if share_a_card else None
    results = smoke.run_ranks(nproc, 1, [f"--config={BENCH}", *args], env=env)
    out0, _ = smoke.check_ranks("rates", results, "")
    return {**parse(out0), "transport": re.search(r"transport: (.*)$", out0, re.M).group(1)}


def kernel_ms(trace_dir: str, name: str = "trace.json") -> float:
    with open(os.path.join(trace_dir, name)) as f:
        events = json.load(f)["traceEvents"]
    return sum(ev.get("dur", 0.0) for ev in events if ev.get("cat") == "kernel") / 1e3


def trace_totals(path: str, top: int = 8) -> dict:
    """ms and count by name for each event category of a chrome trace,
    the ``top`` largest of each."""
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    out = {}
    for cat in ("kernel", "gpu_memcpy", "cuda_runtime", "cpu_op"):
        by = {}
        for ev in events:
            if ev.get("cat") == cat:
                n, us = by.get(ev["name"][:60], (0, 0.0))
                by[ev["name"][:60]] = (n + 1, us + ev.get("dur", 0.0))
        ranked = sorted(by.items(), key=lambda kv: -kv[1][1])[:top]
        out[cat] = {k: [n, round(us / 1e3, 3)] for k, (n, us) in ranked}
        out[f"{cat}_ms"] = round(sum(us for _, us in by.values()) / 1e3, 3)
    return out


def device_split(path: str, first: int = 40) -> dict:
    """For each card of a chrome trace, its kernel and copy events' count,
    busy ms (the union of their intervals) and span ms (first start to
    last end); and the ``first`` of them in time order, each [card, name,
    start us from the first, duration us]."""
    with open(path) as f:
        events = [ev for ev in json.load(f)["traceEvents"]
                  if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset")]
    events.sort(key=lambda ev: ev["ts"])
    cards = {}
    for ev in events:
        cards.setdefault(ev.get("args", {}).get("device"), []).append(ev)
    split = {}
    for card, evs in cards.items():
        busy, end = 0.0, None
        for ev in evs:
            start, stop = ev["ts"], ev["ts"] + ev.get("dur", 0.0)
            if end is None or start >= end:
                busy += stop - start
            elif stop > end:
                busy += stop - end
            end = stop if end is None else max(end, stop)
        split[str(card)] = {"events": len(evs), "busy_ms": round(busy / 1e3, 3),
                            "span_ms": round((end - evs[0]["ts"]) / 1e3, 3)}
    t0 = events[0]["ts"] if events else 0.0
    return {"by_card": split, "first_events": [
        [ev.get("args", {}).get("device"), ev["name"][:40], round(ev["ts"] - t0, 1),
         round(ev.get("dur", 0.0), 1)] for ev in events[:first]]}


def main() -> int:
    sys.path.insert(0, REPO)
    import torch

    if not torch.cuda.is_available():
        print("torch_multiprocess_rates: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from climate_sim_tpu_torch.io.snapshots import SnapshotWriter

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip().splitlines()
    print(f"[device] {smi[0]} ({len(smi)} card(s) listed)")
    dev0 = torch.device("cuda", 0)
    torch.cuda.set_device(dev0)
    tmp = tempfile.mkdtemp(prefix="mp_rates_")

    def show(item, name, res):
        print("RUN " + json.dumps({"item": item, "run": name, **res}), flush=True)

    def out_dir(name):
        d = os.path.join(tmp, name)
        shutil.rmtree(d, ignore_errors=True)
        return [f"--output.dir={d}"]

    items = {int(a) for a in sys.argv[1:]} or {1, 2, 3, 4}
    try:
        one_card = {
            "single-process 2x2 mesh of cuda:0": lambda: in_process([dev0] * 4, [*OFF, *MESH]),
            "4 ranks on cuda:0": lambda: ranks(smoke, 4, [*OFF, *MESH]),
        }
        for name in (list(one_card) + list(one_card)[::-1]) * (1 in items):
            show(1, name, one_card[name]())
        if torch.cuda.device_count() >= 4 and 1 in items:
            cards = [torch.device("cuda", i) for i in range(4)]
            four = {
                "K1 on cuda:0": lambda: in_process([dev0], OFF),
                "single-process 2x2 mesh over 4 cards": lambda: in_process(cards, [*OFF, *MESH]),
                "single-process 2x2 mesh over 4 cards, eager":
                    lambda: in_process(cards, [*OFF, *MESH], eager=True),
                "4 ranks, one per card": lambda: ranks(smoke, 4, [*OFF, *MESH], False),
            }
            order = list(four) + list(four)[::-1]
            for name in order:
                show(1, name, four[name]())

        python = functools.partial(SnapshotWriter, use_native=False)
        writers = {"native": None, "python": python}
        for name in ("native", "python", "python", "native") * (2 in items):
            show(2, f"one device, 10 records, {name} writer",
                 in_process([dev0], [*ON, *out_dir("w")], writer=writers[name]))
        for name in ("native", "python") * (2 in items):
            prof = os.path.join(tmp, f"prof_{name}")
            res = in_process([dev0], [*ON, *out_dir("w")], writer=writers[name],
                             profile_dir=prof)
            show(2, f"one device, 10 records, {name} writer, profiled",
                 {**res, "kernel_ms": kernel_ms(prof)})

        three = {
            "4 ranks on cuda:0, 10 records": lambda: ranks(smoke, 4, [*ON, *MESH, *out_dir("r")]),
            "single-process 2x2 mesh of cuda:0, 10 records":
                lambda: in_process([dev0] * 4, [*ON, *MESH, *out_dir("m")]),
        }
        for name in (list(three) + list(three)[::-1]) * (3 in items):
            show(3, name, three[name]())

        short = ["--steps=200", "--out_every=100", "--kernel=pallas", "--output.enable=false"]
        for name, share in (("4 ranks on cuda:0", True), ("4 ranks, one per card", False)) * \
                (4 in items):
            if not share and torch.cuda.device_count() < 4:
                continue
            prof = os.path.join(tmp, "prof_ranks")
            shutil.rmtree(prof, ignore_errors=True)
            res = ranks(smoke, 4, [*short, *MESH, f"--profile_dir={prof}"], share)
            show(4, f"{name}, 200 steps, profiled rank 0",
                 {**res, **trace_totals(os.path.join(prof, "trace_rank0.json"))})
        meshes = {"single-process 2x2 mesh of cuda:0": [dev0] * 4}
        if torch.cuda.device_count() >= 4:
            meshes["single-process 2x2 mesh over 4 cards"] = \
                [torch.device("cuda", i) for i in range(4)]
        for name, devices in meshes.items() if 4 in items else ():
            prof = os.path.join(tmp, "prof_mesh")
            shutil.rmtree(prof, ignore_errors=True)
            res = in_process(devices, [*short, *MESH], profile_dir=prof)
            trace = os.path.join(prof, "trace.json")
            show(4, f"{name}, 200 steps, profiled",
                 {**res, **trace_totals(trace), **device_split(trace)})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
