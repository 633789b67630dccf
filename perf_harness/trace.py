"""The harness's own profiler around one traced job, and the reduction of
its trace to what the per-layer readers need.

``torch.profiler`` (CPU and CUDA activities) is wrapped around one call of
the program; its chrome trace is written under the temporary directory,
read back and deleted.  Each card's events (kernels, copies, sets) become
one :func:`card_summary`: the time the card was busy (the union of its
events), the stencil kernel's events, the time by operation, and the idle
gaps between busy stretches, each named by what the host was doing when
it began.

The program's spans lie in the trace as ``user_annotation`` events whose
names start with its prefix (``climate.``).  They name no gap as host
work: a gap is put down to the host call running inside them, and apart
from that to the innermost span open (``span_gaps``).  The span
``<prefix>loop`` (the program's timed loop) bounds the card's busy time
inside the loop (``loop_us``, ``loop_busy_us``).
"""

from __future__ import annotations

import bisect
import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
TOP = 10          # entries of each breakdown list
NAME_CHARS = 96   # an operation's name is cut to this many characters
SCAN_BACK = 4096  # host events looked at, backwards, to name a gap
LOOP = "loop"     # the program's timed loop: its span is <prefix>loop
NO_SPAN = "(no program span)"


def profile(fn: Callable[[], object], rank: int, cuda: bool) -> Tuple[object, List[dict]]:
    """(fn's result, the trace's events) of ``fn`` run under the profiler."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    path = os.path.join(tempfile.gettempdir(), f"perf_harness_trace_rank{rank}.json")
    with torch.profiler.profile(activities=acts) as prof:
        out = fn()
    prof.export_chrome_trace(path)
    try:
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, events


def union_us(spans: Sequence[Tuple[float, float]]) -> Tuple[float, List[Tuple[float, float]]]:
    """(length of the union, its merged stretches) of (start, end) spans."""
    merged: List[Tuple[float, float]] = []
    for a, b in sorted(spans):
        if merged and a <= merged[-1][1]:
            if b > merged[-1][1]:
                merged[-1] = (merged[-1][0], b)
        else:
            merged.append((a, b))
    return sum(b - a for a, b in merged), merged


def _device_of(e: dict) -> int:
    args = e.get("args") or {}
    return int(args.get("device", e.get("pid", 0)))


def card_summaries(events: Sequence[dict], stencil: str, prefix: str) -> Dict[int, dict]:
    """One :func:`card_summary` for each card that has device events;
    ``prefix`` is that of the program's span names."""
    by_card: Dict[int, List[dict]] = {}
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            by_card.setdefault(_device_of(e), []).append(e)
    host, spans = [], []
    for e in sorted((e for e in events if e.get("ph") == "X" and e.get("cat") in HOST_CATS),
                    key=lambda e: e["ts"]):
        mine = e["cat"] == "user_annotation" and e.get("name", "").startswith(prefix)
        (spans if mine else host).append(e)
    loops = [_interval(e) for e in spans if e["name"] == f"{prefix}{LOOP}"]
    return {card: card_summary(evs, host, stencil, spans, loops)
            for card, evs in by_card.items()}


def _interval(e: dict) -> Tuple[float, float]:
    return float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0.0))


def _host_at(host: Sequence[dict], starts: Sequence[float], t: float,
             none: str = "(no host event)") -> str:
    """The innermost host event running at ``t`` (the latest to start of
    those that cover it), or ``none``."""
    i = bisect.bisect_right(starts, t)
    for j in range(i - 1, max(-1, i - 1 - SCAN_BACK), -1):
        e = host[j]
        if e["ts"] + e.get("dur", 0.0) > t:
            return e["name"][:NAME_CHARS]
    return none


def _clipped_us(merged: Sequence[Tuple[float, float]],
                windows: Sequence[Tuple[float, float]]) -> float:
    """The length of the merged stretches that lies inside ``windows``."""
    return sum(max(0.0, min(b, wb) - max(a, wa)) for wa, wb in windows for a, b in merged)


def card_summary(device: Sequence[dict], host: Sequence[dict], stencil: str,
                 spans: Sequence[dict] = (),
                 loops: Sequence[Tuple[float, float]] = ()) -> dict:
    """What one card's events say: times in microseconds.

    ``busy_us`` the union of its events; ``stencil_*`` the stencil kernel's
    events (their count, summed durations and union); ``ops`` time by
    operation name; ``gaps`` idle time between busy stretches, by the host
    event running when each gap began, and ``span_gaps`` by the innermost
    program span open then (``spans``, sorted by start).  ``loop_us`` is
    the length of the program's loops (``loops``, its ``<prefix>loop``
    spans), ``loop_busy_us`` the card's busy time inside them and
    ``loop_stencil_events`` the stencil events that start there."""
    evs = [_interval(e) for e in device]
    busy, merged = union_us(evs)
    sten = [(a, b) for (a, b), e in zip(evs, device) if stencil in e.get("name", "")]
    sten_union, _ = union_us(sten)
    ops: Dict[str, float] = {}
    for (a, b), e in zip(evs, device):
        name = e.get("name", "?")[:NAME_CHARS]
        ops[name] = ops.get(name, 0.0) + (b - a)
    starts = [float(e["ts"]) for e in host]
    span_starts = [float(e["ts"]) for e in spans]
    gaps: Dict[str, float] = {}
    span_gaps: Dict[str, float] = {}
    for (_, end), (nxt, _) in zip(merged, merged[1:]):
        name = _host_at(host, starts, end)
        gaps[name] = gaps.get(name, 0.0) + (nxt - end)
        name = _host_at(spans, span_starts, end, NO_SPAN)
        span_gaps[name] = span_gaps.get(name, 0.0) + (nxt - end)
    loop_us, windows = union_us(loops)
    return {
        "busy_us": busy,
        "stencil_events": len(sten),
        "stencil_sum_us": sum(b - a for a, b in sten),
        "stencil_union_us": sten_union,
        "ops": dict(sorted(ops.items(), key=lambda kv: -kv[1])[:TOP]),
        "gaps": dict(sorted(gaps.items(), key=lambda kv: -kv[1])[:TOP]),
        "span_gaps": dict(sorted(span_gaps.items(), key=lambda kv: -kv[1])[:TOP]),
        "loop_us": loop_us,
        "loop_busy_us": _clipped_us(merged, windows),
        "loop_stencil_events": sum(1 for a, _ in sten
                                   if any(wa <= a < wb for wa, wb in windows)),
    }


def breakdown(cards: Sequence[dict]) -> Optional[dict]:
    """The result line's ``breakdown``: device operations and idle gaps,
    seconds summed over the cards, the largest ``TOP`` of each."""
    if not cards:
        return None
    ops: Dict[str, float] = {}
    gaps: Dict[str, float] = {}
    for c in cards:
        for name, us in c["ops"].items():
            ops[name] = ops.get(name, 0.0) + us / 1e6
        for name, us in c["gaps"].items():
            gaps[name] = gaps.get(name, 0.0) + us / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]
    return {"device_ops": top(ops), "idle_gaps": top(gaps)}
