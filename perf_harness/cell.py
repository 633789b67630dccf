"""One run of one cell: set-up, the measured window, the traced job, the
check against the plain reference, and the result.

Every rank of a cell runs a :class:`Rank`; rank 0 is this process, and a
cell of several ranks starts the others as processes of their own, one a
card (:mod:`ranks`).  Rank 0 decides what all do, phase by phase:

1. ``setup``: one short job (it builds or loads the kernel library,
   brings up the process group and captures the chunk length every job
   uses), then one whole calibration job, whose wall sets the window's
   number of jobs.  With ``--trace 1`` each of the two runs inside the
   program's ``collect()``, without the profiler, and what the program
   recorded is kept (:func:`observed`).
2. ``window``: that many jobs back to back, each one call of the program's
   entry point, timed on the host clock from before the first call to the
   return of the last, which returns after the cards are synchronised.
   The window is the longest rank's.  Each job's final field is kept on
   the card; the card's allocator peak is read after the first job
   returns and before its field is kept, so it is the program's own.
3. ``trace`` (``--trace 1`` only): :data:`REPEATS` more jobs of the
   window's shape, each inside the program's ``collect()`` without the
   profiler, then one inside it under the harness's own profiler, reduced
   to each card's summary (:mod:`trace`); it hands back what the program
   recorded in its observed jobs.
4. ``check``: each kept field against the plain reference, computed again
   from the job's inputs (:mod:`reference`), tile by tile on each rank.
"""

from __future__ import annotations

import math
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import jobs
import program
import reference
import trace

BANNED = ("jax", "jaxlib", "flax", "climate_sim_tpu")
# Jobs of the window's shape observed without the profiler after the
# window, besides the calibration job: per-call readings swing from job to
# job, so their readers take the median of these and the calibration job.
REPEATS = 8


def banned_modules(modules: Sequence[str]) -> List[str]:
    """The banned top-level names among ``modules``, compared whole, so the
    port (``climate_sim_tpu_torch``) is not taken for the JAX package."""
    return sorted({m.split(".")[0] for m in modules} & set(BANNED))


def observed(fn: Callable[[], object]) -> Tuple[object, dict]:
    """(fn's result, what the program recorded while it ran), the latter a
    plain dict: ``spans_s`` (seconds summed by span name), ``span_counts``
    (spans of each name), ``counters``, and ``k1_launches``, K1's launches
    counted meanwhile."""
    before = program.k1_launches()
    with program.collect() as record:
        out = fn()
    seconds: Dict[str, float] = {}
    counts: Dict[str, int] = {}
    for s in record.spans:
        seconds[s.name] = seconds.get(s.name, 0.0) + s.seconds
        counts[s.name] = counts.get(s.name, 0) + 1
    return out, {"spans_s": seconds, "span_counts": counts,
                 "counters": dict(record.counters),
                 "k1_launches": program.k1_launches() - before}


def rank_devices(kind: str, rank: int):
    """A rank's devices: its own card (made current), or the CPU."""
    import torch

    if kind != "cuda":
        return [torch.device(kind)]
    dev = torch.device("cuda", rank)
    torch.cuda.set_device(dev)
    return [dev]


class Rank:
    """One rank's side of a cell run, on ``devices``."""

    def __init__(self, rank: int, world: int, config: dict, traffic: dict, seed: int,
                 port: int, devices):
        self.rank = rank
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.spec = f"localhost:{port},{world},{rank}" if world > 1 else ""
        self.devices = list(devices)
        self.cuda = self.devices[0].type == "cuda"
        self.scheme = reference.Scheme.from_config(config)
        self.kept = []    # (hotspot, the program's final field) of the window's jobs
        self.memory_peak = 0
        self.program: Dict[str, object] = {}  # observed jobs, by phase

    def call(self, steps: int, spot, precision: Optional[str] = None):
        cfg = program.sim_config(self.config, self.traffic, steps, spot,
                                 distributed=self.spec, precision=precision,
                                 output_dir=tempfile.gettempdir())
        return program.run(cfg, self.devices)

    def setup(self, traced: bool = False) -> float:
        """The warm-up job and the calibration job; the latter's wall.
        ``traced``: each job is :func:`observed`, and kept as ``warmup`` and
        as the first of ``jobs``."""
        warm, cal = jobs.hotspots(self.traffic, self.seed, "setup", 2)
        warm_job = lambda: self.call(int(self.traffic["warm_steps"]), warm)
        cal_job = lambda: self.call(int(self.traffic["job_steps"]), cal)
        if not traced:
            warm_job()
            return cal_job()[2]
        # each job's field is let go before the next starts, as untraced,
        # so that the window's memory peak is the same with --trace 1
        self.program["warmup"] = observed(warm_job)[1]
        (_, _, wall), cal_seen = observed(cal_job)
        self.program["jobs"] = [cal_seen]
        return wall

    def window(self, count: int) -> dict:
        spots = jobs.hotspots(self.traffic, self.seed, "window", count)
        steps = int(self.traffic["job_steps"])
        lines = []
        t0 = time.perf_counter()
        for spot in spots:
            result, out, _ = self.call(steps, spot)
            if not self.kept:
                self.memory_peak = self._allocated_peak()
            self.kept.append((spot, result.u))
            lines += out
        return {"wall_s": time.perf_counter() - t0, "t0": t0, "lines": lines,
                "memory_peak": self.memory_peak}

    def _allocated_peak(self) -> int:
        import torch

        return max(torch.cuda.max_memory_allocated(d) for d in self.devices) if self.cuda else 0

    def trace(self) -> dict:
        (spot,) = jobs.hotspots(self.traffic, self.seed, "trace", 1)
        steps = int(self.traffic["job_steps"])
        for again in jobs.hotspots(self.traffic, self.seed, "trace", REPEATS, first=1):
            # each job's field is let go before the next starts
            self.program["jobs"].append(observed(lambda: self.call(steps, again)[1:])[1])
        before = program.stencil_launches()
        ((_, _, wall), self.program["trace"]), events = trace.profile(
            lambda: observed(lambda: self.call(steps, spot)), self.rank, self.cuda)
        launches = program.stencil_launches() - before
        cards = trace.card_summaries(events, program.stencil_kernel(), program.prefix())
        for c in cards.values():
            c["rank"] = self.rank
            c["stencil_launches"] = launches / max(1, len(cards))
            c["points"] = self.scheme.nx * self.scheme.ny // self.cards_in_cell()
        return {"wall_s": wall, "steps": steps, "cards": list(cards.values()),
                "program": self.program}

    def cards_in_cell(self) -> int:
        mesh = self.config.get("layout", {}).get("mesh")
        return int(mesh["x"]) * int(mesh["y"]) if mesh else 1

    def check(self, steps: Optional[int] = None) -> List[float]:
        """Each kept job's largest gap to the reference over this rank's
        tiles, as a share of the job's amplitude (NaN for a NaN)."""
        import torch

        steps = int(steps or self.traffic["job_steps"])
        dev = self.devices[0] if self.cuda else "cpu"
        spots = [spot for spot, _ in self.kept]
        errs = [0.0] * len(self.kept)
        first = self.kept[0][1] if self.kept else None
        if isinstance(first, torch.Tensor):
            windows = {(0, 0): None}
        else:
            mesh = self.config["layout"]["mesh"]
            windows = reference.tile_windows(self.scheme, (mesh["y"], mesh["x"]), first)
        for (ty, tx), win in windows.items():
            refs = reference.evolve_separable(spots, self.scheme, steps, win, dev)
            for i, ((spot, u), ref) in enumerate(zip(self.kept, refs)):
                tile = u if isinstance(u, torch.Tensor) else u[ty][tx]
                err = reference.max_error(tile, ref) / spot.A
                errs[i] = math.nan if math.isnan(err) or math.isnan(errs[i]) else max(errs[i], err)
            del refs
        return errs

    def probe(self, seed: int, precision: Optional[str] = None,
              steps: Optional[int] = None) -> List[float]:
        """The first window job of ``seed``, run in ``precision`` (default
        the configuration's) for ``steps`` (default the job's), against the
        reference: what the limit of the check is set from."""
        (spot,) = jobs.hotspots(self.traffic, seed, "window", 1)
        steps = int(steps or self.traffic["job_steps"])
        result, _, _ = self.call(steps, spot, precision)
        self.kept = [(spot, result.u)]
        try:
            return self.check(steps)
        finally:
            self.kept = []

    def modules(self) -> List[str]:
        return banned_modules(list(sys.modules))

    def leave(self) -> None:
        program.leave()


def result(summary: dict, metrics: Dict[str, dict], device: dict, errs: List[float],
           limit: float, breakdown: Optional[dict]) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, the optional ``breakdown``, and last the compared number
    beside its limit."""
    failed = sum(1 for e in errs if not e <= limit)
    worst = math.nan if not errs or any(math.isnan(e) for e in errs) else max(errs)
    line = {
        "correct": bool(errs) and failed == 0,
        "attempted": len(errs),
        "failed": failed,
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {"max_err_rel": {"value": worst, "limit": limit}}
    return line
