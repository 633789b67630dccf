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
   With the traffic's output on, every job writes its snapshot file into
   the run's own directory (:class:`ranks.Ranks` makes it, and removes it
   when the run ends), each job over the last one's; right after the
   window the last job's file is renamed aside, so the jobs after it
   leave it as the window wrote it.
3. ``trace`` (``--trace 1`` only): :data:`REPEATS` more jobs of the
   window's shape, each inside the program's ``collect()`` without the
   profiler, then one inside it under the harness's own profiler, reduced
   to each card's summary (:mod:`trace`); it hands back what the program
   recorded in its observed jobs.
4. ``check``: each kept field against the plain reference, computed again
   from the job's inputs (:mod:`reference`), tile by tile on each rank;
   with output on, then each record of the file kept aside, read by the
   harness's own reader (:mod:`cdf5`), against the reference at the
   record's step (:func:`record_steps`).  A record the file lacks, one it
   holds beyond the job's, and every record of a file that is not the
   job's (no ``u``, another type or shape) reads NaN, so it fails.
"""

from __future__ import annotations

import math
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import cdf5
import jobs
import program
import reference
import trace

BANNED = ("jax", "jaxlib", "flax", "climate_sim_tpu")
# Jobs of the window's shape observed without the profiler after the
# window, besides the calibration job: per-call readings swing from job to
# job, so their readers take the median of these and the calibration job.
REPEATS = 8
# The name under which the last window job's snapshot file is kept.
KEPT_FILE = "window_last.nc"


def record_steps(traffic: dict, steps: Optional[int] = None) -> List[int]:
    """The steps at which a job of ``traffic`` writes a snapshot record:
    0, ``out_every``, ... below its ``steps`` (default ``job_steps``);
    none with output off."""
    if not traffic.get("output", False):
        return []
    return list(range(0, int(steps or traffic["job_steps"]), int(traffic["out_every"])))


def worst(errs: Sequence[float]) -> float:
    """The largest of the gaps, NaN if any is (or if there is none)."""
    return math.nan if not errs or any(math.isnan(e) for e in errs) else max(errs)


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
                 port: int, devices, out_dir: Optional[str] = None):
        """``out_dir``: the directory every rank's jobs write their snapshot
        file into, with the traffic's output on."""
        self.rank = rank
        self.config, self.traffic, self.seed = config, traffic, int(seed)
        self.spec = f"localhost:{port},{world},{rank}" if world > 1 else ""
        self.devices = list(devices)
        self.cuda = self.devices[0].type == "cuda"
        self.scheme = reference.Scheme.from_config(config)
        self.kept = []    # (hotspot, the program's final field) of the window's jobs
        self.out_dir = out_dir
        # the last window job's snapshot file, set aside, and its records' steps
        self.records: Optional[Tuple[str, List[int]]] = None
        self.found = 0  # the records the kept file held at the check
        self.memory_peak = 0
        self.program: Dict[str, object] = {}  # observed jobs, by phase

    def call(self, steps: int, spot, precision: Optional[str] = None):
        cfg = program.sim_config(self.config, self.traffic, steps, spot,
                                 distributed=self.spec, precision=precision,
                                 output_dir=self.out_dir or tempfile.gettempdir())
        return program.run(cfg, self.devices)

    def _set_aside(self, result, steps: int) -> None:
        """With output on, rename the file that ``result``'s job of
        ``steps`` steps wrote to :data:`KEPT_FILE` (rank 0, which created
        it; every rank keeps its path)."""
        due = record_steps(self.traffic, steps)
        if not due:
            return
        self.records = (os.path.join(self.out_dir, KEPT_FILE), due)
        if self.rank == 0:
            os.replace(result.output_path, self.records[0])

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
        wall = time.perf_counter() - t0
        self._set_aside(result, steps)
        return {"wall_s": wall, "t0": t0, "lines": lines, "memory_peak": self.memory_peak}

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
        tiles, as a share of the job's amplitude (NaN for a NaN); with
        output on, then each record slot of the kept file alike
        (:meth:`_records`)."""
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
                errs[i] = _worse(errs[i], reference.max_error(tile, ref) / spot.A)
            del refs
        if self.records is not None:
            errs += self._records(self.kept[-1][0], windows, dev)
        return errs

    def _records(self, spot, windows, dev) -> List[float]:
        """Each record slot of the kept file: the largest gap of this rank's
        tiles of the record to the reference at its step, as a share of the
        amplitude.  One slot a record the job writes, or the file holds if
        that is more; NaN for a record missing or extra, and for every slot
        when the file is not the job's."""
        import torch

        path, steps = self.records
        try:
            f = cdf5.Cdf5File(path)
            fits = (f.variables["u"].nc_type == cdf5.NC_DOUBLE
                    and f.shape("u") == (None, self.scheme.ny, self.scheme.nx))
            found = f.numrecs
        except (OSError, ValueError, KeyError):
            fits, found = False, 0
        self.found = found
        errs = [math.nan] * max(len(steps), found)
        if not fits:
            return errs
        due = steps[:found]
        errs[:len(due)] = [0.0] * len(due)
        for win in windows.values():
            y0, y1, x0, x1 = win or (0, self.scheme.ny, 0, self.scheme.nx)
            refs = reference.evolve_separable_series([spot], self.scheme, due, win, dev)
            for i, (ref,) in enumerate(refs):
                try:
                    rec = torch.from_numpy(f.record("u", i)[y0:y1, x0:x1]).to(dev)
                except ValueError:
                    errs[i] = math.nan
                    continue
                errs[i] = _worse(errs[i], reference.max_error(rec, ref) / spot.A)
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
        self._set_aside(result, steps)
        try:
            return self.check(steps)
        finally:
            self.kept, self.records = [], None

    def record_count(self) -> Optional[Tuple[int, int]]:
        """(the records the kept file held at the check, the records its
        job writes); None with output off."""
        return None if self.records is None else (self.found, len(self.records[1]))

    def modules(self) -> List[str]:
        return banned_modules(list(sys.modules))

    def leave(self) -> None:
        program.leave()


def _worse(seen: float, err: float) -> float:
    """The larger of two gaps, NaN if either is."""
    return math.nan if math.isnan(seen) or math.isnan(err) else max(seen, err)


def result(summary: dict, metrics: Dict[str, dict], device: dict, errs: List[float],
           limit: float, breakdown: Optional[dict],
           records: Optional[Tuple[int, int]] = None) -> dict:
    """The result line: ``correct``, ``attempted``, ``failed``, ``metrics``,
    ``device``, the optional ``breakdown``, and last the compared numbers
    beside their limits: the largest gap, and with output on the records
    the kept file held beside those its job writes (``records``)."""
    failed = sum(1 for e in errs if not e <= limit)
    line = {
        "correct": bool(errs) and failed == 0,
        "attempted": len(errs),
        "failed": failed,
        "metrics": metrics,
        "device": device,
    }
    if breakdown is not None:
        line["breakdown"] = breakdown
    line["checks"] = {"max_err_rel": {"value": worst(errs), "limit": limit}}
    if records is not None:
        line["checks"]["records"] = {"value": records[0], "limit": records[1]}
    return line
