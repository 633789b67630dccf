"""Run driver for one device: the analogue of the reference's main()
(reference: src/main.cpp:23-138), ported from ``climate_sim_tpu/runtime/driver.py``.

Flow: config -> CFL clamp with warning -> banner -> IC -> IC min/max log ->
open snapshot file -> time loop with pre-update snapshots at
``n % out_every == 0`` -> ``timing: total_max=<s> s, worst_avg_step=<s> s``
(greppable by the benchmark harness, reference: run_benchmark.sh:34-39).

The time loop is chunked: each span between snapshot points is dispatched
as pieces of at most 256 steps, each piece a chain of K1 passes (or of
torch-ops steps on the plain path).  On CUDA the launches are asynchronous,
so a snapshot is taken by launching the next span first and then copying the
held tensor to the host on a side stream; K1 writes a fresh output tensor,
never its input, so the held snapshot stays valid while the span runs.

Runs on exactly one device, named by the caller.  A mesh or multi-process
request is not ported yet and raises.
"""

from __future__ import annotations

import dataclasses
import os
import sys
import time
from typing import List, Optional

import numpy as np
import torch

from ..config import SimConfig, bc_to_string
from ..io.snapshots import SnapshotWriter
from ..ops.init import DTYPES, apply_initial_condition
from ..ops.stability import clamp_dt, combined_dt_limit
from ..ops.step import build_single_device_advance

# Longest piece of a span dispatched as one chunk program.  Kept from the
# JAX package (driver.py:521-529) so both packages run the same pass
# schedule and, in bf16, round at the same steps.
MAX_DISPATCH = 256


@dataclasses.dataclass
class RunResult:
    u: torch.Tensor         # final state (never snapshotted unless write_final)
    total_time: float
    avg_step_time: float
    steps: int
    snapshots_written: int
    output_path: Optional[str]
    dt: float
    clamped: bool
    timed_passes: int       # advance passes in the timed loop
    warmup_passes: int      # untimed passes before it


def _log(msg: str) -> None:
    print(msg, flush=True)


def _warn(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def resolve_device(device) -> torch.device:
    """The run's device.  CUDA must exist when asked for: the port never
    carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available()"
                " is False"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        if dev.index >= torch.cuda.device_count():
            raise RuntimeError(
                f"device {dev} requested but only"
                f" {torch.cuda.device_count()} CUDA device(s) exist"
            )
    elif dev.type != "cpu":
        raise ValueError(f"device {device!r}: the port runs on cuda or cpu")
    return dev


def _check_single_device(cfg: SimConfig) -> None:
    if (cfg.mesh.x or 1) > 1 or (cfg.mesh.y or 1) > 1:
        raise NotImplementedError(
            f"mesh.x={cfg.mesh.x} mesh.y={cfg.mesh.y}: sharded runs are not"
            " ported to the PyTorch package yet; it runs on one device"
        )
    if cfg.distributed:
        raise NotImplementedError(
            f"distributed={cfg.distributed!r}: multi-process runs are not"
            " ported to the PyTorch package yet; it runs on one device"
        )


def span_pieces(k: int) -> List[int]:
    """A ``k``-step span as pieces of at most MAX_DISPATCH steps."""
    pieces = []
    while k > 0:
        kk = min(k, MAX_DISPATCH)
        pieces.append(kk)
        k -= kk
    return pieces


def span_lengths(cfg: SimConfig) -> List[int]:
    """Steps in each span between snapshot points (main.cpp:96-99)."""
    spans, n = [], 0
    while n < cfg.steps:
        k = min(cfg.out_every - (n % cfg.out_every), cfg.steps - n)
        spans.append(k)
        n += k
    return spans


def run_pass_count(cfg: SimConfig, advance) -> int:
    """Passes the timed loop makes: one bf16 rounding event each."""
    return sum(
        advance.pass_count(kk)
        for k in span_lengths(cfg) for kk in span_pieces(k)
    )


def _field_stats(a: torch.Tensor) -> torch.Tensor:
    """[min, max, mean, l2] as ONE on-device vector (fetched when read)."""
    af = a.to(torch.float32) if a.dtype == torch.bfloat16 else a
    return torch.stack(
        [af.min(), af.max(), af.mean(), torch.sqrt(torch.sum(af * af))]
    )


def _path_name(advance, device: torch.device) -> str:
    if not advance.uses_kernel:
        return "torch ops per step"
    return "K1 CUDA kernel" if device.type == "cuda" else "K1 plain version"


def prepare(cfg: SimConfig, device):
    """Resolve the device, dtype, dt clamp, advance and IC.

    Returns (u0, advance, dt, clamped).  ``advance(k)`` advances the global
    field k steps on ``device``.
    """
    _check_single_device(cfg)
    device = resolve_device(device)
    dtype = DTYPES[cfg.precision]

    dt, limit, clamped = clamp_dt(cfg.dt, cfg.dx, cfg.dy, cfg.vx, cfg.vy, cfg.D)
    if clamped:
        # rank-0 warning, like the reference (main.cpp:44-47)
        _warn(
            f"[warn] dt={cfg.dt:g} exceeds stability limit {limit:g}"
            f" -> clamping to dt={dt:g}"
        )
    advance = build_single_device_advance(cfg, dt, device)
    if cfg.precision == "bf16":
        # bf16 storage mode rounds once per pass of the advance actually
        # chosen: once per k-step K1 pass, once per step on the plain path.
        # The error vs f32 grows about linearly in that count (the JAX
        # package measured ~1e-3 relative per event), so warn past ~5%.
        events = run_pass_count(cfg, advance)
        est = 1e-3 * events
        if est > 0.05:
            _warn(
                f"[warn] precision=bf16 over {cfg.steps} steps"
                f" (~{events:.0f} rounding events): estimated relative"
                f" error vs f32 ~{est:.2g} (~1e-3/event, linear growth)."
                "  bf16 storage mode is fit for short-horizon/memory-"
                "constrained runs; use precision=f32 for long-horizon"
                " accuracy"
            )
    comb = combined_dt_limit(cfg.dx, cfg.dy, cfg.vx, cfg.vy, cfg.D)
    if dt > comb * (1.0 + 1e-12):
        # Advisory only: the clamp keeps the reference's envelope, which is
        # insufficient when advection AND diffusion are active.
        _warn(
            f"[warn] dt={dt:g} exceeds the COMBINED advection+diffusion"
            f" stability bound {comb:g}; the run may diverge"
            " (the reference's clamp envelope does not cover this case)"
        )
    u0 = apply_initial_condition(cfg, dtype, device).contiguous()
    return u0, advance, dt, clamped


class _HostCopier:
    """Copies a snapshot to the host while the next span runs: on CUDA the
    copy waits on an event recorded before the span's launch and runs on a
    side stream into pinned memory."""

    def __init__(self, device: torch.device):
        self.device = device
        self.cuda = device.type == "cuda"
        self.stream = torch.cuda.Stream(device) if self.cuda else None

    def mark(self):
        """An event after everything launched so far (None on the CPU)."""
        if not self.cuda:
            return None
        ev = torch.cuda.Event()
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def fetch(self, t: torch.Tensor, ready) -> np.ndarray:
        if self.cuda:
            with torch.cuda.stream(self.stream):
                self.stream.wait_event(ready)
                host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                host.copy_(t, non_blocking=True)
            self.stream.synchronize()
            t = host
        return t.to(torch.float64).numpy()


def run_simulation(
    cfg: SimConfig, device="cuda:0", write_output: bool = True
) -> RunResult:
    """Execute a full run (the reference main loop, main.cpp:93-133)."""
    u, advance, dt, clamped = prepare(cfg, device)
    device = u.device
    # Record the dt actually used: the reference clamps cfg.dt in place
    # before writing metadata (main.cpp:42-49).
    cfg = dataclasses.replace(cfg, dt=dt)

    _log(
        "climate-sim-tpu\n"
        f"  grid: {cfg.nx} x {cfg.ny}  dt: {dt:g}  steps: {cfg.steps}"
        f"  D: {cfg.D:g}  v=({cfg.vx:g},{cfg.vy:g})\n"
        f"  bc: left={bc_to_string(cfg.bc.left)} right={bc_to_string(cfg.bc.right)}"
        f" bottom={bc_to_string(cfg.bc.bottom)} top={bc_to_string(cfg.bc.top)}"
    )
    dev_name = f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""
    _log(f"  device: {device}{dev_name}  path: {_path_name(advance, device)}")

    # IC sanity log (a 4-scalar fetch); also surfaces a bad IC before the
    # snapshot file is created.
    ic_stats = _field_stats(u).to("cpu", torch.float64).numpy()
    _log(f"IC min/max: {ic_stats[0]:g} / {ic_stats[1]:g}")

    copier = _HostCopier(device)

    # Warm-up outside the timed region: one 1-step pass builds and loads
    # the kernel library (first use) and brings the device up to speed.
    warmup_passes = advance.pass_count(1)
    advance(1)(u)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    timed_passes = run_pass_count(cfg, advance)

    def dispatch_span(u, k):
        for kk in span_pieces(k):
            u = advance(kk)(u)
        return u

    writer = None
    out_path = None
    if write_output and cfg.output_enable:
        out_path = cfg.resolved_output_path()
        _log("Opening NetCDF file for output")
        writer = SnapshotWriter(out_path, cfg)
    try:
        profiler = None
        if cfg.profile_dir:
            _log(f"profiler trace -> {cfg.profile_dir}")
            activities = [torch.profiler.ProfilerActivity.CPU]
            if device.type == "cuda":
                activities.append(torch.profiler.ProfilerActivity.CUDA)
            profiler = torch.profiler.profile(activities=activities)
            profiler.start()

        snapshots = 0
        diag_pending = []  # (step, on-device stats vector): fetched AFTER timing
        n = 0
        t0 = time.perf_counter()
        for k in span_lengths(cfg):
            if n % cfg.out_every == 0 and writer is not None:
                u_snap, ready = u, copier.mark()
                u = dispatch_span(u, k)  # launch the next span before the copy
                writer.write(copier.fetch(u_snap, ready))
                del u_snap
                snapshots += 1
            else:
                u = dispatch_span(u, k)
            if cfg.diagnostics_every and (n // cfg.out_every) % max(1, cfg.diagnostics_every) == 0:
                # Reductions launch now and are fetched after the timed loop.
                diag_pending.append((n + k, _field_stats(u)))
            if cfg.debug_nans and bool(torch.isnan(u).any()):
                raise FloatingPointError(f"NaN in the field after step {n + k}")
            n += k
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        total = time.perf_counter() - t0
        if profiler is not None:
            profiler.stop()
            os.makedirs(cfg.profile_dir, exist_ok=True)
            profiler.export_chrome_trace(os.path.join(cfg.profile_dir, "trace.json"))

        for step, vec in diag_pending:
            mn, mx, mean, l2 = vec.to("cpu", torch.float64).numpy()
            _log(f"diag: step={step} min={mn:.6g} max={mx:.6g} mean={mean:.6g} l2={l2:.6g}")

        if cfg.write_final and writer is not None:
            writer.write(copier.fetch(u, copier.mark()))
            snapshots += 1
    finally:
        if writer is not None:
            writer.close()

    avg_step = total / max(1, cfg.steps)
    _log(f"passes: timed={timed_passes} warmup={warmup_passes}")
    _log(f"timing: total_max={total:g} s, worst_avg_step={avg_step:g} s")
    pts = cfg.nx * cfg.ny * cfg.steps / max(total, 1e-12)
    _log(f"throughput: {pts / 1e6:.1f} Mpoint/s total, "
         f"{pts / 1e6:.1f} Mpoint/s/chip")

    return RunResult(
        u=u,
        total_time=total,
        avg_step_time=avg_step,
        steps=cfg.steps,
        snapshots_written=snapshots,
        output_path=out_path,
        dt=dt,
        clamped=clamped,
        timed_passes=timed_passes,
        warmup_passes=warmup_passes,
    )
