"""Run driver: the analogue of the reference's main()
(reference: src/main.cpp:23-138), ported from ``climate_sim_tpu/runtime/driver.py``.

Flow: config -> CFL clamp with warning -> banner -> IC -> IC min/max log ->
open snapshot file -> time loop with pre-update snapshots at
``n % out_every == 0`` -> ``timing: total_max=<s> s, worst_avg_step=<s> s``
(greppable by the benchmark harness, reference: run_benchmark.sh:34-39).
Each phase is a span of :mod:`.tracing` (``climate.call``, ``.prepare``,
``.ic_stats``, ``.capture``, ``.warmup``, ``.loop``, ``.finish``), recorded
inside ``tracing.collect()`` and with ``profile_dir``, whose
``torch.profiler`` trace then carries them as annotations beside the
card's kernels; ``climate.loop`` is the interval ``timing:`` measures.

The time loop is chunked: each span between snapshot points is dispatched
as pieces of at most 256 steps, each piece a chain of kernel passes (or of
torch-ops steps on the plain path).  On a mesh of CUDA cards in one
process (one graph spans them) and on NCCL ranks of one card each, a piece
is one replay of a CUDA graph, captured for each piece length before the
timed loop as the JAX driver compiles its chunk programs (:mod:`.graphs`;
a ``graph:`` line each, with its seconds and the memory it added on each
card); elsewhere it is dispatched pass by pass.
On CUDA the launches are asynchronous, so a snapshot is taken by launching
the next span first and then copying the held field to the host on a side
stream; every kernel writes a fresh output tensor, never its input, and a
replayed chunk copies its input into the graph's own tensors and returns
fresh copies of its output, so the held snapshot stays valid while the
span runs (the carrier path's staging writes pad lines of its input in
place, and the copier reads only the true extent).

Devices, as in the JAX package (driver.py:281-287): the caller names a list
of torch devices (a device may repeat), ``max_devices`` keeps the first N,
and a mesh of tiles exists iff ``mesh.enable`` and more than one device
remains.  On a mesh the field is a grid of tiles (:mod:`..parallel`).  A
grid the mesh divides runs the slab path (K4), or the overlap path (K3)
with ``halo_overlap: true``.  A grid it does not divide takes the JAX
routing (driver.py:301-324, :358-404): with a kernel selected, the carrier
path (K5), whose carrier tiles are the loop state while everything the
driver reads (IC min/max, ``diag:`` lines, ``debug_nans``, snapshots,
``RunResult.u``) sees only the true (ny, nx) extent; else, or when the
carrier declines (with a ``[warn]``), the per-step path on the reference's
remainder tiles.  A mesh's IC is built per tile from global coordinates
(:func:`..ops.init.device_initial_condition`) and its snapshots are written
per tile (:class:`..io.snapshots.ShardedSnapshotWriter`).

Multi-process runs (``distributed``, :mod:`.distributed`): every rank names
its own devices (by default its card, ``cuda:(local_rank % count)``), the
mesh is laid out over all ranks' devices in rank order, and each rank runs
and writes only its own tiles.  The controller (rank 0) prints the log,
creates the snapshot file before a bounded barrier after which the other
ranks attach; IC and diagnostic statistics, ``debug_nans`` and the wall
time (the MAX over ranks) are reduced across ranks; ``RunResult.u`` is the
rank's own tile grid, never a gather.

Kept apart from the JAX routing on purpose, because each JAX branch answers
a TPU layout limit or measurement that does not carry over:

* a single device runs K1 for every shape (the JAX 1x1-carrier dispatch,
  driver.py:405-430, exists because the TPU's fused layout declines
  misaligned widths);
* a grid the mesh divides keeps K4 even when its tiles are misaligned
  (JAX driver.py:342-348 prefers the carrier there for the same reason);
* ``halo_overlap: auto`` stays off and k stays 8 across ranks: the JAX
  rule for meshes that cross DCN granules (driver.py:172-213) is a TPU
  measurement.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import sys
import time
import traceback
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..config import SimConfig, bc_to_string
from ..io.snapshots import ShardedSnapshotWriter, SnapshotWriter
from ..ops.init import DTYPES, apply_initial_condition, device_initial_condition
from ..ops.stability import clamp_dt, combined_dt_limit
from ..ops.step import (
    KERNEL_VALUES,
    build_single_device_advance,
    make_interior_step,
    select_kernel,
)
from ..parallel.halo import (
    build_carrier_slab_advance,
    build_padded_advance,
    build_sharded_advance,
    build_sharded_multistep_advance,
    build_sharded_overlap_advance,
)
from ..parallel.mesh import (
    choose_mesh_shape,
    divisible,
    gather_field,
    local_windows,
    make_mesh,
)
from . import distributed, graphs, tracing

# Longest piece of a span dispatched as one chunk program.  Kept from the
# JAX package (driver.py:521-529) so both packages run the same pass
# schedule and, in bf16, round at the same steps.
MAX_DISPATCH = 256


@dataclasses.dataclass
class RunResult:
    u: object               # final state: the global tensor, or this rank's tile grid
    total_time: float
    avg_step_time: float
    steps: int
    snapshots_written: int
    output_path: Optional[str]
    mesh_shape: Optional[tuple]  # (py, px) on a mesh, else None
    dt: float
    clamped: bool
    timed_passes: int       # advance passes in the timed loop (per tile)
    warmup_passes: int      # untimed passes before it


def _log(msg: str) -> None:
    if distributed.is_controller():
        print(msg, flush=True)


def _warn(msg: str) -> None:
    if distributed.is_controller():
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


def visible_cuda_devices() -> List[torch.device]:
    """Every visible CUDA device (the JAX package's ``jax.devices()``);
    raises when there is none."""
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no device named and torch.cuda.is_available() is False"
        )
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def resolve_devices(devices) -> List[torch.device]:
    """The run's device list: ``devices`` (a list, or one device), else
    every visible CUDA device (a rank of a multi-process run: its own
    card).  All of one type, each checked by :func:`resolve_device`."""
    if devices is None:
        devs = distributed.default_devices() if distributed.initialized() \
            else visible_cuda_devices()
    elif isinstance(devices, (str, torch.device)):
        devs = [devices]
    else:
        devs = list(devices)
    if not devs:
        raise ValueError("the device list is empty")
    devs = [resolve_device(d) for d in devs]
    if len({d.type for d in devs}) > 1:
        raise ValueError(f"devices {devs}: all cuda or all cpu")
    return devs


def resolve_auto_policies(cfg: SimConfig) -> SimConfig:
    """Resolve ``halo_overlap="auto"`` as the JAX package does
    (driver.py:172-213) for a mesh that crosses no DCN granule: overlap
    off.  Across ranks too: the JAX rule that turns it on (and k to 16)
    for meshes that cross granules is a TPU measurement.
    ``steps_per_pass=0`` stays 0 (``pick_steps_per_pass`` applies the
    on-chip default 8)."""
    if cfg.halo_overlap == "auto":
        cfg = dataclasses.replace(cfg, halo_overlap=False)
    return cfg


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


def chunk_lengths(cfg: SimConfig) -> List[int]:
    """The distinct piece lengths the timed loop dispatches, ascending: the
    chunk programs the JAX driver compiles before its loop (driver.py:535-547
    there), and the chunks this driver captures before its own."""
    return sorted({kk for k in span_lengths(cfg) for kk in span_pieces(k)})


def run_pass_count(cfg: SimConfig, advance) -> int:
    """Passes the timed loop makes: one bf16 rounding event each."""
    return sum(
        advance.pass_count(kk)
        for k in span_lengths(cfg) for kk in span_pieces(k)
    )


def _local(u) -> List[torch.Tensor]:
    """This process's tiles of a field (one tensor, or a tile grid)."""
    if not isinstance(u, list):
        return [u]
    return [t for row in u for t in row if t is not None]


def _field_stats(u) -> Optional[torch.Tensor]:
    """[min, max, sum, sum of squares] of this process's part of a field,
    ONE vector on its first tile's device (None without a tile); read it
    with :func:`_read_stats`."""
    tiles = _local(u)
    if not tiles:
        return None
    dev = tiles[0].device
    parts = []
    for t in tiles:
        af = t.to(torch.float32) if t.dtype == torch.bfloat16 else t
        parts.append(torch.stack([af.min(), af.max(), af.sum(), torch.sum(af * af)]).to(dev))
    p = torch.stack(parts)
    return torch.stack([p[:, 0].min(), p[:, 1].max(), p[:, 2].sum(), p[:, 3].sum()])


def _read_stats(vec: Optional[torch.Tensor], points: int) -> np.ndarray:
    """[min, max, mean, l2] of the whole field from every rank's
    :func:`_field_stats` (reduced across ranks on the host)."""
    v = [np.inf, -np.inf, 0.0, 0.0] if vec is None else \
        vec.to("cpu", torch.float64).tolist()
    lo = distributed.reduce([-v[0], v[1]], "max")
    s = distributed.reduce(v[2:], "sum")
    return np.array([-lo[0], lo[1], s[0] / points, np.sqrt(s[1])])


def _path_name(advance, device: torch.device) -> str:
    kernel = advance.kernel
    if kernel is None:
        what = "torch ops per step"
    elif device.type == "cuda":
        what = f"{kernel} CUDA kernel"
    else:
        what = f"{kernel} plain version"
    path = getattr(advance, "path", None)
    name = f"{path}, {what}" if path else what
    if not hasattr(advance, "eager_why"):
        return name
    why = advance.eager_why
    return f"{name}, {'chunks as CUDA graphs' if why is None else f'eager chunks ({why})'}"


def _start_profiler(cfg: SimConfig, device: torch.device, world: int):
    """None without ``cfg.profile_dir``; else a started ``torch.profiler``
    in its warm-up step (traced, then dropped), whose next step, ended by
    ``stop()``, is written to ``trace.json`` (``trace_rank<r>.json`` on
    rank r of several) under the directory.  The trace carries the
    program's spans (:mod:`.tracing`, on for such a call) as
    ``user_annotation`` events: ``climate.loop`` around the timed loop."""
    if not cfg.profile_dir:
        return None
    _log(f"profiler trace -> {cfg.profile_dir}")
    os.makedirs(cfg.profile_dir, exist_ok=True)
    name = "trace.json" if world == 1 else f"trace_rank{distributed.rank()}.json"
    path = os.path.join(cfg.profile_dir, name)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if device.type == "cuda":
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(
        activities=activities,
        schedule=torch.profiler.schedule(wait=0, warmup=1, active=1, repeat=1),
        on_trace_ready=lambda prof: prof.export_chrome_trace(path))
    profiler.start()
    return profiler


def _mesh_advance(cfg: SimConfig, mesh, dt: float, device: torch.device):
    """The advance on a mesh: the divisible-grid paths, else the carrier
    or the remainder-tile per-step path (JAX driver.py:301-404)."""
    kernel = select_kernel(cfg, device)
    if divisible(mesh, cfg.nx, cfg.ny):
        if kernel not in KERNEL_VALUES:
            return build_sharded_advance(cfg, mesh, dt, make_interior_step(cfg, dt))
        advance = build_sharded_overlap_advance(cfg, mesh, dt) if cfg.halo_overlap else None
        return advance or build_sharded_multistep_advance(cfg, mesh, dt)
    grid = f"grid {cfg.nx}x{cfg.ny}"
    on = f"on the {mesh.shape['x']}x{mesh.shape['y']} mesh"
    if kernel in KERNEL_VALUES:
        advance = build_carrier_slab_advance(cfg, mesh, dt)
        if advance is not None:
            ncy, ncx = advance.carrier_shape
            _log(f"[info] {grid} has no uniform tiles {on}; running the CARRIER"
                 f" path ({ncx}x{ncy} carrier, true edges at runtime flags)")
            return advance
        _warn(f"[warn] kernel={kernel} requested but the {grid} fits no carrier"
              f" layout {on}: downgrading to the per-step remainder-tile path"
              " (one K2 launch per tile and step) -- benchmark numbers from this"
              " run are NOT carrier-path numbers")
    else:
        _log(f"[info] {grid} has no uniform tiles {on}; running the per-step"
             " remainder-tile path (torch ops)")
    return build_padded_advance(dataclasses.replace(cfg, kernel=kernel), mesh, dt)


def _make_run_mesh(cfg: SimConfig, devs: List[torch.device]):
    """The mesh over the global device list (every rank's devices in rank
    order, cut to ``max_devices``), with its transport across ranks; None
    for one device."""
    entries = distributed.global_devices(devs)
    if cfg.max_devices:
        entries = entries[: cfg.max_devices]
    if not (cfg.mesh.enable and len(entries) > 1):
        if distributed.world_size() > 1:
            raise ValueError(
                f"a {distributed.world_size()}-process run needs a mesh: mesh.enable"
                f" and more than one device over the ranks (have {len(entries)})"
            )
        return None
    px, py = choose_mesh_shape(len(entries), cfg.nx, cfg.ny, cfg.mesh.x, cfg.mesh.y)
    owners, names, chips = zip(*entries)
    mesh = make_mesh(px, py, names, owners, distributed.rank(), chips)
    if distributed.world_size() > 1:
        mesh.transport = distributed.make_transport(mesh)
    return mesh


def prepare(cfg: SimConfig, devices=None):
    """Resolve the process group, devices, mesh, dtype, dt clamp, advance
    and IC.

    Returns (u0, advance, mesh, dt, clamped).  ``advance(k)`` advances the
    field k steps: the global tensor on one device (``mesh`` None), or this
    process's tiles of the mesh's grid (carrier tiles on the carrier path,
    whose ``advance.extract`` gives the true extent).
    """
    with tracing.span("climate.prepare"):
        distributed.maybe_init_distributed(cfg)
        devs = resolve_devices(devices)
        dtype = DTYPES[cfg.precision]

        dt, limit, clamped = clamp_dt(cfg.dt, cfg.dx, cfg.dy, cfg.vx, cfg.vy, cfg.D)
        if clamped:
            # rank-0 warning, like the reference (main.cpp:44-47)
            _warn(
                f"[warn] dt={cfg.dt:g} exceeds stability limit {limit:g}"
                f" -> clamping to dt={dt:g}"
            )
        mesh = _make_run_mesh(cfg, devs)
        cfg = resolve_auto_policies(cfg)
        if mesh is None:
            advance = build_single_device_advance(cfg, dt, devs[0])
        else:
            advance = _mesh_advance(cfg, mesh, dt, devs[0])
        if cfg.precision == "bf16":
            # bf16 storage mode rounds once per pass of the advance actually
            # chosen: once per k-step kernel pass, once per step on the plain
            # and per-step paths.
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
        if mesh is None:
            u0 = apply_initial_condition(cfg, dtype, devs[0]).contiguous()
        else:
            # Per tile, so that no rank builds or reads the (ny, nx) field; a
            # failure (a bad IC file) raises on every rank together.
            err = None
            try:
                u0 = device_initial_condition(cfg, dtype, mesh,
                                              getattr(advance, "embed_from", None))
            except Exception as e:
                err = e
            distributed.raise_together(err, "the initial condition")
        return u0, advance, mesh, dt, clamped


def _view_offsets(advance, mesh, cfg: SimConfig) -> Dict[Tuple[int, int], Tuple[int, int]]:
    """The global (y0, x0) of each local tile of the field's true-extent
    view: every tile of a mesh, or the carrier tiles that hold true cells."""
    if mesh is None:
        return {(0, 0): (0, 0)}
    windows = getattr(advance, "windows", None) or local_windows(mesh, cfg.ny, cfg.nx)
    return {yx: (w[0], w[2]) for yx, w in windows.items()}


class _HostCopier:
    """Copies this process's part of a snapshot to the host while the next
    span runs: on CUDA each tile's copy waits on an event recorded on its
    device before the span's launch and runs on that device's side stream
    into pinned memory.  The regions go to the writer as they are: no
    process assembles the global array."""

    def __init__(self, devices: List[torch.device]):
        self.streams = {d: torch.cuda.Stream(d) for d in devices if d.type == "cuda"}

    def mark(self):
        """Per device, an event after everything launched so far (empty on
        the CPU)."""
        events = {}
        for d in self.streams:
            events[d] = torch.cuda.Event()
            events[d].record(torch.cuda.current_stream(d))
        return events

    def fetch(self, regions, ready) -> List[Tuple[int, int, np.ndarray]]:
        """``(y0, x0, tensor)`` regions as ``(y0, x0, float64 array)``."""
        hosts = []
        for y0, x0, t in regions:
            if t.device.type == "cuda":
                stream = self.streams[t.device]
                with torch.cuda.stream(stream):
                    stream.wait_event(ready[t.device])
                    host = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
                    host.copy_(t, non_blocking=True)
                t = host
            hosts.append((y0, x0, t))
        for stream in self.streams.values():
            stream.synchronize()
        return [(y0, x0, t.to(torch.float64).numpy()) for y0, x0, t in hosts]


def _synchronize(devices: List[torch.device]) -> None:
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _open_writer(cfg: SimConfig, mesh, path: str):
    """A whole-field writer for one device; on a mesh a region writer that
    the controller creates and the other ranks attach to after a bounded
    barrier (JAX driver.py:481-503)."""
    if mesh is None:
        return SnapshotWriter(path, cfg)
    writer = None
    if distributed.is_controller():
        try:
            writer = ShardedSnapshotWriter(path, cfg, create=True)
        except Exception:
            # The peers wait in the barrier below until it fails; put the
            # real error (disk full, permissions, ...) on this rank's stderr
            # before theirs masks it.
            if distributed.world_size() > 1:
                traceback.print_exc()
            raise
    distributed.bounded_sync("climate_sim_tpu:snapshot_open")
    if writer is None:
        writer = ShardedSnapshotWriter(path, cfg, create=False)
    return writer


def run_simulation(
    cfg: SimConfig, devices=None, write_output: bool = True
) -> RunResult:
    """Execute a full run (the reference main loop, main.cpp:93-133) on
    ``devices`` (a list of torch devices, or one; default every visible
    CUDA device, or this rank's card in a multi-process run).  The call is
    the span ``climate.call``; with ``profile_dir`` tracing is on for it,
    so that the profiler's trace carries the program's spans."""
    with tracing.collect() if cfg.profile_dir else contextlib.nullcontext(), \
            tracing.span("climate.call"):
        return _run(cfg, devices, write_output)


def _run(cfg: SimConfig, devices, write_output: bool) -> RunResult:
    u, advance, mesh, dt, clamped = prepare(cfg, devices)
    used = mesh.distinct_devices() if mesh is not None else [u.device]
    device = used[0] if used else torch.device("cpu")
    world = distributed.world_size()
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
    if mesh is not None:
        _log(f"  mesh: x={mesh.shape['x']} y={mesh.shape['y']} ({mesh.size} devices)")
    if world > 1:
        _log(f"  ranks: {world}  transport: {mesh.transport.describe()}")
    names = ", ".join(
        f"{d} ({torch.cuda.get_device_name(d)})" if d.type == "cuda" else str(d)
        for d in used
    )
    _log(f"  device: {names}  path: {_path_name(advance, device)}")

    # The carrier path's loop state is its carrier tiles; everything read
    # below sees the true extent only.
    view = getattr(advance, "extract", None) or (lambda x: x)
    offsets = _view_offsets(advance, mesh, cfg)
    points = cfg.nx * cfg.ny

    def regions(field):
        if mesh is None:
            return [(0, 0, field)]
        return [(*offsets[(y, x)], field[y][x]) for y, x in offsets]

    # IC sanity log (a 4-scalar fetch); also surfaces a bad IC before the
    # snapshot file is created.
    with tracing.span("climate.ic_stats"):
        ic_stats = _read_stats(_field_stats(view(u)), points)
    _log(f"IC min/max: {ic_stats[0]:g} / {ic_stats[1]:g}")

    copier = _HostCopier(used)

    # Outside the timed region, as the JAX driver compiles every chunk
    # program before its loop: every chunk length the loop dispatches is
    # captured (a captured mesh advance; no-op otherwise), then one eager
    # 1-step pass builds and loads the kernel library (first use) and
    # brings the device up to speed, so neither counts in ``timing:``.
    # With ``profile_dir`` the profiler starts before that pass, in a
    # warm-up step that is traced and dropped, so the trace holds the timed
    # loop alone, without the profiler's start-up cost.
    with tracing.span("climate.capture"):
        for kk in chunk_lengths(cfg):
            chunk = advance(kk)
            if isinstance(chunk, graphs.GraphedChunk):
                done = chunk.capture(u)
                added = ", ".join(f"{d} {n / 2**20:+.1f} MiB" for d, n in done.memory.items())
                _log(f"  graph: {kk}-step chunk captured in {done.seconds:.3f} s over"
                     f" {len(mesh.distinct_devices())} card(s); memory added: {added or 'none'}")
    profiler = _start_profiler(cfg, device, world)
    warmup_passes = advance.pass_count(1)
    with tracing.span("climate.warmup"), graphs.disable_graphs():
        advance(1)(u)
        _synchronize(used)
    if profiler is not None:
        profiler.step()
    timed_passes = run_pass_count(cfg, advance)

    def dispatch_span(u, k):
        for kk in span_pieces(k):
            u = advance(kk)(u)
        return u

    def emit(field, ready):
        host = copier.fetch(regions(field), ready)
        if mesh is None:
            writer.write(host[0][2])
        else:
            writer.write_shards(host)

    writer = None
    out_path = None
    if write_output and cfg.output_enable:
        out_path = cfg.resolved_output_path()
        _log("Opening NetCDF file for output")
        writer = _open_writer(cfg, mesh, out_path)
    try:
        snapshots = 0
        diag_pending = []  # (step, on-device stats vector): fetched AFTER timing
        n = 0
        # ``timing:`` and the span share their two clock readings.
        with tracing.span("climate.loop") as loop:
            t0 = time.perf_counter_ns()
            for k in span_lengths(cfg):
                if n % cfg.out_every == 0 and writer is not None:
                    u_snap, ready = view(u), copier.mark()
                    u = dispatch_span(u, k)  # launch the next span before the copy
                    emit(u_snap, ready)
                    del u_snap
                    snapshots += 1
                else:
                    u = dispatch_span(u, k)
                if cfg.diagnostics_every and (n // cfg.out_every) % max(1, cfg.diagnostics_every) == 0:
                    # Reductions launch now and are fetched after the timed loop.
                    diag_pending.append((n + k, _field_stats(view(u))))
                if cfg.debug_nans:
                    nan = any(bool(torch.isnan(t).any()) for t in _local(view(u)))
                    # Every rank stops together, so no peer waits in an exchange.
                    if distributed.reduce([float(nan)], "max")[0]:
                        raise FloatingPointError(f"NaN in the field after step {n + k}")
                n += k
            _synchronize(used)
            t1 = time.perf_counter_ns()
            loop.at(t0, t1)
        total = (t1 - t0) / 1e9
        if profiler is not None:
            profiler.stop()  # writes the trace

        with tracing.span("climate.finish"):
            for step, vec in diag_pending:
                mn, mx, mean, l2 = _read_stats(vec, points)
                _log(f"diag: step={step} min={mn:.6g} max={mx:.6g} mean={mean:.6g} l2={l2:.6g}")

            if cfg.write_final and writer is not None:
                emit(view(u), copier.mark())
                snapshots += 1
            # Closed inside the span; the ``finally`` below closes a writer
            # only when something raised before this line.
            closing, writer = writer, None
            if closing is not None:
                closing.close()

            # MPI_Reduce(MAX) analogue (main.cpp:127-128): the slowest rank's wall.
            total = float(distributed.reduce([total], "max")[0])
            avg_step = total / max(1, cfg.steps)
            _log(f"passes: timed={timed_passes} warmup={warmup_passes}")
            _log(f"timing: total_max={total:g} s, worst_avg_step={avg_step:g} s")
            # Per chip = per DISTINCT card, over every rank: a 2x2 mesh on one
            # card, or four ranks sharing it, is one chip, not four.
            pts = points * cfg.steps / max(total, 1e-12)
            chips = mesh.chip_count() if mesh is not None else 1
            _log(f"throughput: {pts / 1e6:.1f} Mpoint/s total, "
                 f"{pts / 1e6 / chips:.1f} Mpoint/s/chip")

            if mesh is None:
                final = u
            elif world > 1:
                final = view(u)
            else:
                final = gather_field(view(u))
    finally:
        if writer is not None:
            writer.close()
    return RunResult(
        u=final,
        total_time=total,
        avg_step_time=avg_step,
        steps=cfg.steps,
        snapshots_written=snapshots,
        output_path=out_path,
        mesh_shape=(mesh.shape["y"], mesh.shape["x"]) if mesh is not None else None,
        dt=dt,
        clamped=clamped,
        timed_passes=timed_passes,
        warmup_passes=warmup_passes,
    )
