"""The benchmark measurement protocol of the port: the counterpart of
``climate_sim_tpu/benchproto.py``, shared by the port's tools
(``scripts/torch_*.py``) so that a protocol change lands in one place.

The workload and the window are the JAX package's (``bench_config`` and
``auto_reps`` are copies, held to the originals by the tests).  The timing
differs where the device does: there is no compile step to take out of the
timed region, so :func:`warm_up` runs one chunk and synchronises, which
builds and loads the kernel library on its first use; a card is timed with
CUDA events around ``reps`` chained chunks, the CPU with the host clock;
the best of ``trials`` is kept.

The card's published peaks (:data:`DEVICE_PEAKS`), the least time a
piece of work could take on it (:func:`bound_s`) and the work of a chunk
(:func:`chunk_work`) are here too, so that ``bench_torch.py`` and
``chip_smoke.py`` read one table.
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Tuple

import torch


class Peaks(NamedTuple):
    """A card's published peak rates."""

    bytes_per_s: float  # device memory
    f32_flop_per_s: float  # float32 outside the tensor cores
    f64_flop_per_s: float  # float64 outside the tensor cores


# Published peaks by ``torch.cuda.get_device_name()``; a card missing here
# has no figures, never another card's.
DEVICE_PEAKS = {
    # NVIDIA H100 SXM data sheet, at its 700 W limit: HBM3 3.35 TB/s,
    # FP32 67 TFLOP/s, FP64 34 TFLOP/s.
    "NVIDIA H100 80GB HBM3": Peaks(3.35e12, 67e12, 34e12),
}

FLOPS_PER_POINT_STEP = 9  # the stencil's five products and four sums


def peaks(card: str) -> Peaks:
    """The published peaks of the card named ``card`` (as
    ``torch.cuda.get_device_name`` gives it).  Raises ``ValueError``
    naming the card when the table does not hold it."""
    if card not in DEVICE_PEAKS:
        raise ValueError(f"no published peaks for the card {card!r}; known: "
                         f"{sorted(DEVICE_PEAKS)}")
    return DEVICE_PEAKS[card]


def bound_s(nbytes: float, flops: float, dtype: torch.dtype, card: str) -> Tuple[float, str]:
    """(least seconds the card named ``card`` could take, what sets it):
    ``nbytes`` over the memory rate, or ``flops`` over the peak rate of
    ``dtype``'s arithmetic, whichever is longer.  bfloat16 is storage only
    (its steps compute in float32), so it takes the float32 rate."""
    p = peaks(card)
    t_bytes = nbytes / p.bytes_per_s
    t_ops = flops / (p.f64_flop_per_s if dtype == torch.float64 else p.f32_flop_per_s)
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


class ChunkWork(NamedTuple):
    """The work of one ``chunk``-step program on the global field."""

    field_bytes: int  # one read and one write of the field: all a chunk must move
    flops: int  # the stencil's operations over every point and step
    passes: int  # K1 passes of the port's pass schedule
    pass_bytes: int  # each of those passes reading and writing the field


def chunk_work(cfg, chunk: int, dtype: torch.dtype) -> ChunkWork:
    """The work of one ``chunk``-step program.  The roofline of a chunk is
    ``bound_s(field_bytes, flops, ...)``: the work the function needs,
    whatever the code under test does.  ``bound_s(pass_bytes, flops, ...)``
    is the bound of the K1 pass schedule, which moves with the steps a pass
    the port chooses, so it is no roofline."""
    from .ops.cuda_stencil import pass_schedule

    points = cfg.nx * cfg.ny
    field_bytes = 2 * torch.empty((), dtype=dtype).element_size() * points
    passes = len(pass_schedule(cfg, chunk))
    return ChunkWork(field_bytes, FLOPS_PER_POINT_STEP * points * chunk, passes,
                     passes * field_bytes)


def bench_config(nx: int, ny: int, chunk: int):
    """The canonical benchmark workload: diffusion+advection with mixed BCs
    (all three BC kinds exercised; matches BASELINE.json config #3)."""
    from .config import BCConfig, BCType, SimConfig

    cfg = SimConfig(nx=nx, ny=ny, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                    steps=chunk, out_every=chunk)
    cfg.bc = BCConfig(left=BCType.DIRICHLET, right=BCType.NEUMANN,
                      bottom=BCType.PERIODIC, top=BCType.PERIODIC)
    return cfg


def auto_reps(nx: int, ny: int, chunk: int,
              window_points: int = 200_000_000_000) -> int:
    """Chained chunks per sync for a window of ``window_points`` grid-point
    updates (the JAX package's window-matched protocol: at least 3, enough
    that the sync after the window weighs little)."""
    return max(3, -(-window_points // (nx * ny * chunk)))


def cuda_devices(u) -> List[torch.device]:
    """The distinct CUDA devices of ``u``: a tensor, or a grid of tiles
    (lists of tensors, None for another rank's tile)."""
    if isinstance(u, torch.Tensor):
        return [u.device] if u.device.type == "cuda" else []
    out = []
    for part in u or ():
        if part is not None:
            out += [d for d in cuda_devices(part) if d not in out]
    return out


def sync(u) -> None:
    """Wait for the work queued on the cards that hold ``u``; nothing on
    the CPU, whose work is done when the call returns."""
    for d in cuda_devices(u):
        torch.cuda.synchronize(d)


def warm_up(fn: Callable, u):
    """One chunk, synchronised: the kernel library's build and load on its
    first use, outside any timed region.  Returns the advanced state; an
    exception propagates."""
    u = fn(u)
    sync(u)
    return u


def time_best_of(fn: Callable, u, reps: int, trials: int) -> Tuple[float, object]:
    """One warm-up call, then ``trials`` windows of ``reps`` chained calls;
    returns ``(best_seconds, final_u)``.  On cards a window is read from
    CUDA events recorded on each card's current stream before the first
    call and after the last (the longest card's time); on the CPU from the
    host clock."""
    u = warm_up(fn, u)
    devices = cuda_devices(u)
    best = float("inf")
    for _trial in range(trials):
        if devices:
            marks = []
            for d in devices:
                start = torch.cuda.Event(enable_timing=True)
                start.record(torch.cuda.current_stream(d))
                marks.append((d, start))
            for _ in range(reps):
                u = fn(u)
            seconds = 0.0
            for d, start in marks:
                stop = torch.cuda.Event(enable_timing=True)
                stop.record(torch.cuda.current_stream(d))
                stop.synchronize()
                seconds = max(seconds, start.elapsed_time(stop) / 1e3)
        else:
            t0 = time.perf_counter()
            for _ in range(reps):
                u = fn(u)
            seconds = time.perf_counter() - t0
        best = min(best, seconds)
    return best, u
