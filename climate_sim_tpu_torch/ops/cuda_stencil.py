"""K1, the multi-step stencil kernel, and the advance built on it.

The port of ``climate_sim_tpu/ops/pallas_stencil.py``'s single-device path:
``multistep_kernel_step`` advances the global (ny, nx) field ``k`` steps in
one pass of the hand-written CUDA kernel ``csrc/multistep_stencil.cu``, and
``build_multistep_advance`` chains such passes into chunk programs.

The update is linear with config-constant coefficients, so one Euler step
collapses to a 5-point weighted stencil (:func:`_stencil_weights`).  The
kernel streams column bands of the field down their rows with the k
sub-steps pipelined one row apart (:func:`k1_geometry` sizes the bands and
says how many columns a thread holds) and re-pins the physical-edge ghosts
at every sub-step, so one pass equals
``k`` iterations of ``pad_with_ghosts`` + the weighted stencil
(:func:`multistep_pass_plain`) for every grid shape, BC mix and dtype; it
never declines, and the advance has no per-pass fallback.

bf16 is a storage mode: f32 arithmetic, one rounding per pass.
"""

from __future__ import annotations

import contextlib
import functools
from typing import Callable, List, NamedTuple

import torch

from ..config import BCType, SimConfig
from ..runtime import tracing
from ._build import core_constants
from .boundary import pad_with_ghosts

# Side codes of the C interface (csrc/multistep_stencil.cu).
_FIX_NONE, _FIX_DIRICHLET, _FIX_NEUMANN, _FIX_ZERO = 0, 1, 2, 3
_DTYPE_CODES = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
_DTYPE_NAMES = {torch.float32: "f32", torch.float64: "f64", torch.bfloat16: "bf16"}
MAX_STEPS_PER_PASS = 32
# The core's limits (csrc/stencil_core.cuh, read from the header).
_CORE = core_constants()
# The widest band of the one-column body: window columns, one thread
# each, of a block.
MAX_BAND = _CORE["MAX_BAND"]
# The H100's SMs; blocks a pass should have at least: two on each.
SMS = 132
MIN_BLOCKS = 2 * SMS
# K1's wide body: window columns a thread by storage type, threads a block
# at most, the warps an SM holds of it (its launch bounds keep every
# instantiation to WIDE_MIN_BLOCKS blocks of WIDE_THREADS an SM), and the
# deepest pass it runs.
WIDE_COLUMNS = {torch.float32: _CORE["WIDE_COLS"], torch.bfloat16: _CORE["WIDE_COLS"],
                torch.float64: _CORE["WIDE_COLS_F64"]}
WIDE_THREADS = _CORE["WIDE_THREADS"]
WIDE_WARPS_PER_SM = _CORE["WIDE_MIN_BLOCKS"] * WIDE_THREADS // 32
WIDE_MAX_STEPS = _CORE["FAST_MAX"]
# Output rows a wide segment has at least (or the whole height).
WIDE_MIN_ROWS = 4


class BandGeometry(NamedTuple):
    """How the core cuts an (ny, nx) output for a k-step pass: ``width``
    window columns a band (the block's threads; ``width - 2k`` of them are
    output), ``rows`` output rows a segment (the last may be shorter), and
    the grid of ``bands`` x ``segments`` blocks."""

    width: int
    rows: int
    bands: int
    segments: int


@functools.lru_cache(maxsize=256)
def band_geometry(ny: int, nx: int, k: int) -> BandGeometry:
    """The band geometry the kernels run an (ny, nx) output with at pass
    size k: bands 16k columns wide rounded up to a multiple of 32 (so the
    2k halo columns cost at most an eighth; the core takes whole warps),
    at least 128 and at most MAX_BAND, narrowed to the multiple of 32 that
    holds the whole width with its halo when that is less;
    segments of 8k rows (at least 16), at most ny.  On the H100 these
    beat wider bands and taller segments for k = 1 and 8 (more resident
    blocks per SM hide the barrier and load latency of each row).  A
    shape that gives fewer than MIN_BLOCKS blocks (a small grid, K3's
    k-wide bands) halves its segments, down to 8 rows, then narrows its
    bands, down to 32 columns, until it has them."""
    if not (1 <= k <= MAX_STEPS_PER_PASS and ny >= 1 and nx >= 1):
        raise ValueError(f"no band geometry for ({ny}, {nx}) at k={k}")

    def blocks(width, rows):
        return -(-nx // (width - 2 * k)) * -(-ny // rows)

    width = min(-(-max(128, 16 * k) // 32) * 32, MAX_BAND, -(-(nx + 2 * k) // 32) * 32)
    rows = min(ny, max(16, 8 * k))
    while blocks(width, rows) < MIN_BLOCKS:
        if rows > 8:
            rows = max(8, -(-rows // 16) * 8)
        elif width - 32 > 2 * k:
            width -= 32
        else:
            break
    return BandGeometry(width, rows, -(-nx // (width - 2 * k)), -(-ny // rows))


class K1Geometry(NamedTuple):
    """K1's cut of an (ny, nx) field for a k-step pass: :class:`BandGeometry`'s
    fields, ``width`` in window columns, and ``cpt`` window columns a thread
    (1: the one-column body at :func:`band_geometry`'s geometry)."""

    width: int
    rows: int
    bands: int
    segments: int
    cpt: int


def wide_geometry(ny: int, nx: int, k: int, cpt: int, threads: int,
                  blocks_per_sm: int = 0) -> K1Geometry:
    """The wide body's geometry with ``threads`` threads a block: as many
    segments as make one wave of ``blocks_per_sm`` blocks on every SM (by
    default the blocks of this size that make WIDE_WARPS_PER_SM warps), at
    least WIDE_MIN_ROWS rows each, at most the height."""
    width = threads * cpt
    bands = -(-nx // (width - 2 * k))
    per_sm = blocks_per_sm or WIDE_WARPS_PER_SM // (threads // 32)
    segments = max(1, min(ny // WIDE_MIN_ROWS, SMS * per_sm // bands))
    rows = -(-ny // segments)
    return K1Geometry(width, rows, bands, -(-ny // rows), cpt)


def wide_cost(g: K1Geometry, k: int) -> int:
    """A wide cut's time, in units of one warp's issue for a row: each of
    a segment's window rows costs the busiest SM its warps' issue (whole
    blocks, spread evenly over the SMS) plus, in each wave of up to
    WIDE_WARPS_PER_SM warps, the latency of the row's chain through the
    k levels, which is worth about WIDE_WARPS_PER_SM warps' issue.  So the
    chain sets the pace of a grid that leaves SMs few warps, and a taller
    segment (fewer lead-in rows) pays only where the SMs are full.  Fitted
    on the H100 to K1's times from 256² to 4096² (PERF.md)."""
    warps = -(-g.bands * g.segments // SMS) * (g.width // g.cpt // 32)
    waves = -(-warps // WIDE_WARPS_PER_SM)
    return (g.rows + 2 * k) * (warps + waves * WIDE_WARPS_PER_SM)


@functools.lru_cache(maxsize=256)
def k1_geometry(ny: int, nx: int, k: int, dtype: torch.dtype) -> K1Geometry:
    """The geometry K1 runs an (ny, nx) field with at pass size k.

    Up to WIDE_MAX_STEPS steps, the wide body: WIDE_COLUMNS[dtype] columns
    a thread, and of the blocks of whole warps (at most WIDE_THREADS) in
    one wave of 1, 2, ... blocks an SM (:func:`wide_geometry`, up to
    WIDE_WARPS_PER_SM warps) the cut of least :func:`wide_cost`; on a tie
    the narrower block, then the fewer blocks.  Bands wider than the
    field's width with its halo are not tried.  Deeper passes (whose
    levels do not fit the registers of several columns) take the
    one-column body at :func:`band_geometry`'s geometry."""
    if not (1 <= k <= MAX_STEPS_PER_PASS and ny >= 1 and nx >= 1):
        raise ValueError(f"no band geometry for ({ny}, {nx}) at k={k}")
    if k > WIDE_MAX_STEPS:
        return K1Geometry(*band_geometry(ny, nx, k), 1)
    cpt = WIDE_COLUMNS[dtype]
    best = None
    for threads in range(32, WIDE_THREADS + 1, 32):
        if threads * cpt <= 2 * k:
            continue
        for per_sm in range(1, WIDE_WARPS_PER_SM // (threads // 32) + 1):
            g = wide_geometry(ny, nx, k, cpt, threads, per_sm)
            if best is None or wide_cost(g, k) < wide_cost(best, k):
                best = g
        if threads * cpt - 2 * k >= nx:  # one band holds the width: wider ones only cost
            break
    return best


@functools.lru_cache(maxsize=256)
def k1_cut_counter(ny: int, nx: int, k: int, dtype: torch.dtype) -> str:
    """The counter that K1's launches at this cut add to while tracing is
    on: ``k1.cut.<dtype>.k<k>.c<columns a thread>.t<block threads>
    .b<bands>.s<segments>.r<rows>``, from :func:`k1_geometry`, so that a
    trace says which cut ran."""
    g = k1_geometry(ny, nx, k, dtype)
    return (f"k1.cut.{_DTYPE_NAMES[dtype]}.k{k}.c{g.cpt}.t{g.width // g.cpt}"
            f".b{g.bands}.s{g.segments}.r{g.rows}")


def select_span(first: int, last: int, rows: int, levels: int) -> tuple:
    """The window rows ``[lo, hi)`` on which a block of K1's wide body runs
    the selects of the fixed bottom and top sides, as the kernel sets them
    (``stencil_core.cuh::band_kernel``): ``first`` and ``last`` are the
    first and last of the block's ``rows`` window rows with edge bits
    (``last`` < 0: none, and no row selects), ``levels`` the kernel's level
    count.  A bit row e reaches level s at iteration e + s, so the span runs
    from ``first`` rounded down to the loop's three-row rotation to
    ``levels`` rows past ``last``, rounded up, at most to ``rows``."""
    if last < 0:
        return rows, rows
    return first // 3 * 3, min(rows, (last + levels + 3) // 3 * 3)


@functools.lru_cache(maxsize=256)
def k1_select_rows(ny: int, nx: int, k: int, dtype: torch.dtype, fix_bottom: int,
                   fix_top: int) -> int:
    """The window rows that one K1 launch's blocks run on the copy of the
    loop with the selects because a bottom or top side is fixed (side codes
    ``fix_bottom``, ``fix_top``; 0 is live periodic), summed over the
    blocks: :func:`select_span` on each block of :func:`k1_geometry`'s cut,
    and on the one-column body (k > WIDE_MAX_STEPS) every window row of a
    block whose window holds a fixed side's row.  Rows that a warp runs
    with selects because of a fixed x side are not counted."""
    if not (fix_bottom or fix_top):
        return 0
    g = k1_geometry(ny, nx, k, dtype)
    levels = 1 << (k - 1).bit_length()
    total = 0
    for y0 in range(0, ny, g.rows):
        rows = min(g.rows, ny - y0) + 2 * k
        bit_rows = [j for j in range(rows) if (fix_bottom and (y0 - k + j) % ny == 0)
                    or (fix_top and (y0 - k + j) % ny == ny - 1)]
        if not bit_rows:
            continue
        if g.cpt == 1:
            total += rows
        else:
            lo, hi = select_span(bit_rows[0], bit_rows[-1], rows, levels)
            total += hi - lo
    return total * g.bands


def _stencil_weights(dt, D, vx, vy, dx, dy):
    """The unsplit Euler update collapsed to a 5-point weighted stencil:
    u' = wc*c + wxm*xm + wxp*xp + wym*ym + wyp*yp (upwind signs resolved
    statically)."""
    ax = dt * D / (dx * dx)
    ay = dt * D / (dy * dy)
    cx = dt * vx / dx
    cy = dt * vy / dy
    wc = 1.0 - 2.0 * ax - 2.0 * ay - abs(cx) - abs(cy)
    wxm = ax + (cx if vx >= 0.0 else 0.0)
    wxp = ax + (-cx if vx < 0.0 else 0.0)
    wym = ay + (cy if vy >= 0.0 else 0.0)
    wyp = ay + (-cy if vy < 0.0 else 0.0)
    return wc, wxm, wxp, wym, wyp


def _fix_code(bc: BCType, compat: bool) -> int:
    """What the kernel's edge rule does on a physical side."""
    if bc == BCType.DIRICHLET:
        return _FIX_DIRICHLET
    if bc == BCType.NEUMANN:
        return _FIX_NEUMANN
    # periodic: live wrap, or the reference's stale-zero ghosts under compat
    return _FIX_ZERO if compat else _FIX_NONE


def one_sided_periodic_x(cfg: SimConfig) -> bool:
    """Exactly one of left/right periodic (wrap live, i.e. not compat)."""
    if cfg.strict_reference_compat:
        return False
    P = BCType.PERIODIC
    return (cfg.bc.left == P) != (cfg.bc.right == P)


def one_sided_periodic_y(cfg: SimConfig) -> bool:
    """Exactly one of bottom/top periodic (wrap live, i.e. not compat)."""
    if cfg.strict_reference_compat:
        return False
    P = BCType.PERIODIC
    return (cfg.bc.bottom == P) != (cfg.bc.top == P)


def one_sided_periodic(cfg: SimConfig) -> bool:
    """True when exactly one side of an axis is periodic and wrap is live,
    e.g. the reference's own dev.yaml (``bottom=periodic top=dirichlet``).
    The periodic side's ghost is the opposite edge's current line, while the
    opposite side keeps its own BC.  The kernel's edge rule covers this case
    like any other, so nothing on the port branches on it; it is kept for
    parity with the JAX package and for reports."""
    return one_sided_periodic_x(cfg) or one_sided_periodic_y(cfg)


def pick_steps_per_pass(cfg: SimConfig, chunk: int) -> int:
    """Choose k (steps fused per device-memory pass) for a ``chunk``-step
    program: ``cfg.steps_per_pass`` or 8, clamped by the chunk and by the
    grid-extent floor.  Identical to the JAX package's choice, so both run
    the same pass schedule and, in bf16, round at the same steps."""
    cap = getattr(cfg, "steps_per_pass", 0) or 8
    k = min(cap, chunk, max(1, cfg.nx // 32), max(1, cfg.ny // 32))
    return max(1, k)


def pass_schedule(cfg: SimConfig, chunk: int) -> List[int]:
    """Steps per kernel pass for a ``chunk``-step program: full passes of
    ``pick_steps_per_pass`` steps, then one remainder pass."""
    k = pick_steps_per_pass(cfg, chunk)
    full, rest = divmod(chunk, k)
    return [k] * full + ([rest] if rest else [])


def multistep_pass_plain(
    u: torch.Tensor, cfg: SimConfig, dt: float, k: int
) -> torch.Tensor:
    """The plain version of K1: ``k`` iterations of ``pad_with_ghosts`` plus
    the weighted 5-point stencil, in the kernel's accumulation order.  bf16
    input computes in f32 and rounds once at the end of the pass."""
    wc, wxm, wxp, wym, wyp = _stencil_weights(
        dt, cfg.D, cfg.vx, cfg.vy, cfg.dx, cfg.dy
    )
    compat = cfg.strict_reference_compat
    a = u.to(torch.float32) if u.dtype == torch.bfloat16 else u
    for _ in range(k):
        up = pad_with_ghosts(a, cfg.bc, 0.0, compat)
        c = up[1:-1, 1:-1]
        a = (
            wc * c
            + wym * up[:-2, 1:-1]
            + wyp * up[2:, 1:-1]
            + wxm * up[1:-1, :-2]
            + wxp * up[1:-1, 2:]
        )
    return a.to(u.dtype)


def _check(u: torch.Tensor, cfg: SimConfig, k: int) -> None:
    if not isinstance(u, torch.Tensor):
        raise TypeError(f"expected a torch.Tensor, got {type(u).__name__}")
    if tuple(u.shape) != (cfg.ny, cfg.nx):
        raise ValueError(
            f"field shape {tuple(u.shape)} != (ny={cfg.ny}, nx={cfg.nx})"
        )
    if u.dtype not in _DTYPE_CODES:
        raise TypeError(f"unsupported dtype {u.dtype} (float32|float64|bfloat16)")
    if not u.is_contiguous():
        raise ValueError("field must be contiguous")
    if not isinstance(k, int) or not 1 <= k <= MAX_STEPS_PER_PASS:
        raise ValueError(f"k must be an int in [1, {MAX_STEPS_PER_PASS}], got {k!r}")


def on_device(device: torch.device):
    """A context in which ``device`` is the current CUDA device (the one a
    C entry point launches on): a no-op when it already is, since a device
    switch costs host time on every launch."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def multistep_kernel_step(
    u: torch.Tensor, cfg: SimConfig, dt: float, k: int
) -> torch.Tensor:
    """Advance the global field ``k`` steps with one pass of K1.

    A CUDA tensor launches the kernel on the current stream into a fresh
    output (the input is never written) or raises; a CPU tensor takes the
    plain version.  ``multistep_kernel_step.launches`` counts the launches,
    ``multistep_kernel_step.wide_launches`` those that ran the wide body
    (:func:`k1_geometry`'s ``cpt`` > 1); while tracing is on, the counter
    ``k1.host_ns`` adds the host time of each launch from entry to the C
    call (which blocks while the launch queue is full, so it is left out),
    ``k1.wide_launches`` counts the wide launches, the counter of the
    launch's cut (:func:`k1_cut_counter`) counts each launch, and
    ``k1.select_rows`` adds the window rows its blocks run with the fixed
    y sides' selects (:func:`k1_select_rows`).
    """
    traced = tracing.ON
    if traced:
        entered = tracing.clock()
    _check(u, cfg, k)
    if u.device.type == "cpu":
        return multistep_pass_plain(u, cfg, dt, k)
    if u.device.type != "cuda":
        raise RuntimeError(f"K1 runs on cuda or cpu tensors, not {u.device}")
    from ._build import load_library

    lib = load_library().lib
    compat = cfg.strict_reference_compat
    fixes = [
        _fix_code(b, compat)
        for b in (cfg.bc.left, cfg.bc.right, cfg.bc.bottom, cfg.bc.top)
    ]
    weights = _stencil_weights(dt, cfg.D, cfg.vx, cfg.vy, cfg.dx, cfg.dy)
    geo = k1_geometry(cfg.ny, cfg.nx, k, u.dtype)
    out = torch.empty_like(u)
    with on_device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        if traced:
            tracing.add("k1.host_ns", tracing.clock() - entered)
        err = lib.climate_multistep_stencil(
            u.data_ptr(), out.data_ptr(), cfg.ny, cfg.nx, k,
            _DTYPE_CODES[u.dtype], *weights, *fixes, 0.0, geo.width,
            geo.rows, stream,
        )
    if err:
        msg = lib.climate_cuda_error_string(err).decode()
        raise RuntimeError(f"K1 launch failed: CUDA error {err} ({msg})")
    multistep_kernel_step.launches += 1
    if traced:
        tracing.add(k1_cut_counter(cfg.ny, cfg.nx, k, u.dtype), 1)
        tracing.add("k1.select_rows",
                    k1_select_rows(cfg.ny, cfg.nx, k, u.dtype, fixes[2], fixes[3]))
    if geo.cpt > 1:
        multistep_kernel_step.wide_launches += 1
        if traced:
            tracing.add("k1.wide_launches", 1)
    return out


multistep_kernel_step.launches = 0
multistep_kernel_step.wide_launches = 0


def build_multistep_advance(
    cfg: SimConfig, dt: float
) -> Callable[[int], Callable[[torch.Tensor], torch.Tensor]]:
    """``advance(chunk)`` -> fn advancing the global field ``chunk`` steps
    in K1 passes (:func:`pass_schedule`).  Every pass goes to
    :func:`multistep_kernel_step`; nothing falls back per pass.
    ``advance.pass_count(chunk)`` is the number of passes, and with it of
    bf16 rounding events, in such a program."""

    def advance(chunk: int):
        schedule = pass_schedule(cfg, chunk)

        def body(u: torch.Tensor) -> torch.Tensor:
            for kk in schedule:
                u = multistep_kernel_step(u, cfg, dt, kk)
            return u

        return body

    advance.pass_count = lambda chunk: len(pass_schedule(cfg, chunk))
    advance.uses_kernel = True
    advance.kernel = "K1"
    return advance
