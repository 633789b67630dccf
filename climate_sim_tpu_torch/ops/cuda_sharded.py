"""K2, K3, K4 and K5, the sharded path's kernels, and their plain versions.

The port of the tile kernels of ``climate_sim_tpu/ops/pallas_stencil.py``,
with the JAX names:

* K2 :func:`prepadded_kernel_step`: one step on a ghost-padded
  (my+2, mx+2) tile whose ring is valid -> (my, mx); no fixups.
* K3 :func:`tile_region_multistep` (and :func:`sharded_tile_multistep`, its
  whole-tile case): k steps on an already-exchanged padded region
  (ny_r+2kh, >= nx_r+2kh) -> (ny_r, nx_r), read through a strided view and
  optionally written into a region of a larger output.
* K4 :func:`sharded_tile_slab_multistep`: k steps on one tile read straight
  from the tile and its compact halo slabs, xhalo (my, 2kh) and yhalo
  (2kh, mx+2kh) (:func:`climate_sim_tpu_torch.parallel.halo.exchange_halos_slabs`).
* K5 :func:`carrier_tile_slab_multistep`: K4 on one tile of a zero-padded
  carrier (:func:`climate_sim_tpu_torch.parallel.halo.build_carrier_slab_advance`),
  the true right/top edge at a runtime tile column/row.

All four run K1's streaming core (``csrc/region_stencil.cu`` for K2/K3
and ``csrc/slab_stencil.cu`` for K4/K5, over ``csrc/stencil_core.cuh``
and ``csrc/tile_stencil.cuh``), with the band geometry of their output
extent (:func:`..cuda_stencil.band_geometry`).  Edge flags ``(left,
right, bottom, top)``, 1 where the tile's side lies on the physical grid
edge, are host integers passed as kernel scalars.  The edge rule (see
``csrc/tile_stencil.cuh``) gives the flag-gated BC fixups and the
one-sided-periodic wrap patches of the TPU kernel; all flags 0 is K3's
``flagged=False``.  K5 takes six: the four, then the true
extent ``(ly, lx)`` of the tile that holds the top/right edge, where the
rule fires instead of at the tile's own extent.

Each wrapper takes the kernel's plain version for a CPU tensor, launches
the kernel on the current stream for a CUDA tensor, or raises; each counts
its launches in ``<wrapper>.launches``.  The plain versions
(:func:`region_pass_plain`, :func:`slab_pass_plain`,
:func:`carrier_pass_plain`, :func:`prepadded_step_plain`) run the same
sub-steps in torch ops, in the kernel's accumulation order.  bf16 is a
storage mode: f32 arithmetic, one rounding per pass.
"""

from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from ..config import SimConfig
from .cuda_stencil import (
    _DTYPE_CODES,
    _FIX_NEUMANN,
    _FIX_NONE,
    MAX_STEPS_PER_PASS,
    _fix_code,
    _stencil_weights,
    band_geometry,
    on_device,
)

NO_FLAGS = (0, 0, 0, 0)


def _fixes(cfg: SimConfig) -> Tuple[int, int, int, int]:
    compat = cfg.strict_reference_compat
    return tuple(
        _fix_code(b, compat)
        for b in (cfg.bc.left, cfg.bc.right, cfg.bc.bottom, cfg.bc.top)
    )


def _weights(cfg: SimConfig, dt: float):
    return _stencil_weights(dt, cfg.D, cfg.vx, cfg.vy, cfg.dx, cfg.dy)


def _edge_masks(n: int, l: int, k: int, fix_lo: int, fix_hi: int, flag_lo,
                flag_hi, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """The edge rule along one axis of extent n whose true extent on a
    high-edge tile is l, over window lines g in [-k, n+k): (lo, hi) masks
    of the lines whose low (high) neighbour operand is the BC ghost (see
    csrc/tile_stencil.cuh)."""
    g = torch.arange(-k, n + k, device=device)
    lo = (g == 0) & bool(flag_lo) | (g == l) & bool(flag_hi)
    hi = (g == l - 1) & bool(flag_hi) | (g == -1) & bool(flag_lo)
    return lo & (fix_lo != _FIX_NONE), hi & (fix_hi != _FIX_NONE)


def _ghost(fix: int, a: torch.Tensor):
    """The BC ghost a masked operand takes: the cell's own value
    (Neumann), else a constant (the Dirichlet value 0.0 or the compat 0)."""
    return a if fix == _FIX_NEUMANN else 0.0


def _substeps_plain(win: torch.Tensor, k: int, weights, fixes, flags,
                    extent: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """k sub-steps on a (ny+2k, nx+2k) window in compute precision ->
    (ny, nx); each sub-step drops the window's outer ring.  ``extent`` is
    the true (ly, lx) of a carrier tile (default (ny, nx))."""
    wc, wxm, wxp, wym, wyp = weights
    fl, fr, fb, ft = fixes
    ny, nx = win.shape[0] - 2 * k, win.shape[1] - 2 * k
    ly, lx = extent or (ny, nx)
    ylo, yhi = _edge_masks(ny, ly, k, fb, ft, flags[2], flags[3], win.device)
    xlo, xhi = _edge_masks(nx, lx, k, fl, fr, flags[0], flags[1], win.device)
    a = win
    for _ in range(k):
        ylo, yhi, xlo, xhi = ylo[1:-1], yhi[1:-1], xlo[1:-1], xhi[1:-1]
        c = a[1:-1, 1:-1]
        ym, yp = a[:-2, 1:-1], a[2:, 1:-1]
        xm, xp = a[1:-1, :-2], a[1:-1, 2:]
        if bool(ylo.any()):
            ym = torch.where(ylo[:, None], _ghost(fb, c), ym)
        if bool(yhi.any()):
            yp = torch.where(yhi[:, None], _ghost(ft, c), yp)
        if bool(xlo.any()):
            xm = torch.where(xlo[None, :], _ghost(fl, c), xm)
        if bool(xhi.any()):
            xp = torch.where(xhi[None, :], _ghost(fr, c), xp)
        # The kernel's accumulation order: c, ym, yp, xm, xp.
        a = wc * c + wym * ym + wyp * yp + wxm * xm + wxp * xp
    return a


def _compute(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.float32) if t.dtype == torch.bfloat16 else t


def region_pass_plain(padded: torch.Tensor, cfg: SimConfig, dt: float,
                      k: int, ny_r: int, nx_r: int,
                      flags: Sequence[int] = NO_FLAGS, khalo: int = 0,
                      extent: Optional[Tuple[int, int]] = None) -> torch.Tensor:
    """The plain version of K3: k sub-steps of the weighted stencil on the
    region's window under the edge rule -> (ny_r, nx_r).  ``extent`` is
    K5's true (ly, lx)."""
    kh = khalo or k
    o = kh - k
    win = _compute(padded[o:o + ny_r + 2 * k, o:o + nx_r + 2 * k])
    out = _substeps_plain(win, k, _weights(cfg, dt), _fixes(cfg), flags, extent)
    return out.to(padded.dtype)


def slab_window(tile: torch.Tensor, xhalo: torch.Tensor, yhalo: torch.Tensor,
                kh: int) -> torch.Tensor:
    """The (my+2kh, mx+2kh) padded tile that K4 reads from its three
    buffers without building it."""
    mid = torch.cat([xhalo[:, :kh], tile, xhalo[:, kh:]], dim=1)
    return torch.cat([yhalo[:kh], mid, yhalo[kh:]], dim=0)


def slab_pass_plain(tile: torch.Tensor, xhalo: torch.Tensor,
                    yhalo: torch.Tensor, flags: Sequence[int],
                    cfg: SimConfig, dt: float, k: int, khalo: int = 0
                    ) -> torch.Tensor:
    """The plain version of K4: the slab window, then K3's plain pass."""
    kh = khalo or k
    my, mx = tile.shape
    return region_pass_plain(slab_window(tile, xhalo, yhalo, kh), cfg, dt, k,
                             my, mx, flags, kh)


def carrier_pass_plain(tile: torch.Tensor, xhalo: torch.Tensor,
                       yhalo: torch.Tensor, flags6: Sequence[int],
                       cfg: SimConfig, dt: float, k: int, khalo: int = 0
                       ) -> torch.Tensor:
    """The plain version of K5: K4's plain pass with the edge rule's high
    side at the true extent ``flags6[4:6] = (ly, lx)`` -> the whole
    (my, mx) carrier tile."""
    kh = khalo or k
    my, mx = tile.shape
    return region_pass_plain(slab_window(tile, xhalo, yhalo, kh), cfg, dt, k,
                             my, mx, flags6[:4], kh, (int(flags6[4]), int(flags6[5])))


def prepadded_step_plain(up: torch.Tensor, cfg: SimConfig, dt: float
                         ) -> torch.Tensor:
    """The plain version of K2: one weighted-stencil step, no fixups."""
    my, mx = up.shape[0] - 2, up.shape[1] - 2
    return region_pass_plain(up, cfg, dt, 1, my, mx)


def _check_tensor(name: str, t: torch.Tensor, rows: int, cols: int,
                  contiguous: bool = True) -> None:
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t).__name__}")
    if t.dim() != 2 or t.shape[0] < rows or t.shape[1] < cols:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, need at least ({rows}, {cols})")
    if t.dtype not in _DTYPE_CODES:
        raise TypeError(f"{name}: unsupported dtype {t.dtype} (float32|float64|bfloat16)")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.stride(1) != 1:
        raise ValueError(f"{name}: rows must be contiguous (stride(1) == 1)")


def _check_k(k: int, khalo: int) -> None:
    if not isinstance(k, int) or not 1 <= k <= MAX_STEPS_PER_PASS:
        raise ValueError(f"k must be an int in [1, {MAX_STEPS_PER_PASS}], got {k!r}")
    if khalo < k:
        raise ValueError(f"halo depth {khalo} < k={k}")


def _check_slabs(tile: torch.Tensor, xhalo: torch.Tensor, yhalo: torch.Tensor,
                 k: int, kh: int) -> Tuple[int, int]:
    """K4's and K5's input checks; returns the tile's (my, mx)."""
    _check_k(k, kh)
    _check_tensor("tile", tile, 1, 1)
    my, mx = tile.shape
    if kh > my or kh > mx:
        raise ValueError(f"halo depth {kh} exceeds the ({my}, {mx}) tile")
    for name, t, shape in (("xhalo", xhalo, (my, 2 * kh)),
                           ("yhalo", yhalo, (2 * kh, mx + 2 * kh))):
        _check_tensor(name, t, *shape)
        if tuple(t.shape) != shape or t.dtype != tile.dtype:
            raise ValueError(f"{name}: {t.dtype} {tuple(t.shape)}, need"
                             f" {tile.dtype} {shape}")
    return my, mx


def _check_flags(flags: Sequence[int]) -> Tuple[int, int, int, int]:
    out = tuple(int(f) for f in flags)
    if len(out) != 4 or any(f not in (0, 1) for f in out):
        raise ValueError(f"edge flags must be four 0/1 values, got {flags!r}")
    return out


def _same_storage(a: torch.Tensor, b: torch.Tensor) -> bool:
    return a.untyped_storage().data_ptr() == b.untyped_storage().data_ptr()


def _launch(kernel: str, tensors: Sequence[torch.Tensor], fn: Callable):
    """Run ``fn(lib, stream)`` on the CUDA device of ``tensors`` and raise
    on a launch error."""
    dev = tensors[0].device
    if dev.type != "cuda" or any(t.device != dev for t in tensors):
        raise RuntimeError(
            f"{kernel} runs on cpu or cuda tensors of one device, not"
            f" {[str(t.device) for t in tensors]}"
        )
    from ._build import load_library

    lib = load_library().lib
    with on_device(dev):
        err = fn(lib, torch.cuda.current_stream(dev).cuda_stream)
    if err:
        msg = lib.climate_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel} launch failed: CUDA error {err} ({msg})")


def prepadded_kernel_step(up: torch.Tensor, cfg: SimConfig, dt: float
                          ) -> torch.Tensor:
    """K2: one step on a ghost-padded (my+2, mx+2) tile -> (my, mx) interior.
    The ghost ring must hold valid values (BCs and halos applied)."""
    _check_tensor("padded tile", up, 3, 3)
    my, mx = up.shape[0] - 2, up.shape[1] - 2
    if up.device.type == "cpu":
        return prepadded_step_plain(up, cfg, dt)
    out = torch.empty((my, mx), dtype=up.dtype, device=up.device)
    _launch("K2", [up], lambda lib, stream: lib.climate_prepadded_step(
        up.data_ptr(), out.data_ptr(), my, mx, _DTYPE_CODES[up.dtype],
        *_weights(cfg, dt), *band_geometry(my, mx, 1)[:2], stream,
    ))
    prepadded_kernel_step.launches += 1
    return out


prepadded_kernel_step.launches = 0


def tile_region_multistep(padded: torch.Tensor, edge_flags: Sequence[int],
                          cfg: SimConfig, dt: float, k: int, ny_r: int,
                          nx_r: int, flagged: bool = True, khalo: int = 0,
                          out: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K3: advance one region of a tile k steps.

    ``padded`` is the (ny_r+2*khalo, >= nx_r+2*khalo) input whose pads hold
    tile and halo data (``khalo`` defaults to k); a view with contiguous
    rows is read in place.  ``flagged=True`` applies the edge rule under
    ``edge_flags``; ``flagged=False`` none at all.  The result goes to
    ``out`` (an (ny_r, nx_r) view with contiguous rows, e.g. a region of a
    fresh tile, never of the input) or to a fresh tensor, which is
    returned.
    """
    kh = khalo or k
    _check_k(k, kh)
    _check_tensor("padded region", padded, ny_r + 2 * kh, nx_r + 2 * kh,
                  contiguous=False)
    flags = _check_flags(edge_flags) if flagged else NO_FLAGS
    if out is None:
        out = torch.empty((ny_r, nx_r), dtype=padded.dtype, device=padded.device)
    elif (tuple(out.shape) != (ny_r, nx_r) or out.dtype != padded.dtype
          or out.stride(1) != 1 or _same_storage(out, padded)):
        raise ValueError("out must be a fresh (ny_r, nx_r) view of the input's"
                         " dtype with contiguous rows")
    if padded.device.type == "cpu":
        out.copy_(region_pass_plain(padded, cfg, dt, k, ny_r, nx_r, flags, kh))
        return out
    _launch("K3", [padded, out], lambda lib, stream: lib.climate_region_multistep(
        padded.data_ptr(), padded.stride(0), out.data_ptr(), out.stride(0),
        ny_r, nx_r, k, kh, _DTYPE_CODES[padded.dtype], *_weights(cfg, dt),
        *_fixes(cfg), *flags, 0.0, *band_geometry(ny_r, nx_r, k)[:2], stream,
    ))
    tile_region_multistep.launches += 1
    return out


tile_region_multistep.launches = 0


def sharded_tile_multistep(padded: torch.Tensor, edge_flags: Sequence[int],
                           cfg: SimConfig, dt: float, k: int, mx: int
                           ) -> torch.Tensor:
    """K3 on a whole tile: ``padded`` is the (my+2k, mx+2k) tile with k-wide
    halos exchanged (:func:`..parallel.halo.exchange_halos_k`)."""
    my = padded.shape[0] - 2 * k
    return tile_region_multistep(padded, edge_flags, cfg, dt, k, my, mx)


def sharded_tile_slab_multistep(tile: torch.Tensor, xhalo: torch.Tensor,
                                yhalo: torch.Tensor, edge_flags: Sequence[int],
                                cfg: SimConfig, dt: float, k: int,
                                khalo: int = 0) -> torch.Tensor:
    """K4: advance one (my, mx) tile k steps straight from the tile, xhalo
    (my, 2*khalo) and yhalo (2*khalo, mx+2*khalo); ``khalo`` defaults to
    k.  Returns a fresh (my, mx) tensor."""
    kh = khalo or k
    my, mx = _check_slabs(tile, xhalo, yhalo, k, kh)
    flags = _check_flags(edge_flags)
    if tile.device.type == "cpu":
        return slab_pass_plain(tile, xhalo, yhalo, flags, cfg, dt, k, kh)
    out = torch.empty_like(tile)
    _launch("K4", [tile, xhalo, yhalo], lambda lib, stream: lib.climate_slab_multistep(
        tile.data_ptr(), xhalo.data_ptr(), yhalo.data_ptr(), out.data_ptr(),
        my, mx, k, kh, _DTYPE_CODES[tile.dtype], *_weights(cfg, dt),
        *_fixes(cfg), *flags, 0.0, *band_geometry(my, mx, k)[:2], stream,
    ))
    sharded_tile_slab_multistep.launches += 1
    return out


sharded_tile_slab_multistep.launches = 0


def carrier_tile_slab_multistep(tile: torch.Tensor, xhalo: torch.Tensor,
                                yhalo: torch.Tensor, flags6: Sequence[int],
                                cfg: SimConfig, dt: float, k: int,
                                khalo: int = 0) -> torch.Tensor:
    """K5: advance one (my, mx) carrier tile k steps from the tile and its
    slabs (K4's layout, ``khalo`` deep, default k).  ``flags6`` is
    ``(left, right, bottom, top, ly, lx)``: the edge flags, ``right`` /
    ``top`` marking the tile that holds the true right / top edge, and the
    true extent there, 1 <= ly <= my and 1 <= lx <= mx.  Returns a fresh
    (my, mx) tensor, pad included (the pad holds garbage)."""
    kh = khalo or k
    my, mx = _check_slabs(tile, xhalo, yhalo, k, kh)
    if len(flags6) != 6:
        raise ValueError(f"flags6 must be six values, got {flags6!r}")
    flags = _check_flags(flags6[:4])
    ly, lx = int(flags6[4]), int(flags6[5])
    if not (1 <= ly <= my and 1 <= lx <= mx):
        raise ValueError(f"true extent ({ly}, {lx}) outside the ({my}, {mx}) tile")
    if tile.device.type == "cpu":
        return carrier_pass_plain(tile, xhalo, yhalo, (*flags, ly, lx), cfg, dt, k, kh)
    out = torch.empty_like(tile)
    _launch("K5", [tile, xhalo, yhalo], lambda lib, stream: lib.climate_carrier_multistep(
        tile.data_ptr(), xhalo.data_ptr(), yhalo.data_ptr(), out.data_ptr(),
        my, mx, ly, lx, k, kh, _DTYPE_CODES[tile.dtype], *_weights(cfg, dt),
        *_fixes(cfg), *flags, 0.0, *band_geometry(my, mx, k)[:2], stream,
    ))
    carrier_tile_slab_multistep.launches += 1
    return out


carrier_tile_slab_multistep.launches = 0


def make_pallas_interior_step(cfg: SimConfig, dt: float
                              ) -> Callable[[torch.Tensor], torch.Tensor]:
    """Interior step for the per-step sharded path: padded tile -> updated
    interior through K2.  (The JAX name; K2 takes every tile shape, so
    there is no fallback.)"""

    def step(up: torch.Tensor) -> torch.Tensor:
        return prepadded_kernel_step(up, cfg, dt)

    step.kernel = "K2"
    return step
