"""Halo exchange and the sharded advances: the port of the divisible-grid
half of ``climate_sim_tpu/parallel/halo.py`` (the counterpart of the
reference's nonblocking MPI halo exchange, src/halo.cpp:6-49, and of its
physical-edge BCs, boundary.cpp:12-54).

The field is a (py, px) grid of tiles on a :class:`.mesh.Mesh`.  Where the
JAX package runs one ``shard_map`` program and moves faces with
``ppermute``, the port loops over the tiles in one process: an exchange is
a set of slices of the neighbour tiles, copied onto the receiving tile's
device (a peer copy between cards, which PyTorch orders against both
devices' current streams; a plain read on one card).  The MPI_PROC_NULL
skip is kept: a non-wrapping axis sends nothing across its wrap edge and
the edge tiles receive zeros, which the BC logic (per step) or the
kernels' edge rule (multi-step) never read as values.  ``mesh.copies``
counts the payloads delivered.

Exchange order, as in the JAX package: x faces first, then y faces at the
x-extended width, so corner ghosts hold the diagonal neighbours' data.

Advances (``advance(chunk)`` -> fn(tiles) -> tiles):

* :func:`build_sharded_advance`: per step, the width-1 exchange with BCs
  (:func:`exchange_and_pad`) and an interior step per tile (K2 or torch
  ops);
* :func:`build_sharded_multistep_advance`: per pass of k steps, one k-wide
  slab exchange (:func:`exchange_halos_slabs`) and K4 per tile;
* :func:`build_sharded_overlap_advance`: per pass, the exchange on a side
  stream while K3 advances each tile's interior, then K3 on four bands.

The carrier half of the JAX file (grids the mesh does not divide) is not
ported.
"""

from __future__ import annotations

import contextlib
import dataclasses
from typing import Callable, Dict, Tuple

import torch

from ..config import BCType, SimConfig
from ..ops.boundary import _ghost_line
from ..ops.cuda_sharded import (
    NO_FLAGS,
    sharded_tile_slab_multistep,
    tile_region_multistep,
)
from ..ops.cuda_stencil import pick_steps_per_pass
from .mesh import Mesh, Tiles, divisible


def axis_wrap_flags(cfg: SimConfig) -> Tuple[bool, bool]:
    """(wrap_x, wrap_y): does each mesh axis need wrap payloads in its halo
    exchange?  True when either side of the axis is live-periodic (two-sided
    torus wrap, or a one-sided side whose wrap block the kernels' edge rule
    consumes).  Compat-mode periodic is a stale-zero no-op that never
    consumes wrap data (reference: boundary.cpp has no Periodic branch), so
    it truncates like Dirichlet/Neumann."""
    if cfg.strict_reference_compat:
        return False, False
    per = BCType.PERIODIC
    return (
        cfg.bc.left == per or cfg.bc.right == per,
        cfg.bc.bottom == per or cfg.bc.top == per,
    )


def _tilewise(mesh: Mesh, fn: Callable[[int, int], torch.Tensor]) -> Tiles:
    return [[fn(y, x) for x in range(mesh.shape["x"])]
            for y in range(mesh.shape["y"])]


def _pshift(parts: Tiles, mesh: Mesh, axis: str, shift: int,
            wrap: bool = True) -> Tiles:
    """Per-tile shift along a mesh axis (JAX's ``ppermute`` with pairs
    (i, i+shift)): tile i receives ``parts`` of tile i-shift on its own
    device, wrapping when ``wrap``, zeros at the open ends otherwise.  A
    size-1 wrapping axis delivers each tile its own part (no copy); a
    size-1 non-wrapping axis has no neighbour, so zeros."""
    n = mesh.shape[axis]

    def recv(y: int, x: int) -> torch.Tensor:
        own = parts[y][x]
        i = x if axis == "x" else y
        src = i - shift
        if n == 1:
            return own if wrap else torch.zeros_like(own)
        wrapped = not 0 <= src < n
        if wrapped and not wrap:
            return torch.zeros_like(own)
        src %= n
        sy, sx = (y, src) if axis == "x" else (src, x)
        mesh.copies[(axis, wrapped)] += 1
        return parts[sy][sx].to(mesh.devices[y][x], non_blocking=True)

    return _tilewise(mesh, recv)


def exchange_and_pad(tiles: Tiles, cfg: SimConfig, mesh: Mesh,
                     value: float = 0.0) -> Tiles:
    """Every tile's (my+2, mx+2) ghost-padded copy: width-1 faces from the
    neighbours, and on the physical edges the BC ghost (Dirichlet value,
    Neumann mirror, the compat zero or the periodic wrap)."""
    bc = cfg.bc
    compat = cfg.strict_reference_compat
    wrap_x, wrap_y = axis_wrap_flags(cfg)
    px, py = mesh.shape["x"], mesh.shape["y"]

    # x direction (columns; left/right)
    gl = _pshift(_tilewise(mesh, lambda y, x: tiles[y][x][:, -1:]), mesh, "x", +1, wrap_x)
    gr = _pshift(_tilewise(mesh, lambda y, x: tiles[y][x][:, :1]), mesh, "x", -1, wrap_x)

    def x_padded(y: int, x: int) -> torch.Tensor:
        u, left, right = tiles[y][x], gl[y][x], gr[y][x]
        if x == 0:
            left = _ghost_line(bc.left, u[:, :1], left, value, compat)
        if x == px - 1:
            right = _ghost_line(bc.right, u[:, -1:], right, value, compat)
        return torch.cat([left, u, right], dim=1)

    mid = _tilewise(mesh, x_padded)
    # y direction (rows; bottom/top) at the padded width, corners included
    gb = _pshift(_tilewise(mesh, lambda y, x: mid[y][x][-1:]), mesh, "y", +1, wrap_y)
    gt = _pshift(_tilewise(mesh, lambda y, x: mid[y][x][:1]), mesh, "y", -1, wrap_y)

    def padded(y: int, x: int) -> torch.Tensor:
        m, bottom, top = mid[y][x], gb[y][x], gt[y][x]
        if y == 0:
            bottom = _ghost_line(bc.bottom, m[:1], bottom, value, compat)
        if y == py - 1:
            top = _ghost_line(bc.top, m[-1:], top, value, compat)
        return torch.cat([bottom, m, top], dim=0)

    return _tilewise(mesh, padded)


def _exchange_parts(tiles: Tiles, mesh: Mesh, k: int, wrap_x: bool = True,
                    wrap_y: bool = True) -> Tuple[Tiles, Tiles, Tiles, Tiles]:
    """The four k-wide face exchanges, x first, then y at the x-extended
    width: (left (my, k), right (my, k), bottom (k, mx+2k), top
    (k, mx+2k)) ghost blocks of every tile.  No BC logic: edge tiles of a
    wrapping axis get wrap data, those of a non-wrapping axis zeros."""
    gl = _pshift(_tilewise(mesh, lambda y, x: tiles[y][x][:, -k:]), mesh, "x", +1, wrap_x)
    gr = _pshift(_tilewise(mesh, lambda y, x: tiles[y][x][:, :k]), mesh, "x", -1, wrap_x)

    def rows(sl: slice) -> Tiles:
        return _tilewise(mesh, lambda y, x: torch.cat(
            [gl[y][x][sl], tiles[y][x][sl], gr[y][x][sl]], dim=1))

    gb = _pshift(rows(slice(-k, None)), mesh, "y", +1, wrap_y)
    gt = _pshift(rows(slice(None, k)), mesh, "y", -1, wrap_y)
    return gl, gr, gb, gt


def exchange_halos_k(tiles: Tiles, mesh: Mesh, k: int, wrap_x: bool = True,
                     wrap_y: bool = True) -> Tiles:
    """Every tile's (my+2k, mx+2k) copy with k-wide halos (the input of
    :func:`..ops.cuda_sharded.sharded_tile_multistep`)."""
    gl, gr, gb, gt = _exchange_parts(tiles, mesh, k, wrap_x, wrap_y)
    return _tilewise(mesh, lambda y, x: torch.cat([
        gb[y][x], torch.cat([gl[y][x], tiles[y][x], gr[y][x]], dim=1), gt[y][x],
    ], dim=0))


def exchange_halos_slabs(tiles: Tiles, mesh: Mesh, k: int, wrap_x: bool = True,
                         wrap_y: bool = True) -> Tuple[Tiles, Tiles]:
    """Every tile's k-wide halos as compact slabs, K4's inputs, with no
    padded tile built: ``xhalo`` (my, 2k) = [left k columns | right k
    columns] and ``yhalo`` (2k, mx+2k) = [bottom k rows ; top k rows], the
    rows at the x-extended width so that corners hold diagonal data."""
    gl, gr, gb, gt = _exchange_parts(tiles, mesh, k, wrap_x, wrap_y)
    xhalo = _tilewise(mesh, lambda y, x: torch.cat([gl[y][x], gr[y][x]], dim=1))
    yhalo = _tilewise(mesh, lambda y, x: torch.cat([gb[y][x], gt[y][x]], dim=0))
    return xhalo, yhalo


def _make_chunk_advance(tile_pass, k: int):
    """``advance(chunk)`` running ceil(chunk/k) tile passes (a remainder
    pass takes fewer steps).  ``advance.pass_count(chunk)`` is that number,
    per tile."""

    def advance(chunk: int):
        def body(tiles: Tiles) -> Tiles:
            n = 0
            while n < chunk:
                kk = min(k, chunk - n)
                tiles = tile_pass(tiles, kk)
                n += kk
            return tiles

        return body

    advance.pass_count = lambda chunk: -(-chunk // k)
    return advance


def _tile_cfg_k(cfg: SimConfig, mesh: Mesh):
    """(my, mx, k): the tile shape, and the pass size the sharded builders
    fix once from the tile and ``out_every`` (halo.py:270-275 of the JAX
    package); None for a grid the mesh does not divide."""
    if not divisible(mesh, cfg.nx, cfg.ny):
        return None
    my, mx = cfg.ny // mesh.shape["y"], cfg.nx // mesh.shape["x"]
    tile_cfg = dataclasses.replace(cfg, nx=mx, ny=my)
    return my, mx, pick_steps_per_pass(tile_cfg, cfg.out_every or 8)


def build_sharded_multistep_advance(cfg: SimConfig, mesh: Mesh, dt: float):
    """The sharded slab path: ``advance(chunk)`` advancing the tiles
    ``chunk`` steps with one k-wide slab exchange and one K4 launch per
    tile every k steps.  K4 takes every tile shape, so the JAX package's
    assembled-tile fallback is never needed; None only for a grid the mesh
    does not divide."""
    geo = _tile_cfg_k(cfg, mesh)
    if geo is None:
        return None
    k = geo[2]
    wrap_x, wrap_y = axis_wrap_flags(cfg)

    def tile_pass(tiles: Tiles, kk: int) -> Tiles:
        xhalo, yhalo = exchange_halos_slabs(tiles, mesh, kk, wrap_x, wrap_y)
        return _tilewise(mesh, lambda y, x: sharded_tile_slab_multistep(
            tiles[y][x], xhalo[y][x], yhalo[y][x], mesh.edge_flags(y, x),
            cfg, dt, kk,
        ))

    advance = _make_chunk_advance(tile_pass, k)
    advance.kernel, advance.path = "K4", "slab"
    return advance


@contextlib.contextmanager
def _on_side_streams(side: Dict[torch.device, torch.cuda.Stream]):
    """Make each device's side stream current, after it waits for the work
    launched so far on the device's current stream."""
    with contextlib.ExitStack() as stack:
        for dev, s in side.items():
            s.wait_stream(torch.cuda.current_stream(dev))
            stack.enter_context(torch.cuda.stream(s))
        yield


def build_sharded_overlap_advance(cfg: SimConfig, mesh: Mesh, dt: float):
    """The sharded pass with halo exchange / compute overlap.

    The interior of a tile needs no halo data for k steps, so each pass:

    1. on a side stream per device, exchanges the k-wide faces and
       assembles the four band windows;
    2. meanwhile, on the current stream, K3 advances the interior (rows and
       columns [k, m-k)) straight from the tile, with no fixups (the
       counterpart of the reference's Isend/Irecv overlapped with interior
       compute, halo.cpp:28-46);
    3. the current stream waits for the side stream, and K3 advances the
       bottom, top, left and right bands (k wide) from their windows,
       under the tile's edge flags.

    All five K3 launches write their regions of one fresh tile, so there
    is no stitch pass.  Band height, halo depth and band width are all k
    (the JAX package rounds them to TPU sublanes).  Returns None when a
    tile has no interior (my or mx <= 2k) or the mesh does not divide the
    grid; the caller then takes the slab path.
    """
    geo = _tile_cfg_k(cfg, mesh)
    if geo is None:
        return None
    my, mx, k = geo
    if my <= 2 * k or mx <= 2 * k:
        return None
    wrap_x, wrap_y = axis_wrap_flags(cfg)
    side = {d: torch.cuda.Stream(d) for d in mesh.distinct_devices()
            if d.type == "cuda"}

    def windows(u, gl, gr, gb, gt, kk):
        """Band windows: bottom/top (3kk, mx+2kk), left/right (my, 3kk)."""
        def rows(sl):
            return torch.cat([gl[sl], u[sl], gr[sl]], dim=1)

        return (
            torch.cat([gb, rows(slice(None, 2 * kk))], dim=0),
            torch.cat([rows(slice(-2 * kk, None)), gt], dim=0),
            torch.cat([gl, u[:, :2 * kk]], dim=1),
            torch.cat([u[:, -2 * kk:], gr], dim=1),
        )

    def tile_pass(tiles: Tiles, kk: int) -> Tiles:
        with _on_side_streams(side):
            parts = _exchange_parts(tiles, mesh, kk, wrap_x, wrap_y)
            wins = _tilewise(mesh, lambda y, x: windows(
                tiles[y][x], *(p[y][x] for p in parts), kk))
        out = _tilewise(mesh, lambda y, x: torch.empty_like(tiles[y][x]))
        for y in range(mesh.shape["y"]):
            for x in range(mesh.shape["x"]):
                tile_region_multistep(
                    tiles[y][x], NO_FLAGS, cfg, dt, kk, my - 2 * kk,
                    mx - 2 * kk, flagged=False, khalo=kk,
                    out=out[y][x][kk:my - kk, kk:mx - kk],
                )
        for dev, s in side.items():
            torch.cuda.current_stream(dev).wait_stream(s)
        for y in range(mesh.shape["y"]):
            for x in range(mesh.shape["x"]):
                l_, r_, b_, t_ = mesh.edge_flags(y, x)
                bot, top, left, right = wins[y][x]
                if side:
                    tiles[y][x].record_stream(side[tiles[y][x].device])
                    for w in wins[y][x]:
                        w.record_stream(torch.cuda.current_stream(w.device))
                o = out[y][x]
                for win, flags, ny_r, nx_r, region in (
                    (bot, (l_, r_, b_, 0), kk, mx, o[:kk]),
                    (top, (l_, r_, 0, t_), kk, mx, o[my - kk:]),
                    (left, (l_, 0, 0, 0), my - 2 * kk, kk, o[kk:my - kk, :kk]),
                    (right, (0, r_, 0, 0), my - 2 * kk, kk, o[kk:my - kk, mx - kk:]),
                ):
                    tile_region_multistep(win, flags, cfg, dt, kk, ny_r, nx_r,
                                          khalo=kk, out=region)
        return out

    advance = _make_chunk_advance(tile_pass, k)
    advance.kernel, advance.path = "K3", "overlap"
    return advance


def build_sharded_advance(cfg: SimConfig, mesh: Mesh, dt: float,
                          interior_step: Callable[[torch.Tensor], torch.Tensor]):
    """``advance(k)`` -> fn advancing the tiles k steps, each step the
    width-1 exchange with BCs (:func:`exchange_and_pad`) and
    ``interior_step`` (padded tile (my+2, mx+2) -> interior (my, mx), K2 or
    torch ops; see :func:`..ops.step.make_interior_step`) on every tile."""

    def advance(k: int):
        def body(tiles: Tiles) -> Tiles:
            for _ in range(k):
                padded = exchange_and_pad(tiles, cfg, mesh, 0.0)
                tiles = _tilewise(mesh, lambda y, x: interior_step(padded[y][x]))
            return tiles

        return body

    advance.pass_count = lambda k: k
    advance.kernel = getattr(interior_step, "kernel", None)
    advance.path = "per-step"
    return advance
