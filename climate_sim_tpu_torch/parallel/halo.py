"""Halo exchange and the sharded advances: the port of
``climate_sim_tpu/parallel/halo.py`` (the counterpart of the reference's
nonblocking MPI halo exchange, src/halo.cpp:6-49, and of its physical-edge
BCs, boundary.cpp:12-54).

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

Across processes, every inter-tile payload goes through :func:`_deliver`:
a pair of tiles of one rank stays a peer copy, and the pairs that cross
ranks become one batch of sends and receives per exchange on the mesh's
transport (:class:`..runtime.distributed.Transport`).  Every rank walks
all tiles in one order and computes only its own: a rank's tile grid
holds ``None`` for another rank's tile.

Exchange order, as in the JAX package: x faces first, then y faces at the
x-extended width, so corner ghosts hold the diagonal neighbours' data.

Advances (``advance(chunk)`` -> fn(tiles) -> tiles, cached per chunk
length and, where :func:`..runtime.graphs.capture_rule` allows, one
captured CUDA graph a chunk; see :func:`_make_chunk_advance`):

* :func:`build_sharded_advance`: per step, the width-1 exchange with BCs
  (:func:`exchange_and_pad`) and an interior step per tile (K2 or torch
  ops);
* :func:`build_sharded_multistep_advance`: per pass of k steps, one k-wide
  slab exchange (:func:`exchange_halos_slabs`) and K4 per tile;
* :func:`build_sharded_overlap_advance`: per pass, the exchange on a side
  stream while K3 advances each tile's interior, then K3 on four bands.

Grids the mesh does not divide:

* :func:`build_carrier_slab_advance`: the field embedded in mesh-uniform
  zero-padded carrier tiles, one slab exchange with staged wrap blocks and
  one K5 launch per tile and pass;
* :func:`build_padded_advance`: the per-step advance on the reference's
  remainder tiles (:func:`.mesh.split_sizes`).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Optional, Sequence, Tuple

import torch

from ..config import BCType, SimConfig
from ..ops.boundary import _ghost_line
from ..ops.cuda_sharded import (
    NO_FLAGS,
    carrier_tile_slab_multistep,
    prepadded_kernel_step,
    sharded_tile_slab_multistep,
    tile_region_multistep,
)
from ..ops.cuda_stencil import pick_steps_per_pass, stencil_constants
from ..ops.step import make_interior_step
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
    """``fn(y, x)`` for each of this process's tiles, None for the rest."""
    return [[fn(y, x) if mesh.is_local(y, x) else None for x in range(mesh.shape["x"])]
            for y in range(mesh.shape["y"])]


Move = Tuple[Tuple[int, int], Tuple[int, int], Optional[tuple]]

# ``mesh.rounds`` runs modulo this, so a batch's tags stay below 2**31.
ROUNDS = 4096

# The kernel wrappers a mesh chunk launches through (each counts on its
# ``launches``); every one of them launches the one kernel of
# csrc/stencil_core.cuh, whose symbol holds CHUNK_KERNEL.
_CHUNK_WRAPPERS = (
    prepadded_kernel_step,
    tile_region_multistep,
    sharded_tile_slab_multistep,
    carrier_tile_slab_multistep,
)
CHUNK_KERNEL = "band_kernel"


@dataclasses.dataclass(frozen=True)
class ChunkCounts:
    """The counters a mesh chunk moves: each of :data:`_CHUNK_WRAPPERS`'
    launches, ``mesh.copies`` and ``mesh.rounds``.  ``after - before`` is
    what a chunk counted; :meth:`add` adds such a delta to the mesh's
    counters, :meth:`restore` sets them back to a reading."""

    launches: Tuple[int, ...]
    copies: collections.Counter
    rounds: int

    @classmethod
    def read(cls, mesh: Mesh) -> "ChunkCounts":
        return cls(tuple(fn.launches for fn in _CHUNK_WRAPPERS),
                   collections.Counter(mesh.copies), mesh.rounds)

    @property
    def kernel_launches(self) -> int:
        return sum(self.launches)

    def __sub__(self, before: "ChunkCounts") -> "ChunkCounts":
        return ChunkCounts(tuple(a - b for a, b in zip(self.launches, before.launches)),
                           self.copies - before.copies,
                           (self.rounds - before.rounds) % ROUNDS)

    def restore(self, mesh: Mesh) -> None:
        """Set the counters to this reading (``mesh.copies`` in place:
        callers hold the Counter)."""
        for fn, n in zip(_CHUNK_WRAPPERS, self.launches):
            fn.launches = n
        mesh.copies.clear()
        mesh.copies.update(self.copies)
        mesh.rounds = self.rounds

    def add(self, mesh: Mesh) -> None:
        """Add this delta to the counters."""
        for fn, n in zip(_CHUNK_WRAPPERS, self.launches):
            fn.launches += n
        mesh.copies.update(self.copies)
        mesh.rounds = (mesh.rounds + self.rounds) % ROUNDS


def _deliver(parts: Tiles, mesh: Mesh, moves: Sequence[Move], out: Tiles) -> None:
    """For each ``(src, dst, key)`` of ``moves``, ``parts`` of tile src into
    ``out`` at dst, on dst's device: a peer copy when both tiles are this
    process's, else a receive shaped like dst's own part or a send, all of
    them one batch of the mesh's transport.  ``mesh.copies[key]`` counts
    the payloads this process receives (a None key is not counted).

    Every rank walks the same moves in the same order, so the batches
    match; a tag of the batch's round and the destination tile's index
    tells two payloads between one pair of ranks apart.  A peer copy
    between cards records events on both cards' current streams, so in a
    chunk captured over several cards it is ordered on the streams joined
    to the capture (:class:`..runtime.graphs.CudaGraphs`)."""
    px = mesh.shape["x"]
    base = mesh.rounds * mesh.size
    mesh.rounds = (mesh.rounds + 1) % ROUNDS
    sends, recvs, slots = [], [], []
    for (sy, sx), (dy, dx), key in moves:
        tag = base + dy * px + dx
        if mesh.is_local(dy, dx):
            if key is not None:
                mesh.copies[key] += 1
            if mesh.is_local(sy, sx):
                out[dy][dx] = parts[sy][sx].to(mesh.devices[dy][dx], non_blocking=True)
            else:
                recvs.append((parts[dy][dx], mesh.owner(sy, sx), tag))
                slots.append((dy, dx))
        elif mesh.is_local(sy, sx):
            sends.append((parts[sy][sx], mesh.owner(dy, dx), tag))
    if sends or recvs:
        for (dy, dx), t in zip(slots, mesh.transport.exchange(sends, recvs)):
            out[dy][dx] = t


def _pshift(parts: Tiles, mesh: Mesh, axis: str, shift: int,
            wrap: bool = True) -> Tiles:
    """Per-tile shift along a mesh axis (JAX's ``ppermute`` with pairs
    (i, i+shift)): tile i receives ``parts`` of tile i-shift on its own
    device, wrapping when ``wrap``, zeros at the open ends otherwise.  A
    size-1 wrapping axis delivers each tile its own part (no copy); a
    size-1 non-wrapping axis has no neighbour, so zeros."""
    n = mesh.shape[axis]
    out = _tilewise(mesh, lambda y, x: None)
    moves = []
    for y in range(mesh.shape["y"]):
        for x in range(mesh.shape["x"]):
            src = (x if axis == "x" else y) - shift
            wrapped = not 0 <= src < n
            if n == 1 or (wrapped and not wrap):
                if mesh.is_local(y, x):
                    own = parts[y][x]
                    out[y][x] = own if n == 1 and wrap else torch.zeros_like(own)
                continue
            src %= n
            moves.append(((y, src) if axis == "x" else (src, x), (y, x), (axis, wrapped)))
    _deliver(parts, mesh, moves, out)
    return out


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


def _make_chunk_advance(tile_pass, k: int, mesh: Mesh):
    """``advance(chunk)`` running ceil(chunk/k) tile passes (a remainder
    pass takes fewer steps), cached per chunk length as the JAX package
    caches its ``jit`` (halo.py:187-200 there).  Where the capture rule
    allows (:func:`..runtime.graphs.capture_rule`, decided here from the
    mesh and its transport), the chunk is a
    :class:`..runtime.graphs.GraphedChunk`, which replays one recorded
    chunk per call (the lengths' graphs share one memory pool); else, or
    when called inside ``disable_graphs()``, it runs eagerly.
    ``advance.pass_count(chunk)`` is the passes per tile,
    ``advance.steps_per_pass`` k, and ``advance.eager_why`` None for a
    captured advance, else the rule's reason."""
    from ..runtime import graphs

    @functools.lru_cache(maxsize=None)
    def eager(chunk: int):
        def body(tiles: Tiles) -> Tiles:
            n = 0
            while n < chunk:
                kk = min(k, chunk - n)
                tiles = tile_pass(tiles, kk)
                n += kk
            return tiles

        return body

    pool = graphs.Pool()

    @functools.lru_cache(maxsize=None)
    def graphed(chunk: int):
        return graphs.GraphedChunk(eager(chunk), mesh, chunk, pool)

    eager_why = graphs.capture_rule(mesh)

    def advance(chunk: int):
        if eager_why is None and not graphs.graphs_disabled():
            return graphed(chunk)
        return eager(chunk)

    advance.eager_why = eager_why
    advance.pass_count = lambda chunk: -(-chunk // k)
    advance.steps_per_pass = k
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

    advance = _make_chunk_advance(tile_pass, k, mesh)
    advance.kernel, advance.path = "K4", "slab"
    return advance


@contextlib.contextmanager
def _on_side_streams(side: Dict[torch.device, torch.cuda.Stream]):
    """Make each device's side stream current, after it waits for the work
    launched so far on the device's current stream (in a captured chunk,
    each card's stream joined to the capture, which this joins it to)."""
    with contextlib.ExitStack() as stack:
        for dev, s in side.items():
            s.wait_stream(torch.cuda.current_stream(dev))
            stack.enter_context(torch.cuda.stream(s))
        yield


def build_sharded_overlap_advance(cfg: SimConfig, mesh: Mesh, dt: float):
    """The sharded pass with halo exchange / compute overlap.

    The interior of a tile needs no halo data for k steps, so each pass:

    1. on a side stream per device, exchanges the k-wide faces and
       assembles the four band windows (across ranks, the exchange's batch
       is issued on the side stream, which waits for it);
    2. meanwhile, on the current stream, K3 advances the interior (rows and
       columns [k, m-k)) straight from the tile, with no fixups (the
       counterpart of the reference's Isend/Irecv overlapped with interior
       compute, halo.cpp:28-46);
    3. the current stream waits for the side stream, and K3 advances the
       bottom, top, left and right bands (k wide) from their windows,
       under the tile's edge flags.

    All five K3 launches write their regions of one fresh tile, so there
    is no stitch pass.  Each pass forks the side streams after all the
    work launched so far and joins them before the bands, so a tile read
    on a side stream, or a window read on the current one, is freed only
    behind its last read in stream order: no ``record_stream`` is needed,
    and a captured chunk's pool reuses each pass's blocks (a recorded
    cross-stream use would hold every block to the capture's end).  Band
    height, halo depth and band width are all k (the JAX package rounds
    them to TPU sublanes).  Returns None when a tile has no interior (my
    or mx <= 2k) or the mesh does not divide the grid; the caller then
    takes the slab path.
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
        for y, x in mesh.local_tiles():
            tile_region_multistep(
                tiles[y][x], NO_FLAGS, cfg, dt, kk, my - 2 * kk,
                mx - 2 * kk, flagged=False, khalo=kk,
                out=out[y][x][kk:my - kk, kk:mx - kk],
            )
        for dev, s in side.items():
            torch.cuda.current_stream(dev).wait_stream(s)
        for y, x in mesh.local_tiles():
            l_, r_, b_, t_ = mesh.edge_flags(y, x)
            bot, top, left, right = wins[y][x]
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

    advance = _make_chunk_advance(tile_pass, k, mesh)
    advance.kernel, advance.path = "K3", "overlap"
    return advance


def build_sharded_advance(cfg: SimConfig, mesh: Mesh, dt: float,
                          interior_step: Callable[[torch.Tensor], torch.Tensor]):
    """``advance(k)`` -> fn advancing the tiles k steps, each step the
    width-1 exchange with BCs (:func:`exchange_and_pad`) and
    ``interior_step`` (padded tile (my+2, mx+2) -> interior (my, mx), K2 or
    torch ops; see :func:`..ops.step.make_interior_step`) on every tile: a
    chunk of one-step passes (:func:`_make_chunk_advance`)."""

    def step(tiles: Tiles, kk: int) -> Tiles:
        padded = exchange_and_pad(tiles, cfg, mesh, 0.0)
        return _tilewise(mesh, lambda y, x: interior_step(padded[y][x]))

    advance = _make_chunk_advance(step, 1, mesh)
    advance.kernel = getattr(interior_step, "kernel", None)
    advance.path = "per-step"
    return advance


def build_padded_advance(cfg: SimConfig, mesh: Mesh, dt: float):
    """The per-step path on a grid the mesh does not divide: the port's one
    counterpart of the JAX package's padded-GSPMD advance (both axes
    indivisible, halo.py:947-999) and its one-axis GSPMD route
    (driver.py:382-404).  The field lies in the reference's remainder tiles
    (:func:`.mesh.shard_field`, decomp.cpp:29-30), which the width-1
    exchange takes as they are, so this is :func:`build_sharded_advance`
    with :func:`..ops.step.make_interior_step`: torch ops for
    ``kernel=jnp``, K2 for ``pallas``/``pallas_multistep``."""
    advance = build_sharded_advance(cfg, mesh, dt, make_interior_step(cfg, dt))
    advance.path = "remainder per-step"
    return advance


def _carrier_axis_plan(n: int, p: int, periodic: str, kh: int):
    """Per-axis carrier geometry (JAX halo.py:547-608 at ``align=1``, without
    its ``min_m`` floor): ``(m, edge, l)``, the carrier tile extent ``m``
    (``m * p >= n``), the index of the tile that holds the true high edge,
    and the true extent ``l`` there; None when the axis cannot stage its
    wrap blocks.  The pad lies at the high end; an axis that ``p`` divides
    (a single-tile axis among them) has none.

    ``periodic`` is the axis's wrap mode: ``"none"``, ``"two"`` (torus),
    ``"low"`` or ``"high"`` (only that side periodic).  Staging room, each
    block ``kh`` lines: ``"two"`` needs the edge on the last tile, ``2kh``
    pad lines (wrap-head and tail-mirror, disjoint) and ``kh`` true lines;
    ``"low"`` the last tile, ``kh`` pad lines and ``kh`` true lines;
    ``"high"`` ``kh`` pad and ``kh`` true lines on the edge tile, which
    need not be the last."""
    if n % p == 0:
        return n // p, p - 1, n // p
    m = -(-n // p)
    if periodic == "none":
        e = -(-n // m) - 1
        return m, e, n - e * m
    if n < kh:
        return None
    if periodic == "high":
        while True:
            e = -(-n // m) - 1
            l = n - e * m
            if m - l >= kh and l >= kh:
                return m, e, l
            m += 1
    need_pad = 2 * kh if periodic == "two" else kh
    while (p - 1) * m < n:
        l = n - (p - 1) * m
        if p * m - n >= need_pad and l >= kh:
            return m, p - 1, l
        m += 1
    return None


def _axis_mode(lo: BCType, hi: BCType, compat: bool) -> str:
    """The wrap mode of an axis from its two sides; compat periodic never
    wraps (stale zeros), so it counts as ``"none"``."""
    per = BCType.PERIODIC
    if compat or (lo != per and hi != per):
        return "none"
    if lo == per and hi == per:
        return "two"
    return "low" if lo == per else "high"


def _send(parts: Tiles, mesh: Mesh, src: Tuple[int, int],
          dst: Tuple[int, int], axis: str) -> Optional[torch.Tensor]:
    """A wrap-head payload, ``parts`` of tile ``src``, on the device of tile
    ``dst`` (y, x) through :func:`_deliver` (the receive is shaped like
    dst's own part); None where dst is another rank's.
    ``mesh.copies[(axis, "head")]`` counts those between two tiles."""
    out = _tilewise(mesh, lambda y, x: None)
    _deliver(parts, mesh, [(src, dst, (axis, "head") if src != dst else None)], out)
    return out[dst[0]][dst[1]]


def build_carrier_slab_advance(cfg: SimConfig, mesh: Mesh, dt: float):
    """``advance(chunk)`` for a grid the mesh does not divide, with one K5
    launch per tile and pass: the port of JAX halo.py:611-944.

    The field lies in a zero-padded CARRIER of mesh-uniform (my, mx) tiles
    (:func:`_carrier_axis_plan` per axis), the pad at the high end.  Along
    each axis the edge tile ``e`` holds the true high edge at tile-local
    extent ``l``; tiles beyond it are all pad.  Each tile's K5 flags are
    ``(x == 0, x == e_x, y == 0, y == e_y, ly, lx)``: the kernel re-pins
    the BC at the true edges every sub-step, so the pad evolves as inert
    garbage that never reaches the true extent.

    Periodic sides have no fixup; each pass stages true wrap data into the
    pad (``KH`` lines, the pass size), as in the JAX package:

    * tail-mirror (``"two"``/``"low"`` axes): on the last tile, pad lines
      [m-KH, m) := true lines [l-KH, l), a local copy before round 1, so
      the cyclic exchange delivers true wrap data to tile 0's low halo;
    * wrap-head (``"two"``/``"high"``): on the edge tile, pad lines
      [l, l+KH) := the first KH global lines, sent from tile 0.  The x head
      is patched after round 1's x exchange; the y head ships tile 0's
      x-extended first rows (``gl|c|gr``), patched into the tile and into
      the xhalo rows [ly, ly+KH), so torus corners route through the
      tail-mirror and ``gl``.

    Round 1 exchanges x faces, round 2 the x-extended rows (the port's
    compact slab layout).  Where the weights' |sum| exceeds 1 + 1e-12 the
    pads are zeroed each pass, so garbage cannot overflow.  A remainder
    pass runs fewer sub-steps on the same KH-deep staging.

    Staging writes the pad lines of the carrier tiles in place and nothing
    else (in a captured chunk, those of the graph's static input); every
    kernel writes a fresh tile.  So the true extent of a
    carrier held for a snapshot stays valid while the next span runs, as
    long as the copier reads only :attr:`advance.extract`'s views.  The
    exchange payloads are taken (``cat`` copies) before any in-place
    patch, so the values equal the JAX package's.

    What the JAX design keeps as TPU answers, and the port drops: the
    128-column and 8/16-row alignment (the port plans with ``align=1``,
    so a single-tile axis is never padded), the BY-friendliness expansion and
    ``CLIMATE_SIM_CARRIER_EXPAND``, the ``my < 32 or mx < 128`` floor, and
    the bf16-only KH = 16.  ``KH`` is ``pick_steps_per_pass`` of the
    unpadded ``ceil(n/p)`` tile, fixed once.

    Returns None when an axis cannot stage, or when the carrier would hold
    more than twice the grid's points; the driver then takes
    :func:`build_padded_advance`.  The advance carries ``embed`` (global
    field -> carrier tiles), ``embed_from`` (carrier tiles from a function
    of each tile's true-extent window, the multi-process IC), ``windows``
    (those windows of the local tiles), ``extract`` (carrier tiles -> grid
    of views of the true extent, all-pad tiles dropped), ``carrier_shape``,
    ``flags6(y, x)`` (tile (y, x)'s K5 flags), ``pass_count``,
    ``steps_per_pass`` (KH), ``kernel = "K5"`` and ``path = "carrier"``.
    """
    px, py = mesh.shape["x"], mesh.shape["y"]
    nx, ny = cfg.nx, cfg.ny
    compat = cfg.strict_reference_compat
    mode_x = _axis_mode(cfg.bc.left, cfg.bc.right, compat)
    mode_y = _axis_mode(cfg.bc.bottom, cfg.bc.top, compat)
    tile_cfg = dataclasses.replace(cfg, nx=-(-nx // px), ny=-(-ny // py))
    KH = pick_steps_per_pass(tile_cfg, cfg.out_every or 8)
    plan_x = _carrier_axis_plan(nx, px, mode_x, KH)
    plan_y = _carrier_axis_plan(ny, py, mode_y, KH)
    if plan_x is None or plan_y is None:
        return None
    mx, e_x, lx = plan_x
    my, e_y, ly = plan_y
    if my * py * mx * px > 2 * ny * nx:
        return None
    gamma = sum(abs(w) for w in stencil_constants(cfg, dt).weights)
    damp_pads = gamma > 1.0 + 1e-12
    wrap_x, wrap_y = axis_wrap_flags(cfg)
    # The tail-mirror feeds the low side's ghost (through the cyclic
    # exchange), the wrap-head the high side's; an axis with no pad wraps
    # through the exchange alone.
    tail_y = mode_y in ("two", "low") and ly != my
    head_y = mode_y in ("two", "high") and ly != my
    tail_x = mode_x in ("two", "low") and lx != mx
    head_x = mode_x in ("two", "high") and lx != mx

    def extent(i: int, e: int, m: int, l: int) -> int:
        return m if i < e else (l if i == e else 0)

    def flags6(y: int, x: int):
        return (int(x == 0), int(x == e_x), int(y == 0), int(y == e_y), ly, lx)

    def tile_pass(c: Tiles, kk: int) -> Tiles:
        local = mesh.local_tiles()
        if damp_pads:
            for y, x in local:
                c[y][x][extent(y, e_y, my, ly):].zero_()
                c[y][x][:, extent(x, e_x, mx, lx):].zero_()
        for y, x in local:
            if tail_y and y == py - 1:
                c[y][x][my - KH:].copy_(c[y][x][ly - KH:ly])
            if tail_x and x == px - 1:
                c[y][x][:, mx - KH:].copy_(c[y][x][:, lx - KH:lx])
        # Round 1: x faces, taken into a fresh xhalo before the x head
        # patches the edge tiles.
        gl = _pshift(_tilewise(mesh, lambda y, x: c[y][x][:, -KH:]), mesh, "x", +1, wrap_x)
        gr = _pshift(_tilewise(mesh, lambda y, x: c[y][x][:, :KH]), mesh, "x", -1, wrap_x)
        xhalo = _tilewise(mesh, lambda y, x: torch.cat([gl[y][x], gr[y][x]], dim=1))
        if head_x:
            heads = _tilewise(mesh, lambda y, x: c[y][x][:, :KH])
            for y in range(py):
                head = _send(heads, mesh, (y, 0), (y, e_x), "x")
                if head is not None:
                    c[y][e_x][:, lx:lx + KH].copy_(head)
        # Round 2: the x-extended rows.
        def rows(sl: slice) -> Tiles:
            return _tilewise(mesh, lambda y, x: torch.cat(
                [xhalo[y][x][sl, :KH], c[y][x][sl], xhalo[y][x][sl, KH:]], dim=1))

        bottom, top = rows(slice(None, KH)), rows(slice(-KH, None))
        gb = _pshift(top, mesh, "y", +1, wrap_y)
        gt = _pshift(bottom, mesh, "y", -1, wrap_y)
        yhalo = _tilewise(mesh, lambda y, x: torch.cat([gb[y][x], gt[y][x]], dim=0))
        if head_y:
            for x in range(px):
                head = _send(bottom, mesh, (0, x), (e_y, x), "y")
                if head is None:
                    continue
                c[e_y][x][ly:ly + KH].copy_(head[:, KH:KH + mx])
                xh = xhalo[e_y][x]
                xh[ly:ly + KH, :KH].copy_(head[:, :KH])
                xh[ly:ly + KH, KH:].copy_(head[:, KH + mx:])
        return _tilewise(mesh, lambda y, x: carrier_tile_slab_multistep(
            c[y][x], xhalo[y][x], yhalo[y][x], flags6(y, x), cfg, dt, kk, khalo=KH))

    # The true extent of each local carrier tile as a global window
    # (y0, y1, x0, x1); all-pad tiles have none.
    windows = {}
    for y, x in mesh.local_tiles():
        h, w = extent(y, e_y, my, ly), extent(x, e_x, mx, lx)
        if h and w:
            windows[(y, x)] = (y * my, y * my + h, x * mx, x * mx + w)

    def embed_from(block: Callable, dtype: torch.dtype) -> Tiles:
        """Carrier tiles, zeros in the pad, each true extent filled with
        ``block(window, device)``: no rank builds the (ny, nx) field."""
        def tile(y: int, x: int) -> torch.Tensor:
            t = torch.zeros((my, mx), dtype=dtype, device=mesh.devices[y][x])
            if (y, x) in windows:
                y0, y1, x0, x1 = windows[(y, x)]
                t[:y1 - y0, :x1 - x0].copy_(block(windows[(y, x)], t.device))
            return t

        return _tilewise(mesh, tile)

    def embed(u: torch.Tensor) -> Tiles:
        return embed_from(lambda w, dev: u[w[0]:w[1], w[2]:w[3]], u.dtype)

    def extract(c: Tiles) -> Tiles:
        return [[c[y][x][:extent(y, e_y, my, ly), :extent(x, e_x, mx, lx)]
                 if mesh.is_local(y, x) else None
                 for x in range(e_x + 1)] for y in range(e_y + 1)]

    advance = _make_chunk_advance(tile_pass, KH, mesh)
    advance.embed, advance.embed_from, advance.extract = embed, embed_from, extract
    advance.windows = windows
    advance.carrier_shape = (my * py, mx * px)
    advance.flags6 = flags6
    advance.kernel, advance.path = "K5", "carrier"
    return advance
