"""The tile mesh: the port of ``climate_sim_tpu/parallel/mesh.py``, the
counterpart of the reference's 2D Cartesian process grid
(reference: src/decomp.cpp:5-34).

The JAX package runs its sharded path as one program over a ``Mesh`` of
devices (``shard_map``).  The port runs it in one process over a
:class:`Mesh` of torch devices: a (py, px) grid of devices, one tile of the
field each.  A device may appear more than once, so one card can run a
real 2x2 decomposition (the counterpart of JAX's virtual CPU devices), and
tiles on distinct cards exchange halos by peer copies.  Devices are laid
out in list order; the JAX package's TPU-topology layout
(``_topology_aware_grid``, ``dcn_granule_count``) has no counterpart here.

The field on a mesh is a (py, px) grid (a list of rows) of contiguous tile
tensors, tile [y][x] on ``mesh.devices[y][x]``: :func:`shard_field` and
:func:`gather_field` convert between it and the global (ny, nx) tensor.  A
grid the mesh does not divide splits as the reference splits it
(:func:`split_sizes`, decomp.cpp:29-30): the last tile of an axis takes the
remainder.  Tiles of one mesh row share a height and tiles of one mesh
column a width, so the exchanges of :mod:`.halo` take such remainder tiles
unchanged.

Across processes (:mod:`..runtime.distributed`), the mesh is laid out over
the global device list, every rank's devices in rank order (as
``jax.devices()`` orders processes), so rank r owns a contiguous row-major
run of tiles.  ``mesh.owner(y, x)`` names the rank of a tile and
``mesh.rank`` this process; a rank's tile grid holds ``None`` where the
tile is another rank's, and :func:`local_windows` gives each local tile's
global window.  :func:`shard_field` and :func:`gather_field` stay
single-process helpers.
"""

from __future__ import annotations

import collections
from typing import Dict, List, Optional, Sequence, Tuple

import torch

Tiles = List[List[Optional[torch.Tensor]]]


def dims_create(size: int) -> Tuple[int, int]:
    """Near-square factorization (px, py) with px >= py, px*py == size —
    the MPI_Dims_create(…, 2, …) contract."""
    best = (size, 1)
    a = int(size**0.5)
    while a >= 1:
        if size % a == 0:
            best = (size // a, a)
            break
        a -= 1
    return best


def choose_mesh_shape(
    n_devices: int,
    nx: int,
    ny: int,
    req_x: Optional[int] = None,
    req_y: Optional[int] = None,
) -> Tuple[int, int]:
    """Pick (px, py) for the ('x','y') decomposition of an (ny, nx) grid.

    Honors explicit requests; otherwise scans factorizations from
    near-square outward and returns the first whose shards divide the grid
    evenly.  Falls back to the near-square factorization even if indivisible
    (the driver then takes its carrier or remainder-tile path).
    """
    if req_x is not None and req_y is not None:
        if req_x * req_y != n_devices:
            raise ValueError(
                f"mesh {req_x}x{req_y} != device count {n_devices}"
            )
        return req_x, req_y
    if req_x is not None:
        if n_devices % req_x:
            raise ValueError(f"mesh.x={req_x} does not divide {n_devices}")
        return req_x, n_devices // req_x
    if req_y is not None:
        if n_devices % req_y:
            raise ValueError(f"mesh.y={req_y} does not divide {n_devices}")
        return n_devices // req_y, req_y

    # All factor pairs, ordered by closeness to square (MPI_Dims_create-like,
    # biased px >= py), preferring even division of the grid.
    pairs: List[Tuple[int, int]] = []
    a = int(n_devices**0.5)
    while a >= 1:
        if n_devices % a == 0:
            pairs.append((n_devices // a, a))
            if a != n_devices // a:
                pairs.append((a, n_devices // a))
        a -= 1
    for px, py in pairs:
        if nx % px == 0 and ny % py == 0:
            return px, py
    return dims_create(n_devices)


class Mesh:
    """A (py, px) grid of torch devices, named like JAX's ('y', 'x') mesh.

    ``shape`` is ``{"x": px, "y": py}``; ``devices[y][x]`` holds tile
    (y, x).  ``copies`` counts the halo payloads the exchanges of
    :mod:`.halo` deliver to this process's tiles, keyed ``(axis,
    wrapped)``: ``wrapped`` is True for a payload that crosses the axis's
    wrap edge (tile p-1 to tile 0 or back).

    ``owners[y][x]`` is the rank of tile (y, x) and ``rank`` this
    process's (all 0 in one process); ``chips[y][x]`` names the card the
    tile lies on, the same name on every rank (a CUDA device's UUID), so
    that :meth:`chip_count` counts four ranks on one card as one chip.
    ``transport`` carries the payloads between ranks (None in one process).
    """

    def __init__(self, grid: Sequence[Sequence[torch.device]],
                 owners: Optional[Sequence[Sequence[int]]] = None, rank: int = 0,
                 chips: Optional[Sequence[Sequence[str]]] = None):
        self.devices = tuple(tuple(torch.device(d) for d in row) for row in grid)
        py, px = len(self.devices), len(self.devices[0])
        if any(len(row) != px for row in self.devices):
            raise ValueError("mesh rows differ in length")
        self.shape = {"x": px, "y": py}
        self.owners = tuple(tuple(row) for row in owners) if owners is not None \
            else tuple((rank,) * px for _ in range(py))
        self.rank = rank
        self.chips = tuple(tuple(row) for row in chips) if chips is not None \
            else tuple(tuple(str(d) for d in row) for row in self.devices)
        self.copies = collections.Counter()
        self.transport = None
        self.rounds = 0   # exchange batches issued, the same count on every rank

    @property
    def size(self) -> int:
        return self.shape["x"] * self.shape["y"]

    def owner(self, y: int, x: int) -> int:
        return self.owners[y][x]

    def is_local(self, y: int, x: int) -> bool:
        return self.owners[y][x] == self.rank

    def local_tiles(self) -> List[Tuple[int, int]]:
        """This process's tiles (y, x), in row-major order."""
        return [(y, x) for y in range(self.shape["y"]) for x in range(self.shape["x"])
                if self.is_local(y, x)]

    def distinct_devices(self) -> List[torch.device]:
        """The devices of this process's tiles, each once, in mesh order."""
        return list(dict.fromkeys(self.devices[y][x] for y, x in self.local_tiles()))

    def chip_count(self) -> int:
        """Distinct cards under the mesh, over every rank."""
        return len({c for row in self.chips for c in row})

    def edge_flags(self, y: int, x: int) -> Tuple[int, int, int, int]:
        """[left, right, bottom, top]: 1 where tile (y, x)'s side lies on
        the physical grid edge (the MPI_PROC_NULL analogue,
        boundary.cpp:17-20)."""
        px, py = self.shape["x"], self.shape["y"]
        return (int(x == 0), int(x == px - 1), int(y == 0), int(y == py - 1))


def make_mesh(n_x: int, n_y: int, devices: Sequence,
              owners: Optional[Sequence[int]] = None, rank: int = 0,
              chips: Optional[Sequence[str]] = None) -> Mesh:
    """A (n_y, n_x) mesh over the first n_x*n_y devices, in list order;
    ``owners`` and ``chips`` run parallel to ``devices`` (the global
    device list of a multi-process run)."""
    devs = [torch.device(d) for d in devices]
    if len(devs) < n_x * n_y:
        raise ValueError(f"need {n_x * n_y} devices, have {len(devs)}")

    def rows(items):
        return None if items is None else [
            list(items[y * n_x:(y + 1) * n_x]) for y in range(n_y)]

    return Mesh(rows(devs), rows(owners), rank, rows(chips))


def divisible(mesh: Mesh, nx: int, ny: int) -> bool:
    px = mesh.shape["x"]
    py = mesh.shape["y"]
    return nx % px == 0 and ny % py == 0


def split_sizes(n: int, p: int) -> List[int]:
    """The extents of ``p`` tiles along an axis of ``n`` lines, the
    reference's decomposition (decomp.cpp:29-30): ``n // p`` each, the last
    tile ``n % p`` more.  Raises when a tile would be empty."""
    if n < p:
        raise ValueError(f"{n} lines cannot be split over {p} tiles")
    base = n // p
    return [base] * (p - 1) + [base + n % p]


def _offsets(sizes: Sequence[int]) -> List[int]:
    out = [0]
    for s in sizes:
        out.append(out[-1] + s)
    return out


def local_windows(mesh: Mesh, ny: int, nx: int) -> Dict[Tuple[int, int], Tuple[int, int, int, int]]:
    """Each local tile's global window ``(y0, y1, x0, x1)`` of the (ny, nx)
    field, the blocks cut by :func:`split_sizes`."""
    ys = _offsets(split_sizes(ny, mesh.shape["y"]))
    xs = _offsets(split_sizes(nx, mesh.shape["x"]))
    return {(y, x): (ys[y], ys[y + 1], xs[x], xs[x + 1]) for y, x in mesh.local_tiles()}


def shard_field(u: torch.Tensor, mesh: Mesh) -> Tiles:
    """The global (ny, nx) field as the mesh's tile grid: tile (y, x) is a
    contiguous copy of its block on ``mesh.devices[y][x]``, the blocks cut
    by :func:`split_sizes`."""
    ys = _offsets(split_sizes(u.shape[0], mesh.shape["y"]))
    xs = _offsets(split_sizes(u.shape[1], mesh.shape["x"]))
    return [
        [
            u[ys[y]:ys[y + 1], xs[x]:xs[x + 1]]
            .to(mesh.devices[y][x]).contiguous()
            for x in range(mesh.shape["x"])
        ]
        for y in range(mesh.shape["y"])
    ]


def gather_field(tiles: Tiles, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The inverse of :func:`shard_field`, for any grid of tiles whose rows
    share heights and columns widths: the global field on the device of
    tile (0, 0).  With ``mesh``, the grid must match its shape."""
    if mesh is not None and (
        len(tiles) != mesh.shape["y"] or any(len(r) != mesh.shape["x"] for r in tiles)
    ):
        raise ValueError(
            f"tile grid {len(tiles)}x{len(tiles[0]) if tiles else 0} does not"
            f" match the mesh (y={mesh.shape['y']}, x={mesh.shape['x']})"
        )
    dev = tiles[0][0].device
    rows = [torch.cat([t.to(dev) for t in row], dim=1) for row in tiles]
    return torch.cat(rows, dim=0)
