"""Snapshot output with the reference's frozen NetCDF schema.

Schema (reference: src/io.cpp:378-448): dims ``time`` (UNLIMITED), ``y``
(ny_global), ``x`` (nx_global); one NC_DOUBLE variable ``u(time, y, x)``;
global text attributes ``description``, ``grid`` ("NX x NY"), ``dt``,
``steps``, ``D``, ``velocity`` ("(vx,vy)"), ``boundary_conditions``
("left=.. right=.. bottom=.. top=..").  Numbers are formatted like C++
``std::to_string`` (fixed, 6 decimals) so downstream tooling sees identical
strings.  The file is CDF-5 (NC_64BIT_DATA), matching
``ncmpi_create(NC_CLOBBER | NC_64BIT_DATA)`` (io.cpp:386).

The port of ``climate_sim_tpu/io/snapshots.py``: the files it writes are
byte-identical to the JAX package's, ``description`` attribute included.
When the native C++ I/O runtime builds (:mod:`.native`), record appends are
handed to its background writer thread, so encoding and disk I/O overlap
device compute; else the pure-Python codec writes the same bytes.
:class:`ShardedSnapshotWriter` takes a process's own tiles and their global
offsets, where the JAX one takes a sharded ``jax.Array``.
"""

from __future__ import annotations

import os
import sys
from typing import Iterable, Optional, Tuple

import numpy as np

from ..config import SimConfig
from .netcdf import NetCDFWriter


def _cxx_to_string(v: float) -> str:
    """Format like C++ std::to_string(double): fixed, 6 decimals."""
    return f"{v:.6f}"


def metadata_attrs(cfg: SimConfig) -> dict:
    """The exact global-attribute set (reference: io.cpp:428-448)."""
    return {
        "description": "climate-sim-tpu",
        "grid": f"{cfg.nx} x {cfg.ny}",
        "dt": _cxx_to_string(cfg.dt),
        "steps": str(cfg.steps),
        "D": _cxx_to_string(cfg.D),
        "velocity": f"({_cxx_to_string(cfg.vx)},{_cxx_to_string(cfg.vy)})",
        "boundary_conditions": cfg.bc.describe(),
    }


def _define_schema(w: NetCDFWriter, cfg: SimConfig) -> None:
    """The frozen ``u(time, y, x)`` schema + global attrs (io.cpp:378-448)."""
    w.def_dim("time", None)
    w.def_dim("y", cfg.ny)
    w.def_dim("x", cfg.nx)
    w.def_var("u", np.float64, ("time", "y", "x"))
    for k, v in metadata_attrs(cfg).items():
        w.put_gatt(k, v)
    w.enddef()


def _open_backend(path: str, cfg: SimConfig, create: bool, use_native: bool):
    """Open (native_writer, python_writer): the C++ async writer when its
    shared library builds/loads, else the pure-Python codec (byte-identical
    output).  The fallback is logged once on stderr: a silently degraded
    run would lose the overlap the native path exists for."""
    if create:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)

    if use_native:
        try:
            from .native import NativeSnapshotWriter

            return (
                NativeSnapshotWriter(path, cfg, metadata_attrs(cfg), create=create),
                None,
            )
        except Exception as e:
            print(
                f"[climate_sim_tpu] native snapshot writer unavailable "
                f"({type(e).__name__}: {e}); using the Python codec",
                file=sys.stderr,
            )

    w = NetCDFWriter(path, version=5, create=create)
    _define_schema(w, cfg)
    return None, w


class _Writer:
    """What both writers share: the backend pair, the record index, close."""

    def __init__(self, path: str, cfg: SimConfig, create: bool, use_native: bool = True):
        self.path = path
        self.cfg = cfg
        self._native, self._w = _open_backend(path, cfg, create, use_native)
        self._next_index = 0

    @property
    def time_index(self) -> int:
        return self._next_index

    def sync(self) -> None:
        if self._native is not None:
            self._native.flush()
        else:
            self._w.sync()

    def close(self) -> None:
        if self._native is not None:
            self._native.close()
        elif self._w is not None:
            self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class ShardedSnapshotWriter(_Writer):
    """Per-process parallel snapshot writes: every process writes ONLY the
    regions of its own tiles, at deterministic record offsets.

    The analogue of the reference's collective per-rank hyperslab writes
    (``ncmpi_put_vara_double_all`` at ``start={step, y_off, x_off}``,
    io.cpp:402-424): all processes open the same file; the creating process
    (the controller) writes the header and maintains numrecs; everyone else
    attaches with ``create=False`` (which byte-verifies the header) and
    writes disjoint regions.  No process ever holds the (ny, nx) array.

    Caller contract: construct with ``create=True`` on exactly one process,
    barrier, then ``create=False`` elsewhere (the driver does this).
    """

    def write_shards(self, regions: Iterable[Tuple[int, int, np.ndarray]],
                     step_index: Optional[int] = None) -> int:
        """Append this process's regions of one snapshot, each ``(y0, x0,
        block)``: a block of the global interior field at rows y0.., columns
        x0..; returns the record index."""
        idx = self._next_index if step_index is None else step_index
        for y0, x0, block in regions:
            block = np.asarray(block, dtype=np.float64)
            if self._native is not None:
                self._native.append_region(idx, y0, x0, block)
            else:
                self._w.put_rec_region("u", idx, (y0, x0), block)
        self._next_index = max(self._next_index, idx + 1)
        return idx


class SnapshotWriter(_Writer):
    """Writes ``u(time, y, x)`` snapshots; one instance per run.

    ``use_native=True`` offloads appends to the C++ async writer when the
    shared library is available, falling back to the pure-Python codec.
    """

    def __init__(self, path: str, cfg: SimConfig, use_native: bool = True):
        super().__init__(path, cfg, True, use_native)

    def write(self, u, step_index: Optional[int] = None) -> int:
        """Append one snapshot (converted to float64, matching NC_DOUBLE).

        Returns the time index written.  Mirrors write_field_netcdf's
        halo-stripped interior hyperslab write (io.cpp:402-418) — here ``u``
        is already the interior global field, as a host array.
        """
        idx = self._next_index if step_index is None else step_index
        frame = np.asarray(u, dtype=np.float64)
        if frame.shape != (self.cfg.ny, self.cfg.nx):
            raise ValueError(
                f"snapshot shape {frame.shape} != (ny={self.cfg.ny}, nx={self.cfg.nx})"
            )
        if self._native is not None:
            self._native.append(idx, frame)
        else:
            self._w.put_rec("u", idx, frame)
        self._next_index = max(self._next_index, idx + 1)
        return idx
