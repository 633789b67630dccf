"""Snapshot output with the reference's frozen NetCDF schema.

Schema (reference: src/io.cpp:378-448): dims ``time`` (UNLIMITED), ``y``
(ny_global), ``x`` (nx_global); one NC_DOUBLE variable ``u(time, y, x)``;
global text attributes ``description``, ``grid`` ("NX x NY"), ``dt``,
``steps``, ``D``, ``velocity`` ("(vx,vy)"), ``boundary_conditions``
("left=.. right=.. bottom=.. top=..").  Numbers are formatted like C++
``std::to_string`` (fixed, 6 decimals) so downstream tooling sees identical
strings.  The file is CDF-5 (NC_64BIT_DATA), matching
``ncmpi_create(NC_CLOBBER | NC_64BIT_DATA)`` (io.cpp:386).

A copy of the single-process part of ``climate_sim_tpu/io/snapshots.py``
with the pure-Python codec only: the files it writes are byte-identical to
the JAX package's, ``description`` attribute included.  The native async
writer and the per-process sharded writer are not carried over yet.
"""

from __future__ import annotations

import os
from typing import Optional

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


class SnapshotWriter:
    """Writes ``u(time, y, x)`` snapshots; one instance per run."""

    def __init__(self, path: str, cfg: SimConfig):
        self.path = path
        self.cfg = cfg
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        self._w = NetCDFWriter(path, version=5, create=True)
        _define_schema(self._w, cfg)
        self._next_index = 0

    @property
    def time_index(self) -> int:
        return self._next_index

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
        self._w.put_rec("u", idx, frame)
        self._next_index = max(self._next_index, idx + 1)
        return idx

    def close(self) -> None:
        self._w.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
