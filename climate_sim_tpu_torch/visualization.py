"""Plots of snapshot files on an install of the port alone.

    python -m climate_sim_tpu_torch.visualization {show,compare,animate} ...

The same arguments and exit codes as ``python -m visualization.cli``.  The
``visualization`` package reads files through ``netCDF4`` or, without it,
through ``climate_sim_tpu.io.netcdf``, which imports ``jax``.  This entry
point swaps in :func:`open_dataset` as ``visualization.io._open_dataset``
for the length of a call: ``netCDF4`` when it imports, else the port's own
reader (:class:`.io.netcdf.NetCDFFile`), so the JAX package is never
reached.  ``visualization/`` itself is used as it is, and its opener is the
original again when a call returns.

The readers below (``list_available_steps``, ``load_global``,
``load_metadata``, ``SnapshotReader``) are ``visualization.io``'s, with its
error contracts, each run through that opener; they need numpy only.  The
plots need matplotlib, which is imported by the CLI alone.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

import visualization.io as _vio

from .io.netcdf import NetCDFFile


def open_dataset(nc_path: str):
    """``netCDF4.Dataset`` when netCDF4 imports, else the port's reader;
    both expose ``.dimensions``, ``.variables`` and ``.ncattrs()``."""
    try:
        import netCDF4  # type: ignore

        return netCDF4.Dataset(nc_path, "r")
    except ImportError:
        return NetCDFFile(nc_path)


@contextlib.contextmanager
def port_reader() -> Iterator[None]:
    """``visualization.io`` reads through :func:`open_dataset` inside the
    block; its own opener is restored on the way out."""
    original = _vio._open_dataset
    _vio._open_dataset = open_dataset
    try:
        yield
    finally:
        _vio._open_dataset = original


def list_available_steps(base_outputs_dir: str) -> List[int]:
    with port_reader():
        return _vio.list_available_steps(base_outputs_dir)


def load_global(base_outputs_dir: str, step: int, var: str = "u") -> np.ndarray:
    with port_reader():
        return _vio.load_global(base_outputs_dir, step, var)


def load_metadata(base_outputs_dir: str) -> Dict[str, str]:
    with port_reader():
        return _vio.load_metadata(base_outputs_dir)


class SnapshotReader(_vio.SnapshotReader):
    """``visualization.io.SnapshotReader`` over a file opened by
    :func:`open_dataset`."""

    def __init__(self, base_outputs_dir: str, var: str = "u"):
        with port_reader():
            super().__init__(base_outputs_dir, var)


def main(argv: Optional[Sequence[str]] = None) -> None:
    """``visualization.cli.main(argv)`` with the port's reader."""
    from visualization import cli

    with port_reader():
        cli.main(argv)


if __name__ == "__main__":
    main()
