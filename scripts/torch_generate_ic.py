#!/usr/bin/env python3
"""Generate a NetCDF initial-condition file for ``ic.mode=file`` runs of the
PyTorch port.

The port's counterpart of ``scripts/generate_ic.py``: the same flags, the
same schema (dims (y, x), cell-center coordinate variables ``x``/``y``,
field variable ``u(y, x)`` float64, attributes ``units`` and
``long_name``) and the same bytes, written with the port's CDF-5 codec
(``climate_sim_tpu_torch.io.netcdf.NetCDFWriter``).  ``--format=netcdf4``
writes the HDF5 family through ``netCDF4``, else ``h5py``; without either
it fails with the ImportError.  The field is numpy on the host: the script
runs no device code.

    python scripts/torch_generate_ic.py --nx 4096 --ny 4096 --out inputs/ic.nc
    python -m climate_sim_tpu_torch --nx=4096 --ny=4096 --ic.mode=file --ic.path=inputs/ic.nc
"""

from __future__ import annotations

import argparse
import os
import sys
from typing import List, Optional

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from climate_sim_tpu_torch.io.netcdf import NetCDFWriter  # noqa: E402


def make_gaussian_ic(nx=256, ny=512, dx=1.0, dy=1.0,
                     A=1.0, sigma_frac=0.05, xc_frac=0.5, yc_frac=0.5):
    """Gaussian hotspot at cell centers (matches ops/init.py::gaussian_hotspot
    and reference init.cpp:12-33)."""
    x = (np.arange(nx) + 0.5) * dx
    y = (np.arange(ny) + 0.5) * dy
    Lx, Ly = nx * dx, ny * dy
    xc, yc = xc_frac * Lx, yc_frac * Ly
    sigma = sigma_frac * min(Lx, Ly)
    r2 = (x[None, :] - xc) ** 2 + (y[:, None] - yc) ** 2
    return A * np.exp(-r2 / (2.0 * sigma * sigma))


def write_netcdf(U, out_path, dx=1.0, dy=1.0, var="u"):
    """Classic CDF-5 output via the port's codec (the default)."""
    ny, nx = U.shape
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    w = NetCDFWriter(out_path, version=5)
    w.def_dim("y", ny)
    w.def_dim("x", nx)
    w.def_var("x", np.float64, ("x",))
    w.def_var("y", np.float64, ("y",))
    w.def_var(var, np.float64, ("y", "x"),
              attrs={"units": "arbitrary", "long_name": "Gaussian hotspot"})
    w.enddef()
    w.put_var("x", (np.arange(nx) + 0.5) * dx)
    w.put_var("y", (np.arange(ny) + 0.5) * dy)
    w.put_var(var, U)
    w.close()
    print(f"[ic] wrote {out_path} (var='{var}', {ny}x{nx}, CDF-5)")


def write_hdf5(U, out_path, dx=1.0, dy=1.0, var="u"):
    """NETCDF4-family (HDF5) output, what the reference's producer emits
    (reference generate_ic.py:23): netCDF4 when installed, else h5py with
    the same datasets, which ``climate_sim_tpu_torch.io.datasets.load_field``
    reads back alike.  Raises ImportError without either."""
    ny, nx = U.shape
    d = os.path.dirname(out_path)
    if d:
        os.makedirs(d, exist_ok=True)
    xs = (np.arange(nx) + 0.5) * dx
    ys = (np.arange(ny) + 0.5) * dy
    try:
        from netCDF4 import Dataset  # type: ignore

        with Dataset(out_path, "w", format="NETCDF4") as nc:
            nc.createDimension("x", nx)
            nc.createDimension("y", ny)
            nc.createVariable("x", "f8", ("x",))[:] = xs
            nc.createVariable("y", "f8", ("y",))[:] = ys
            uv = nc.createVariable(var, "f8", ("y", "x"))
            uv[:, :] = U
            uv.units = "arbitrary"
            uv.long_name = "Gaussian hotspot"
        kind = "NETCDF4"
    except ImportError:
        import h5py  # type: ignore

        with h5py.File(out_path, "w") as f:
            f.create_dataset("x", data=xs)
            f.create_dataset("y", data=ys)
            du = f.create_dataset(var, data=np.asarray(U, dtype=np.float64))
            du.attrs["units"] = "arbitrary"
            du.attrs["long_name"] = "Gaussian hotspot"
        kind = "HDF5"
    print(f"[ic] wrote {out_path} (var='{var}', {ny}x{nx}, {kind})")


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--nx", type=int, default=16)
    p.add_argument("--ny", type=int, default=16)
    p.add_argument("--dx", type=float, default=1.0)
    p.add_argument("--dy", type=float, default=1.0)
    # --amp is the reference spelling (generate_ic.py:46); --A the short one.
    p.add_argument("--A", "--amp", dest="A", type=float, default=1.0)
    p.add_argument("--sigma-frac", type=float, default=0.05)
    p.add_argument("--xc-frac", type=float, default=0.5)
    p.add_argument("--yc-frac", type=float, default=0.5)
    p.add_argument("--var", default="u")
    p.add_argument("--outdir", default="inputs",
                   help="Directory to place ic_global.nc if --outfile not given")
    p.add_argument("--outfile", "--out", dest="outfile", default="",
                   help="Full path to the output file")
    p.add_argument("--format", choices=["cdf5", "netcdf4"], default="cdf5",
                   help="cdf5: classic via the port's codec; netcdf4: HDF5 family")
    a = p.parse_args(argv)
    out_path = a.outfile or os.path.join(a.outdir, "ic_global.nc")
    U = make_gaussian_ic(a.nx, a.ny, a.dx, a.dy, a.A, a.sigma_frac, a.xc_frac, a.yc_frac)
    writer = write_hdf5 if a.format == "netcdf4" else write_netcdf
    try:
        writer(U, out_path, a.dx, a.dy, a.var)
    except ImportError as e:
        print(f"[ic] --format=netcdf4 needs netCDF4 or h5py: {e}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
