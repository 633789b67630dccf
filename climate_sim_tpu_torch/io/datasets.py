"""Format-sniffing field access for ``ic.mode=file`` inputs.

The reference ecosystem's IC producer writes NETCDF4 (HDF5) files
(reference: scripts/generate_ic.py:23, ``Dataset(..., format="NETCDF4")``)
while this framework's own snapshots are classic CDF-5.  :func:`open_field`
yields a uniform partial-read handle on a named 2D ``(y, x)`` field — or
the LAST record of a 3D ``(time, y, x)`` variable, enabling
restart-from-snapshot — from either family:

* classic CDF-1/2/5 → the built-in codec (:class:`..netcdf.NetCDFFile`);
* HDF5 → ``netCDF4`` when installed (full fidelity), else ``h5py``
  (raw-dataset access, sufficient for the flat layouts netCDF4 writes).

So a restart file produced by the reference's own tooling — or by any
netCDF library in either format family — just works.
"""

from __future__ import annotations

import numpy as np

_HDF5_MAGIC = b"\x89HDF\r\n\x1a\n"


def sniff_format(path: str) -> str:
    """'classic' | 'hdf5' by magic bytes, or raise ValueError."""
    with open(path, "rb") as f:
        head = f.read(8)
    if head[:3] == b"CDF" and len(head) >= 4 and head[3] in (1, 2, 5):
        return "classic"
    if head == _HDF5_MAGIC:
        return "hdf5"
    raise ValueError(f"{path}: not a NetCDF file (classic or HDF5); magic {head!r}")


def _field_ndim_check(shape, path: str, var: str) -> int:
    ndim = len(shape)
    if ndim not in (2, 3):
        raise ValueError(f"{path}: variable '{var}' must be 2D (y,x) or 3D (time,y,x)")
    if ndim == 3 and shape[0] == 0:
        raise ValueError(f"{path}: variable '{var}' has no records")
    return ndim


def _h5py_file(path: str):
    try:
        import h5py  # type: ignore
    except ImportError as e:
        raise RuntimeError(
            f"{path} is an HDF5/NETCDF4 file but neither netCDF4 nor h5py is"
            " installed; convert it to classic NetCDF or install one of them"
        ) from e
    return h5py.File(path, "r")


class FieldHandle:
    """One open dataset serving any number of hyperslab reads.

    The shard-local restart primitive: at pod scale each process opens the
    file ONCE and calls :meth:`read_region` for each of its addressable
    shards, so no host ever materializes — or even transfers — the (ny, nx)
    global array (the reference's collective per-rank hyperslab access
    pattern, io.cpp:402-424, generalized to reads).  Classic files use the
    codec's positioned-read ``NCVariable.read_region``; HDF5-family files
    use the libraries' native partial reads (chunked datasets fetch only
    the touched chunks).  3D ``(time, y, x)`` variables always serve their
    LAST record (restart-from-snapshot).
    """

    def __init__(self, ds, v, backend: str, path: str, var: str):
        self._ds, self._v, self._backend = ds, v, backend
        self.path, self.var = path, var
        self.ndim = _field_ndim_check(v.shape, path, var)
        #: (ny, nx) of the field / of one record.
        self.shape = tuple(int(n) for n in v.shape[-2:])
        if backend == "classic":
            # Restart safety: the classic codec's reads zero-fill missing
            # tail bytes (netCDF growing-file semantics) — a truncated
            # snapshot would silently restart from half-zeroed state.
            # Refuse it loudly instead (the reference's fail-fast /
            # no-partial-data contract, integration_boundary_error.cpp).
            # Covers record variables (last record served), fixed-time-dim
            # 3D variables (nccopy -u output) and plain 2D fields alike.
            last = v.shape[0] - 1 if getattr(v, "isrec", False) else 0
            if not v.record_on_disk(last):
                ds.close()
                raise ValueError(
                    f"{path}: snapshot is truncated — the data for"
                    f" '{var}' is incomplete on disk; refusing to restart"
                    " from partial data"
                )

    def read_region(self, y0: int, ny: int, x0: int, nx: int) -> np.ndarray:
        """Rows ``[y0, y0+ny) × cols [x0, x0+nx)`` as float64."""
        gny, gnx = self.shape
        if y0 < 0 or x0 < 0 or ny < 0 or nx < 0 or y0 + ny > gny or x0 + nx > gnx:
            # Explicit bounds check: numpy slice semantics on the HDF5
            # backends would silently CLIP an out-of-range region — or, for
            # negative extents, return a wrong-shaped block — while the
            # classic codec raises.  Surface the same clear error on every
            # backend.
            raise IndexError(
                f"{self.path}: region [{y0},{y0 + ny})x[{x0},{x0 + nx}) "
                f"outside field ({gny}, {gnx})"
            )
        v = self._v
        if self._backend == "classic":
            if self.ndim == 3 and v.isrec:
                data = v.read_region((y0, x0), (ny, nx), irec=v.shape[0] - 1)
            elif self.ndim == 3:
                # time is a FIXED dimension (e.g. `nccopy -u` output):
                # address the last record through a full-rank region read.
                data = v.read_region((v.shape[0] - 1, y0, x0), (1, ny, nx))[0]
            else:
                data = v.read_region((y0, x0), (ny, nx))
        elif self.ndim == 3:
            data = v[v.shape[0] - 1, y0 : y0 + ny, x0 : x0 + nx]
        else:
            data = v[y0 : y0 + ny, x0 : x0 + nx]
        return np.asarray(data, dtype=np.float64)

    def read_all(self) -> np.ndarray:
        return self.read_region(0, self.shape[0], 0, self.shape[1])

    def close(self) -> None:
        self._ds.close()

    def __enter__(self) -> "FieldHandle":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def open_field(path: str, var: str = "u") -> FieldHandle:
    """Open ``var`` in ``path`` for partial reads, whatever the container
    format (the single dispatch point for classic / netCDF4 / h5py)."""
    kind = sniff_format(path)

    if kind == "classic":
        from .netcdf import NetCDFFile

        ds = NetCDFFile(path)
        backend = "classic"
        variables = ds.variables
    else:
        try:
            import netCDF4  # type: ignore
        except ImportError:
            netCDF4 = None
        if netCDF4 is not None:
            ds = netCDF4.Dataset(path, "r")
            backend = "netcdf4"
            variables = ds.variables
        else:
            ds = _h5py_file(path)
            backend = "h5py"
            variables = ds

    try:
        if var not in variables:
            raise KeyError(f"Variable '{var}' not found in {path}")
        return FieldHandle(ds, variables[var], backend, path, var)
    except Exception:
        ds.close()
        raise


def probe_field(path: str, var: str = "u"):
    """``(ny, nx)`` of the 2D field — or of one record of a 3D variable —
    without reading any data (header/metadata only)."""
    with open_field(path, var) as h:
        return h.shape


def load_field_region(path: str, var: str, y0: int, ny: int, x0: int, nx: int) -> np.ndarray:
    """One-shot open + :meth:`FieldHandle.read_region` (callers doing many
    regions should hold an :func:`open_field` handle instead)."""
    with open_field(path, var) as h:
        return h.read_region(y0, ny, x0, nx)


def load_field(path: str, var: str = "u") -> np.ndarray:
    """Read ``var`` from ``path`` as float64, whatever the container format."""
    with open_field(path, var) as h:
        return h.read_all()
