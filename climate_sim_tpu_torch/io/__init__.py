from .netcdf import NetCDFFile, NetCDFWriter
from .snapshots import SnapshotWriter, metadata_attrs

__all__ = ["NetCDFFile", "NetCDFWriter", "SnapshotWriter", "metadata_attrs"]
