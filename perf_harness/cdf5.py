"""A reader of CDF-5 files (NetCDF's 64-bit data format), as far as the
record check needs: the header, and one record of a record variable.

The format (NetCDF's classic format specification with PnetCDF's CDF-5
extension): ``CDF\\x05``, the record count, then the lists of dimensions,
global attributes and variables.  Tags and types are 4-byte integers;
counts, lengths, dimension ids, sizes and offsets 8-byte; names and
attribute values are padded to 4 bytes; every number is big-endian.  A
record variable's record ``i`` starts at its ``begin`` plus ``i`` times
the record size, the sum of every record variable's size (a single record
variable's size is not padded).

Nothing here imports the program or a NetCDF library.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np

MAGIC = b"CDF\x05"
DIMENSION, VARIABLE, ATTRIBUTE = 0x0A, 0x0B, 0x0C
NC_DOUBLE = 6
DTYPES = {1: ">i1", 2: "S1", 3: ">i2", 4: ">i4", 5: ">f4", 6: ">f8",
          7: ">u1", 8: ">u2", 9: ">u4", 10: ">i8", 11: ">u8"}
STREAMING = 2**64 - 1  # numrecs while a writer streams: not a count
HEADER_BYTES = 1 << 20  # the most of a file's head read for its header


@dataclass(frozen=True)
class Variable:
    name: str
    nc_type: int
    dims: Tuple[int, ...]    # dimension ids
    vsize: int               # bytes of one record (of the whole, if fixed)
    begin: int


class _Cursor:
    def __init__(self, data: bytes):
        self.data, self.at = data, 0

    def take(self, n: int) -> bytes:
        if self.at + n > len(self.data):
            raise ValueError("the header runs past the bytes read")
        out = self.data[self.at:self.at + n]
        self.at += n
        return out

    def i4(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def u8(self) -> int:
        return struct.unpack(">Q", self.take(8))[0]

    def name(self) -> str:
        n = self.u8()
        s = self.take(n).decode("utf-8")
        self.take(-n % 4)
        return s

    def tagged(self, tag: int) -> int:
        """The count of a list that carries ``tag``, or 0 for an absent one."""
        got, n = self.i4(), self.u8()
        if got == 0 and n == 0:
            return 0
        if got != tag:
            raise ValueError(f"list tag {got:#x} where {tag:#x} belongs")
        return n


class Cdf5File:
    """The header of a CDF-5 file at ``path``: ``numrecs``, ``dims`` (one
    (name, length) a dimension, length None for the record dimension),
    ``attrs`` and ``variables`` by name.  Raises ValueError for anything
    that is not a CDF-5 header."""

    def __init__(self, path: str):
        self.path = path
        self.size = os.path.getsize(path)
        with open(path, "rb") as f:
            c = _Cursor(f.read(HEADER_BYTES))
        if c.take(4) != MAGIC:
            raise ValueError(f"{path} is not a CDF-5 file")
        self.numrecs = c.u8()
        if self.numrecs == STREAMING:
            raise ValueError(f"{path} holds a streaming record count")
        self.dims: List[Tuple[str, Optional[int]]] = []
        for _ in range(c.tagged(DIMENSION)):
            name, length = c.name(), c.u8()
            self.dims.append((name, length or None))
        self.attrs = self._attrs(c)
        self.variables: Dict[str, Variable] = {}
        for _ in range(c.tagged(VARIABLE)):
            name = c.name()
            dims = tuple(c.u8() for _ in range(c.u8()))
            self._attrs(c)
            nc_type, vsize, begin = c.i4(), c.u8(), c.u8()
            if nc_type not in DTYPES or any(d >= len(self.dims) for d in dims):
                raise ValueError(f"variable {name!r}: type {nc_type} or dimensions {dims}")
            self.variables[name] = Variable(name, nc_type, dims, vsize, begin)
        rec = [v for v in self.variables.values() if self.is_record(v)]
        self.recsize = sum(v.vsize for v in rec)

    def _attrs(self, c: _Cursor) -> Dict[str, object]:
        out = {}
        for _ in range(c.tagged(ATTRIBUTE)):
            name, nc_type, n = c.name(), c.i4(), c.u8()
            if nc_type not in DTYPES:
                raise ValueError(f"attribute {name!r}: type {nc_type}")
            dt = np.dtype(DTYPES[nc_type])
            raw = c.take(n * dt.itemsize)
            c.take(-(n * dt.itemsize) % 4)
            out[name] = raw.decode("utf-8") if nc_type == 2 else np.frombuffer(raw, dt)
        return out

    def is_record(self, v: Variable) -> bool:
        return bool(v.dims) and self.dims[v.dims[0]][1] is None

    def shape(self, name: str) -> Tuple[Optional[int], ...]:
        """The variable's shape, None for the record dimension."""
        return tuple(self.dims[d][1] for d in self.variables[name].dims)

    def record(self, name: str, i: int) -> np.ndarray:
        """Record ``i`` of record variable ``name``, in its own type (native
        byte order).  Raises ValueError for a record the file does not
        hold in full."""
        v = self.variables[name]
        if not self.is_record(v) or not 0 <= i < self.numrecs:
            raise ValueError(f"{name!r} has no record {i} ({self.numrecs} records)")
        shape = self.shape(name)[1:]
        dt = np.dtype(DTYPES[v.nc_type])
        count = int(np.prod(shape, dtype=np.int64))
        at = v.begin + i * self.recsize
        if at + count * dt.itemsize > self.size:
            raise ValueError(f"record {i} of {name!r} runs past the end of the file")
        data = np.fromfile(self.path, dtype=dt, count=count, offset=at)
        return data.astype(dt.newbyteorder("=")).reshape(shape)
