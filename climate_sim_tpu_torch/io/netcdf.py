"""Self-contained classic-NetCDF codec (CDF-1, CDF-2 / 64-bit-offset, and
CDF-5 / 64-bit-data).

This is the TPU build's replacement for the reference's PnetCDF layer
(reference: src/io.cpp:378-448 uses ``ncmpi_create(NC_CLOBBER|NC_64BIT_DATA)``,
i.e. CDF-5).  The runtime image has no netCDF4/PnetCDF, so we implement the
on-disk format directly:

* :class:`NetCDFWriter` — define dims/vars/attrs, then stream record appends
  (the snapshot hot path) with an O(1) numrecs header patch per append.
* :class:`NetCDFFile` — reader for all three classic variants, used by the
  visualization package (netCDF4-compatible surface) and the file-IC path.

Format reference: the NetCDF classic format specification (and PnetCDF's
CDF-5 extension): header = magic numrecs dim_list gatt_list var_list; all
"NON_NEG" fields widen from 4 to 8 bytes in CDF-5 and the variable ``begin``
offsets widen from 4 to 8 bytes in CDF-2/5.  All values are big-endian.
Record variables store one slab per record, interleaved across record vars;
a single record variable's slab is not padded (spec note).

CDF-1/2 outputs are cross-checked against ``scipy.io.netcdf_file`` in tests;
CDF-5 round-trips through our own reader.
"""

from __future__ import annotations

import os
import struct
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

# Classic NetCDF external types.
NC_BYTE = 1
NC_CHAR = 2
NC_SHORT = 3
NC_INT = 4
NC_FLOAT = 5
NC_DOUBLE = 6
# CDF-5 additions.
NC_UBYTE = 7
NC_USHORT = 8
NC_UINT = 9
NC_INT64 = 10
NC_UINT64 = 11

_NC_DIMENSION = 0x0A
_NC_VARIABLE = 0x0B
_NC_ATTRIBUTE = 0x0C
_ABSENT_TAG = 0x00

_TYPE_TO_DTYPE = {
    NC_BYTE: np.dtype(">i1"),
    NC_CHAR: np.dtype("S1"),
    NC_SHORT: np.dtype(">i2"),
    NC_INT: np.dtype(">i4"),
    NC_FLOAT: np.dtype(">f4"),
    NC_DOUBLE: np.dtype(">f8"),
    NC_UBYTE: np.dtype(">u1"),
    NC_USHORT: np.dtype(">u2"),
    NC_UINT: np.dtype(">u4"),
    NC_INT64: np.dtype(">i8"),
    NC_UINT64: np.dtype(">u8"),
}

_KIND_TO_TYPE = {
    ("i", 1): NC_BYTE,
    ("i", 2): NC_SHORT,
    ("i", 4): NC_INT,
    ("i", 8): NC_INT64,
    ("u", 1): NC_UBYTE,
    ("u", 2): NC_USHORT,
    ("u", 4): NC_UINT,
    ("u", 8): NC_UINT64,
    ("f", 4): NC_FLOAT,
    ("f", 8): NC_DOUBLE,
}


def nc_type_for(dtype: np.dtype) -> int:
    dtype = np.dtype(dtype)
    if dtype.kind in ("S", "U"):
        return NC_CHAR
    key = (dtype.kind, dtype.itemsize)
    if key not in _KIND_TO_TYPE:
        raise TypeError(f"No classic-NetCDF type for dtype {dtype}")
    return _KIND_TO_TYPE[key]


def _pad4(n: int) -> int:
    return (4 - (n % 4)) % 4


class _HeaderEncoder:
    """Accumulates the big-endian header byte string."""

    def __init__(self, version: int):
        self.version = version
        self.parts: List[bytes] = []

    @property
    def _nonneg_fmt(self) -> str:
        return ">q" if self.version == 5 else ">i"

    def u4(self, v: int) -> None:
        self.parts.append(struct.pack(">i", v))

    def nonneg(self, v: int) -> None:
        self.parts.append(struct.pack(self._nonneg_fmt, v))

    def offset(self, v: int) -> None:
        fmt = ">q" if self.version >= 2 else ">i"
        self.parts.append(struct.pack(fmt, v))

    def name(self, s: str) -> None:
        b = s.encode("utf-8")
        self.nonneg(len(b))
        self.parts.append(b + b"\x00" * _pad4(len(b)))

    def raw(self, b: bytes) -> None:
        self.parts.append(b)

    def tobytes(self) -> bytes:
        return b"".join(self.parts)

    def size(self) -> int:
        return sum(len(p) for p in self.parts)


_CLASSIC_TYPES = frozenset(
    (NC_BYTE, NC_CHAR, NC_SHORT, NC_INT, NC_FLOAT, NC_DOUBLE)
)


def _attr_payload(value: Any, version: int = 5) -> Tuple[int, bytes, int]:
    """Encode an attribute value -> (nc_type, payload bytes, nelems).

    CDF-1/2 files only know the six classic types; 64-bit / unsigned
    integer attribute values are narrowed to NC_INT when they fit (Python
    ints default to int64 on most platforms) and rejected otherwise —
    silently emitting NC_INT64 into a CDF-1 header would produce a file
    every other reader rejects.
    """
    if isinstance(value, str):
        b = value.encode("utf-8")
        return NC_CHAR, b + b"\x00" * _pad4(len(b)), len(b)
    if isinstance(value, bytes):
        return NC_CHAR, value + b"\x00" * _pad4(len(value)), len(value)
    arr = np.atleast_1d(np.asarray(value))
    nct = nc_type_for(arr.dtype)
    if version < 5 and nct not in _CLASSIC_TYPES:
        if arr.dtype.kind in ("i", "u") and (
            arr.size == 0
            or (arr.min() >= -(2**31) and arr.max() < 2**31)
        ):
            nct = NC_INT
        else:
            raise TypeError(
                f"attribute dtype {arr.dtype} needs CDF-5 (writer version "
                f"{version}); value out of NC_INT range"
            )
    be = arr.astype(_TYPE_TO_DTYPE[nct])
    raw = be.tobytes()
    return nct, raw + b"\x00" * _pad4(len(raw)), arr.size


class NetCDFWriter:
    """Streaming classic-NetCDF writer.

    Usage::

        w = NetCDFWriter(path, version=5)
        w.def_dim("time", None)         # UNLIMITED
        w.def_dim("y", ny); w.def_dim("x", nx)
        w.def_var("u", np.float64, ("time", "y", "x"))
        w.put_gatt("description", "...")
        w.enddef()
        w.put_rec("u", 0, frame)        # appends grow the file
        w.close()
    """

    def __init__(self, path: str, version: int = 5, create: bool = True):
        """``create=False`` attaches to a file another process created with
        the SAME schema: ``enddef`` computes the identical layout but opens
        the existing file read-write instead of writing a header.  This is
        the per-process half of parallel hyperslab writes (see
        :meth:`put_rec_region`); only the creating process owns the header
        (including the numrecs field)."""
        if version not in (1, 2, 5):
            raise ValueError("version must be 1, 2, or 5")
        self.path = path
        self.version = version
        self.create = create
        self._dims: List[Tuple[str, Optional[int]]] = []
        self._dimids: Dict[str, int] = {}
        self._gatts: Dict[str, Any] = {}
        self._vars: Dict[str, Dict[str, Any]] = {}
        self._var_order: List[str] = []
        self._numrecs = 0
        self._recsize = 0
        self._defined = False
        self._f = None
        self._numrecs_offset = 4  # right after magic

    # ---- define mode ----

    def def_dim(self, name: str, size: Optional[int]) -> int:
        if self._defined:
            raise RuntimeError("def_dim after enddef")
        if size is None:
            if any(s is None for _, s in self._dims):
                raise ValueError("only one UNLIMITED dimension is allowed")
        self._dimids[name] = len(self._dims)
        self._dims.append((name, size))
        return self._dimids[name]

    def def_var(self, name: str, dtype, dims: Sequence[str], attrs: Optional[Dict] = None):
        if self._defined:
            raise RuntimeError("def_var after enddef")
        nct = nc_type_for(np.dtype(dtype))
        if self.version < 5 and nct not in _CLASSIC_TYPES:
            raise TypeError(
                f"variable dtype {np.dtype(dtype)} needs CDF-5 "
                f"(writer version {self.version})"
            )
        dimids = [self._dimids[d] for d in dims]
        isrec = bool(dimids) and self._dims[dimids[0]][1] is None
        if any(self._dims[d][1] is None for d in dimids[1:]):
            raise ValueError("only the first dimension may be UNLIMITED")
        self._vars[name] = dict(
            nc_type=nct,
            dims=list(dims),
            dimids=dimids,
            attrs=dict(attrs or {}),
            isrec=isrec,
        )
        self._var_order.append(name)

    def put_gatt(self, name: str, value: Any) -> None:
        if self._defined:
            raise RuntimeError("put_gatt after enddef")
        self._gatts[name] = value

    def put_vatt(self, var: str, name: str, value: Any) -> None:
        if self._defined:
            raise RuntimeError("put_vatt after enddef")
        self._vars[var]["attrs"][name] = value

    # ---- layout + header ----

    def _var_shape(self, v: Dict[str, Any]) -> Tuple[int, ...]:
        return tuple(self._dims[d][1] or 0 for d in v["dimids"])

    def _slab_nbytes(self, v: Dict[str, Any]) -> int:
        """Bytes of one 'unit' of the variable: the whole variable for fixed
        vars, one record for record vars (pre-padding)."""
        itemsize = _TYPE_TO_DTYPE[v["nc_type"]].itemsize
        n = 1
        dimids = v["dimids"][1:] if v["isrec"] else v["dimids"]
        for d in dimids:
            n *= self._dims[d][1]
        return n * itemsize

    def enddef(self) -> None:
        if self._defined:
            return
        rec_vars = [n for n in self._var_order if self._vars[n]["isrec"]]

        # vsize: slab size padded to 4, except a *single* record variable is
        # not padded (classic-format spec note).
        for name in self._var_order:
            v = self._vars[name]
            nbytes = self._slab_nbytes(v)
            if v["isrec"] and len(rec_vars) == 1:
                v["vsize"] = nbytes
            else:
                v["vsize"] = nbytes + _pad4(nbytes)

        # Two-pass header encode: sizes depend only on counts, so encode with
        # placeholder begins, measure, then re-encode with real offsets.
        begins = {n: 0 for n in self._var_order}
        header_len = len(self._encode_header(begins))
        offset = header_len + _pad4(header_len)
        for name in self._var_order:
            v = self._vars[name]
            if not v["isrec"]:
                begins[name] = offset
                offset += v["vsize"]
        self._rec_begin = offset
        roff = 0
        for name in rec_vars:
            begins[name] = offset + roff
            roff += self._vars[name]["vsize"]
        # (For a single record variable, roff == its unpadded vsize — the
        # vsize loop above already skipped the padding per the spec note.)
        self._recsize = roff

        self._begins = begins
        header = self._encode_header(begins)
        header += b"\x00" * _pad4(len(header))

        if self.create:
            self._f = open(self.path, "w+b")
            self._f.write(header)
            # Attaching writers on other processes read this header back as
            # soon as their open-barrier releases: make it visible now.
            self._f.flush()
        else:
            # Attach mode: the creator already wrote this header.  Verify the
            # on-disk layout matches ours byte-for-byte (numrecs excluded —
            # it advances as records are appended) so region offsets below
            # are guaranteed to land where the creator's reader expects them.
            self._f = open(self.path, "r+b")
            ondisk = self._f.read(len(header))
            w = 8 if self.version == 5 else 4
            if (len(ondisk) != len(header)
                    or ondisk[:4] != header[:4]
                    or ondisk[4 + w:] != header[4 + w:]):
                self._f.close()
                self._f = None
                raise ValueError(
                    f"{self.path}: existing header does not match this schema"
                )
        self._defined = True

    def _encode_header(self, begins: Dict[str, int]) -> bytes:
        e = _HeaderEncoder(self.version)
        e.raw(b"CDF" + bytes([self.version]))
        e.nonneg(self._numrecs)

        if self._dims:
            e.u4(_NC_DIMENSION)
            e.nonneg(len(self._dims))
            for name, size in self._dims:
                e.name(name)
                e.nonneg(0 if size is None else size)
        else:
            e.u4(_ABSENT_TAG)
            e.nonneg(0)

        self._encode_atts(e, self._gatts)

        if self._vars:
            e.u4(_NC_VARIABLE)
            e.nonneg(len(self._vars))
            for name in self._var_order:
                v = self._vars[name]
                e.name(name)
                e.nonneg(len(v["dimids"]))
                for d in v["dimids"]:
                    e.nonneg(d)
                self._encode_atts(e, v["attrs"])
                e.u4(v["nc_type"])
                e.nonneg(v["vsize"])
                e.offset(begins[name])
        else:
            e.u4(_ABSENT_TAG)
            e.nonneg(0)
        return e.tobytes()

    def _encode_atts(self, e: _HeaderEncoder, atts: Dict[str, Any]) -> None:
        if atts:
            e.u4(_NC_ATTRIBUTE)
            e.nonneg(len(atts))
            for name, value in atts.items():
                nct, payload, nelems = _attr_payload(value, self.version)
                e.name(name)
                e.u4(nct)
                e.nonneg(nelems)
                e.raw(payload)
        else:
            e.u4(_ABSENT_TAG)
            e.nonneg(0)

    # ---- data mode ----

    def _check_data(self, v: Dict[str, Any], data: np.ndarray, rec: bool) -> np.ndarray:
        dt = _TYPE_TO_DTYPE[v["nc_type"]]
        expect = self._var_shape(v)
        if rec:
            expect = expect[1:]
        data = np.asarray(data)
        if tuple(data.shape) != tuple(expect):
            raise ValueError(f"shape {data.shape} != {expect}")
        return np.ascontiguousarray(data, dtype=dt)

    def put_var(self, name: str, data) -> None:
        """Write a whole fixed-size variable."""
        if not self._defined:
            raise RuntimeError("put_var before enddef")
        v = self._vars[name]
        if v["isrec"]:
            raise ValueError("use put_rec for record variables")
        data = self._check_data(v, data, rec=False)
        self._f.seek(self._begins[name])
        self._f.write(data.tobytes())

    def put_rec(self, name: str, irec: int, data) -> None:
        """Write one record of a record variable (the snapshot hot path).

        Appending past the current numrecs grows the file and patches the
        header's numrecs field in place — the streaming analogue of the
        reference's collective ``ncmpi_put_vara_double_all`` at
        start=(step, 0, 0) (io.cpp:402-418).
        """
        if not self._defined:
            raise RuntimeError("put_rec before enddef")
        v = self._vars[name]
        if not v["isrec"]:
            raise ValueError(f"{name} is not a record variable")
        data = self._check_data(v, data, rec=True)
        off = self._begins[name] + irec * self._recsize
        self._f.seek(off)
        raw = data.tobytes()
        self._f.write(raw)
        pad = v["vsize"] - len(raw)
        if pad > 0:
            self._f.write(b"\x00" * pad)
        # Only the creating writer maintains numrecs: an attached writer
        # (create=False) patching it could shrink the creator's count.
        self._maybe_grow_numrecs(irec)

    def put_rec_region(self, name: str, irec: int, corner: Sequence[int], block) -> None:
        """Write a rectangular sub-block of one record at global indices
        ``corner`` (one start index per non-record dimension).

        This is the per-rank hyperslab write of the reference's collective
        ``ncmpi_put_vara_double_all`` at ``start={step, y_off, x_off}``
        (io.cpp:402-424): record offsets in a classic file are deterministic
        (``begin + irec*recsize`` plus the row-major element offset), so any
        number of processes can write disjoint regions of the same record
        concurrently with plain pwrites — no gather, no coordination beyond
        the header barrier at open.

        Only the creating writer maintains the header's numrecs field;
        attached writers (``create=False``) never touch the header.
        """
        if not self._defined:
            raise RuntimeError("put_rec_region before enddef")
        v = self._vars[name]
        if not v["isrec"]:
            raise ValueError(f"{name} is not a record variable")
        dt = _TYPE_TO_DTYPE[v["nc_type"]]
        full = self._var_shape(v)[1:]  # per-record shape
        block = np.ascontiguousarray(block, dtype=dt)
        corner = tuple(int(c) for c in corner)
        if len(corner) != len(full) or block.ndim != len(full):
            raise ValueError(
                f"corner/block rank {len(corner)}/{block.ndim} != {len(full)}"
            )
        for c, b, n in zip(corner, block.shape, full):
            if c < 0 or c + b > n:
                raise ValueError(f"region {corner}+{block.shape} exceeds {full}")

        rec_base = self._begins[name] + irec * self._recsize
        itemsize = dt.itemsize
        # Row-major strides (in elements) of the full per-record slab.
        strides = [1] * len(full)
        for k in range(len(full) - 2, -1, -1):
            strides[k] = strides[k + 1] * full[k + 1]

        start_el = sum(c * s for c, s in zip(corner, strides))

        # Fast path: the block spans full extents in every dim but the first
        # (e.g. a 1-D y decomposition writing full-width row bands), so it is
        # one contiguous span in the slab -> a single seek+write.
        if all(c == 0 and b == n for c, b, n in
               zip(corner[1:], block.shape[1:], full[1:])):
            self._f.seek(rec_base + start_el * itemsize)
            self._f.write(block.tobytes())
            self._maybe_grow_numrecs(irec)
            return

        # General path: one write per contiguous row segment.
        lead_shape = block.shape[:-1]
        flat = block.reshape(-1, block.shape[-1])
        for i, idx in enumerate(np.ndindex(*lead_shape) if lead_shape else [()]):
            el = sum((corner[k] + idx[k]) * strides[k] for k in range(len(idx)))
            el += corner[-1] * strides[-1]
            self._f.seek(rec_base + el * itemsize)
            self._f.write(flat[i].tobytes())
        self._maybe_grow_numrecs(irec)

    def _maybe_grow_numrecs(self, irec: int) -> None:
        if self.create and irec + 1 > self._numrecs:
            self._numrecs = irec + 1
            self._patch_numrecs()

    def _patch_numrecs(self) -> None:
        fmt = ">q" if self.version == 5 else ">i"
        self._f.seek(self._numrecs_offset)
        self._f.write(struct.pack(fmt, self._numrecs))
        self._f.seek(0, os.SEEK_END)

    def sync(self) -> None:
        if self._f:
            self._f.flush()

    def close(self) -> None:
        if self._f:
            self._f.flush()
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


# ---------------------------------------------------------------------------
# Reader
# ---------------------------------------------------------------------------


class _TruncatedHeader(ValueError):
    """Decoder ran past the buffered header window (either a genuinely
    truncated file, or a header larger than the read window)."""


class _HeaderDecoder:
    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0
        self.version = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos : self.pos + n]
        if len(b) != n:
            raise _TruncatedHeader("truncated NetCDF header")
        self.pos += n
        return b

    def u4(self) -> int:
        return struct.unpack(">i", self.take(4))[0]

    def nonneg(self) -> int:
        if self.version == 5:
            return struct.unpack(">q", self.take(8))[0]
        return struct.unpack(">i", self.take(4))[0]

    def offset(self) -> int:
        if self.version >= 2:
            return struct.unpack(">q", self.take(8))[0]
        return struct.unpack(">i", self.take(4))[0]

    def name(self) -> str:
        n = self.nonneg()
        b = self.take(n)
        self.take(_pad4(n))
        return b.decode("utf-8")


class NCVariable:
    """Lazily-read variable with numpy-style basic indexing on the first
    (record) dimension plus full-slice reads — the access patterns the
    visualization layer needs (``ds.variables['u'][step, :, :]``)."""

    def __init__(self, fileobj, name, nc_type, dims, shape, isrec, vsize, begin, attrs, recsize):
        self._file = fileobj
        self.name = name
        self.nc_type = nc_type
        self.dims = dims
        self._shape = shape  # record dim size already resolved to numrecs
        self.isrec = isrec
        self.vsize = vsize
        self.begin = begin
        self._attrs = attrs
        self._recsize = recsize
        self.dtype = _TYPE_TO_DTYPE[nc_type]

    @property
    def shape(self) -> Tuple[int, ...]:
        return self._shape

    @property
    def ndim(self) -> int:
        return len(self._shape)

    def ncattrs(self) -> List[str]:
        return list(self._attrs)

    def getncattr(self, name: str) -> Any:
        return self._attrs[name]

    def __getattr__(self, name: str):
        attrs = object.__getattribute__(self, "_attrs")
        if name in attrs:
            return attrs[name]
        raise AttributeError(name)

    def record_on_disk(self, irec: int) -> bool:
        """True when record ``irec``'s bytes for THIS variable are all
        physically present in the file (for a non-record variable: its
        whole fixed slab; ``irec`` is then ignored).  netCDF read
        semantics zero-fill missing tail data (right for growing files
        mid-write; see :meth:`_read_record`) — a RESTART consumer must
        instead refuse a truncated snapshot rather than continue from
        half-zeroed state."""
        if self.isrec:
            shape = self._shape[1:]
            count = int(np.prod(shape, dtype=np.int64)) if shape else 1
            end = self.begin + irec * self._recsize + count * self.dtype.itemsize
        else:
            count = int(np.prod(self._shape, dtype=np.int64)) if self._shape else 1
            end = self.begin + count * self.dtype.itemsize
        return os.fstat(self._file.fileno()).st_size >= end

    def _read_record(self, irec: int) -> np.ndarray:
        shape = self._shape[1:]
        count = int(np.prod(shape, dtype=np.int64)) if shape else 1
        nbytes = count * self.dtype.itemsize
        self._file.seek(self.begin + irec * self._recsize)
        raw = self._file.read(nbytes)
        if len(raw) < nbytes:
            # Tolerate a final partially-written record (zeros-fill), the way
            # netcdf libraries treat unwritten record data.
            raw = raw + b"\x00" * (nbytes - len(raw))
        return np.frombuffer(raw, dtype=self.dtype).reshape(shape)

    def _pread(self, offset: int, nbytes: int) -> bytes:
        """Positioned read that tolerates a final partially-written record
        (zero-fill), matching :meth:`_read_record`'s semantics."""
        raw = os.pread(self._file.fileno(), nbytes, offset)
        if len(raw) < nbytes:
            raw = raw + b"\x00" * (nbytes - len(raw))
        return raw

    def read_region(
        self, starts: Sequence[int], counts: Sequence[int], irec: Optional[int] = None
    ) -> np.ndarray:
        """Contiguous-hyperslab read over the non-record dimensions: returns
        the ``counts``-shaped block at ``starts`` (of record ``irec`` for
        record variables), touching only the addressed bytes.

        The read-side analogue of :meth:`NetCDFWriter.put_rec_region`: at pod
        scale each process restarts from ONLY its own shard rows instead of
        every host reading the (ny, nx) global field (the reference's
        collective per-rank hyperslab access, io.cpp:402-424, generalized to
        reads).  Row runs are coalesced into one positioned read when the
        region spans trailing dimensions in full.
        """
        shape = self._shape[1:] if self.isrec else self._shape
        if self.isrec:
            if irec is None:
                raise ValueError(f"{self.name}: record variable requires irec")
            nrec = self._shape[0]
            if irec < 0:
                irec += nrec
            if irec < 0 or irec >= nrec:
                raise IndexError(f"record {irec} out of range [0, {nrec - 1}]")
            base = self.begin + irec * self._recsize
        else:
            base = self.begin
        starts = tuple(int(s) for s in starts)
        counts = tuple(int(c) for c in counts)
        if len(starts) != len(shape) or len(counts) != len(shape):
            raise ValueError(
                f"{self.name}: region rank {len(starts)}/{len(counts)} does not"
                f" match variable rank {len(shape)}"
            )
        for s, c, n in zip(starts, counts, shape):
            if s < 0 or c < 0 or s + c > n:
                raise IndexError(
                    f"{self.name}: region [{s}, {s + c}) outside dimension of size {n}"
                )
        out = np.empty(counts, dtype=self.dtype)
        if out.size == 0:
            return out
        itemsize = self.dtype.itemsize
        ndim = len(shape)
        if ndim == 0:
            # Scalar region (e.g. one record of a scalar record variable
            # such as 'time'): a single positioned read at the base offset.
            out[()] = np.frombuffer(self._pread(base, itemsize), dtype=self.dtype)[0]
            return out
        strides = [1] * ndim  # row-major strides in items
        for i in range(ndim - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        # Largest contiguous run: trailing dims read in full fold into one read.
        d = ndim - 1
        while d > 0 and starts[d] == 0 and counts[d] == shape[d]:
            d -= 1
        run = counts[d] * strides[d]
        flat = out.reshape(-1, run)
        fixed = base + sum(starts[i] * strides[i] for i in range(d + 1)) * itemsize
        for row, idx in enumerate(np.ndindex(*counts[:d])):
            off = fixed + sum(idx[i] * strides[i] for i in range(d)) * itemsize
            flat[row] = np.frombuffer(
                self._pread(off, run * itemsize), dtype=self.dtype
            )
        return out

    def _read_all(self) -> np.ndarray:
        if self.isrec:
            nrec = self._shape[0]
            if nrec == 0:
                return np.empty(self._shape, dtype=self.dtype)
            return np.stack([self._read_record(i) for i in range(nrec)])
        count = int(np.prod(self._shape, dtype=np.int64)) if self._shape else 1
        self._file.seek(self.begin)
        raw = self._file.read(count * self.dtype.itemsize)
        return np.frombuffer(raw, dtype=self.dtype).reshape(self._shape)

    def __getitem__(self, key) -> np.ndarray:
        if self.isrec and isinstance(key, tuple) and len(key) >= 1 and isinstance(
            key[0], (int, np.integer)
        ):
            irec = int(key[0])
            nrec = self._shape[0]
            if irec < 0:
                irec += nrec
            if irec < 0 or irec >= nrec:
                raise IndexError(f"record {key[0]} out of range [0, {nrec - 1}]")
            rec = self._read_record(irec)
            rest = key[1:]
            return rec[rest] if rest else rec
        if self.isrec and isinstance(key, (int, np.integer)):
            return self[(key,)]
        if self.isrec:
            # Record-dim slices read only the touched records (a full
            # _read_all on a long run's file would pull every snapshot off
            # disk to serve u[0:2]).
            k = (key,) if isinstance(key, slice) else key
            if isinstance(k, tuple) and k and isinstance(k[0], slice):
                recs = range(*k[0].indices(self._shape[0]))
                if len(recs) == 0:
                    stack = np.empty((0,) + self._shape[1:], dtype=self.dtype)
                else:
                    stack = np.stack([self._read_record(i) for i in recs])
                rest = k[1:]
                return stack[(slice(None),) + rest] if rest else stack
        return self._read_all()[key]


class NetCDFFile:
    """Reader for CDF-1/2/5 files with a netCDF4-like surface:
    ``.dimensions`` (name -> size, record dim resolved to numrecs),
    ``.variables`` (name -> :class:`NCVariable`), ``.ncattrs()`` and
    attribute access for global attributes."""

    def __init__(self, path: str):
        self._path = path
        self._f = open(path, "rb")
        try:
            cap = 1 << 20  # headers are usually small; grown on demand
            while True:
                self._f.seek(0)
                header = self._f.read(cap)
                try:
                    self._parse_header(header)
                    break
                except _TruncatedHeader:
                    # May just mean an unusually large header (many vars/
                    # attrs): retry with a bigger window while the file
                    # actually has more bytes.
                    if (
                        len(header) == cap
                        and os.fstat(self._f.fileno()).st_size > cap
                    ):
                        cap *= 4
                        continue
                    raise
        except Exception:
            # Never leak the fd on a parse failure (scanner loops open many
            # candidate files).
            self._f.close()
            raise

    def _parse_header(self, header: bytes) -> None:
        path = self._path
        d = _HeaderDecoder(header)
        magic = d.take(4)
        if magic[:3] != b"CDF" or magic[3] not in (1, 2, 5):
            raise ValueError(f"{path}: not a classic NetCDF file (magic {magic!r})")
        d.version = magic[3]
        self.version = magic[3]

        numrecs = d.nonneg()
        streaming = numrecs in (-1, 0xFFFFFFFF)

        dims: List[Tuple[str, int]] = []
        tag = d.u4()
        ndims = d.nonneg()
        if tag == _NC_DIMENSION:
            for _ in range(ndims):
                nm = d.name()
                sz = d.nonneg()
                dims.append((nm, sz))
        self._dims = dims

        self._gatts = self._decode_atts(d)

        variables: Dict[str, NCVariable] = {}
        tag = d.u4()
        nvars = d.nonneg()
        rec_vars: List[str] = []
        raw_vars = []
        if tag == _NC_VARIABLE:
            for _ in range(nvars):
                nm = d.name()
                nd = d.nonneg()
                dimids = [d.nonneg() for _ in range(nd)]
                attrs = self._decode_atts(d)
                nct = d.u4()
                vsize = d.nonneg()
                begin = d.offset()
                isrec = bool(dimids) and dims[dimids[0]][1] == 0
                raw_vars.append((nm, dimids, attrs, nct, vsize, begin, isrec))
                if isrec:
                    rec_vars.append(nm)

        recsize = sum(v[4] for v in raw_vars if v[6])
        if len(rec_vars) == 1:
            # single record var: unpadded slab
            only = next(v for v in raw_vars if v[6])
            shape_rest = [dims[i][1] for i in only[1][1:]]
            itemsize = _TYPE_TO_DTYPE[only[3]].itemsize
            recsize = int(np.prod(shape_rest, dtype=np.int64)) * itemsize if shape_rest else itemsize

        if streaming or numrecs < 0:
            numrecs = 0
            if rec_vars and recsize > 0:
                file_end = os.fstat(self._f.fileno()).st_size
                first_rec_begin = min(v[5] for v in raw_vars if v[6])
                numrecs = max(0, (file_end - first_rec_begin) // recsize)
        self.numrecs = numrecs

        for nm, dimids, attrs, nct, vsize, begin, isrec in raw_vars:
            shape = []
            dimnames = []
            for k, di in enumerate(dimids):
                dname, dsz = dims[di]
                dimnames.append(dname)
                shape.append(numrecs if (k == 0 and isrec) else dsz)
            variables[nm] = NCVariable(
                self._f, nm, nct, dimnames, tuple(shape), isrec, vsize, begin, attrs, recsize
            )
        self.variables = variables
        # A size-0 dim is the record dim in classic files; resolve it to the
        # current record count (netCDF4's len(ds.dimensions['time']) analogue).
        self.dimensions = {nm: (numrecs if sz == 0 else sz) for nm, sz in dims}

    def _decode_atts(self, d: _HeaderDecoder) -> Dict[str, Any]:
        atts: Dict[str, Any] = {}
        tag = d.u4()
        natts = d.nonneg()
        if tag != _NC_ATTRIBUTE:
            return atts
        for _ in range(natts):
            nm = d.name()
            nct = d.u4()
            nelems = d.nonneg()
            if nct == NC_CHAR:
                raw = d.take(nelems)
                d.take(_pad4(nelems))
                atts[nm] = raw.decode("utf-8", errors="replace")
            else:
                dt = _TYPE_TO_DTYPE[nct]
                nbytes = nelems * dt.itemsize
                raw = d.take(nbytes)
                d.take(_pad4(nbytes))
                vals = np.frombuffer(raw, dtype=dt)
                atts[nm] = vals[0] if nelems == 1 else vals
        return atts

    # netCDF4-compatible global-attribute surface.
    def ncattrs(self) -> List[str]:
        return list(self._gatts)

    def getncattr(self, name: str) -> Any:
        return self._gatts[name]

    def __getattr__(self, name: str):
        gatts = object.__getattribute__(self, "_gatts")
        if name in gatts:
            return gatts[name]
        raise AttributeError(name)

    def close(self) -> None:
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
