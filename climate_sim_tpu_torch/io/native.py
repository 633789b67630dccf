"""ctypes binding to the native (C++) CDF-5 async snapshot writer: the port
of ``climate_sim_tpu/io/native.py``.

A background writer thread in ``climate_sim_tpu_torch/native/cdf5_writer.cc``
(a verbatim copy of the JAX package's ``native/src/cdf5_writer.cc``) does
the big-endian conversion and file writes off the Python thread, so snapshot
I/O overlaps device compute.

The library is built at first use with the host C++ compiler (``$CXX``, else
``c++`` or ``g++`` on PATH) and the JAX package's flags (:data:`CXX_FLAGS`), into
``climate_sim_tpu_torch/_build/libclimate_nc_<hash>.so``, the hash of the
source and the flags, under the kernel build's inter-process lock
(:func:`..ops._build.build_lock`).  Loading raises if no compiler is
available; callers (:mod:`.snapshots`) fall back to the pure-Python codec,
which writes byte-identical files.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Dict

import numpy as np

from ..ops import _build

SOURCE = os.path.join(_build.PACKAGE_DIR, "native", "cdf5_writer.cc")
# The JAX package's flags (native/Makefile), and ``-include stdexcept``: the
# source throws std::runtime_error without including <stdexcept>, which
# GCC 13's library headers no longer bring in by themselves.  The copy
# stays verbatim, so the header is forced in here.
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-shared", "-pthread", "-include", "stdexcept")

_lib = None
_lib_lock = threading.Lock()


def find_cxx() -> str:
    """``$CXX``, else ``c++`` or ``g++`` on PATH; raises when none exists."""
    for c in (os.environ.get("CXX"), "c++", "g++"):
        found = shutil.which(c) if c else None
        if found:
            return found
    raise RuntimeError("no C++ compiler ($CXX, c++ or g++) to build the native writer")


def library_path() -> str:
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    with open(SOURCE, "rb") as f:
        h.update(f.read())
    return os.path.join(_build.BUILD_DIR, f"libclimate_nc_{h.hexdigest()[:16]}.so")


def _build_library(path: str) -> None:
    """Build under the inter-process lock: the holder builds, and a process
    that waited finds the library there (the output is renamed into place,
    so no process loads a half-written file)."""
    with _build.build_lock():
        if os.path.exists(path):
            return
        tmp = f"{path}.{os.getpid()}.tmp"
        r = subprocess.run([find_cxx(), *CXX_FLAGS, "-o", tmp, SOURCE],
                           capture_output=True, text=True)
        if r.returncode != 0:
            raise RuntimeError(f"native writer build failed ({r.returncode}):\n{r.stderr}")
        os.replace(tmp, path)


def load_library() -> ctypes.CDLL:
    """Load (building if needed) the native library; thread-safe."""
    global _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        path = library_path()
        if not os.path.exists(path):
            _build_library(path)
        lib = ctypes.CDLL(path)
        lib.ncw_create.restype = ctypes.c_int64
        lib.ncw_create.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_char_p),
        ]
        lib.ncw_attach.restype = ctypes.c_int64
        lib.ncw_attach.argtypes = lib.ncw_create.argtypes
        lib.ncw_append.restype = ctypes.c_int64
        lib.ncw_append.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
        ]
        lib.ncw_append_region.restype = ctypes.c_int64
        lib.ncw_append_region.argtypes = [
            ctypes.c_int64, ctypes.POINTER(ctypes.c_double), ctypes.c_int64,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ]
        lib.ncw_flush.restype = ctypes.c_int64
        lib.ncw_flush.argtypes = [ctypes.c_int64]
        lib.ncw_queue_depth.restype = ctypes.c_int64
        lib.ncw_queue_depth.argtypes = [ctypes.c_int64]
        lib.ncw_close.restype = ctypes.c_int64
        lib.ncw_close.argtypes = [ctypes.c_int64]
        lib.ncw_last_error.restype = ctypes.c_char_p
        lib.ncw_last_error.argtypes = []
        _lib = lib
        return lib


def _last_error(lib) -> str:
    msg = lib.ncw_last_error()
    return msg.decode("utf-8", errors="replace") if msg else "unknown native I/O error"


class NativeSnapshotWriter:
    """Async snapshot writer over the native library.

    Writes the reference's frozen schema — dims time/y/x, ``u(time,y,x)``
    NC_DOUBLE, global text attrs (io.cpp:428-448) — byte-identical to
    :class:`climate_sim_tpu_torch.io.netcdf.NetCDFWriter` with version=5.
    """

    def __init__(self, path: str, cfg, attrs: Dict[str, str], create: bool = True):
        """``create=False`` attaches to a file another process created with
        the same schema (header byte-verified, numrecs left to the creator)
        — the per-rank half of parallel hyperslab writes."""
        self._lib = load_library()
        self.ny = cfg.ny
        self.nx = cfg.nx
        names = (ctypes.c_char_p * len(attrs))(
            *[k.encode("utf-8") for k in attrs]
        )
        values = (ctypes.c_char_p * len(attrs))(
            *[str(v).encode("utf-8") for v in attrs.values()]
        )
        open_fn = self._lib.ncw_create if create else self._lib.ncw_attach
        self._h = open_fn(
            path.encode("utf-8"), cfg.ny, cfg.nx, len(attrs), names, values
        )
        if not self._h:
            raise RuntimeError(
                f"ncw_{'create' if create else 'attach'} failed: "
                f"{_last_error(self._lib)}"
            )

    def append(self, irec: int, frame: np.ndarray) -> None:
        """Enqueue one (ny, nx) float64 frame; returns before the disk write."""
        frame = np.ascontiguousarray(frame, dtype=np.float64)
        if frame.shape != (self.ny, self.nx):
            raise ValueError(f"frame shape {frame.shape} != ({self.ny}, {self.nx})")
        ptr = frame.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if self._lib.ncw_append(self._h, ptr, irec) != 0:
            raise RuntimeError(f"ncw_append failed: {_last_error(self._lib)}")

    def append_region(self, irec: int, y0: int, x0: int, block: np.ndarray) -> None:
        """Enqueue one (by, bx) float64 hyperslab at rows y0.., cols x0..
        (async; copies the block) — ncmpi_put_vara_double_all analogue."""
        block = np.ascontiguousarray(block, dtype=np.float64)
        if block.ndim != 2:
            raise ValueError(f"region block must be 2D, got {block.shape}")
        by, bx = block.shape
        ptr = block.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
        if self._lib.ncw_append_region(self._h, ptr, irec, y0, x0, by, bx) != 0:
            raise RuntimeError(
                f"ncw_append_region failed: {_last_error(self._lib)}"
            )

    def flush(self) -> None:
        if self._lib.ncw_flush(self._h) != 0:
            raise RuntimeError(f"ncw_flush failed: {_last_error(self._lib)}")

    def queue_depth(self) -> int:
        return int(self._lib.ncw_queue_depth(self._h))

    def close(self) -> None:
        if self._h:
            h, self._h = self._h, 0
            if self._lib.ncw_close(h) != 0:
                raise RuntimeError(f"ncw_close failed: {_last_error(self._lib)}")

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
