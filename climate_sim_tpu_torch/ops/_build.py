"""Build and load the port's CUDA kernels.

The sources under ``climate_sim_tpu_torch/csrc/`` (``*.cu``, which include
the shared ``*.cuh`` headers) compile with ``nvcc`` for ``sm_90a``, one
``nvcc`` per source, all started together, and link into one shared
library with a plain C interface, which :mod:`ctypes` loads.  The
build runs at first use, into ``climate_sim_tpu_torch/_build/``, and again
whenever the hash of the sources and headers changes: the library's file
name carries the hash.  Nothing here imports
``torch.utils.cpp_extension``, which takes minutes on the PyTorch headers.

``nvcc`` is looked up in ``$CUDA_HOME/bin``, then on ``PATH``, then in
``/usr/local/cuda/bin``; without it the build raises.

Processes that start together (the ranks of a multi-process run) build
once: the build runs under an inter-process file lock on the build
directory (:func:`build_lock`, shared with the native snapshot writer's
build), and a process that waited for the lock finds the library built.
"""

from __future__ import annotations

import contextlib
import ctypes
import fcntl
import functools
import hashlib
import os
import re
import shutil
import subprocess
import time
from dataclasses import dataclass
from typing import Dict, List

from ..runtime import tracing

PACKAGE_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PACKAGE_DIR, "csrc")
BUILD_DIR = os.path.join(PACKAGE_DIR, "_build")
DEFAULT_CUDA_BIN = "/usr/local/cuda/bin"

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)


@dataclass
class KernelLibrary:
    """The loaded library, and how it came to be."""

    lib: ctypes.CDLL
    path: str
    built: bool        # False: a library with the same hash was on disk
    seconds: float     # build time (0 on a cache hit)
    log: str           # nvcc's output, ptxas register/spill lines included


def _csrc_files(suffix: str) -> List[str]:
    names = sorted(n for n in os.listdir(CSRC_DIR) if n.endswith(suffix))
    return [os.path.join(CSRC_DIR, n) for n in names]


def kernel_sources() -> List[str]:
    """The CUDA sources the library is built from, in a fixed order."""
    sources = _csrc_files(".cu")
    if not sources:
        raise FileNotFoundError(f"no CUDA sources in {CSRC_DIR}")
    return sources


def kernel_headers() -> List[str]:
    """The headers the sources include; they enter the hash, so an edit to
    one rebuilds the library."""
    return _csrc_files(".cuh")


@functools.lru_cache(maxsize=None)
def core_constants() -> Dict[str, int]:
    """The ``constexpr int NAME = value;`` lines of ``csrc/stencil_core.cuh``:
    the core's limits (its widest band, its wide body's columns and
    threads), which the wrappers' band geometry follows.  Read from the
    header, so the kernels and the wrappers take them from one place, with
    or without a built library."""
    with open(os.path.join(CSRC_DIR, "stencil_core.cuh")) as f:
        text = f.read()
    return {m.group(1): int(m.group(2))
            for m in re.finditer(r"^constexpr int (\w+) = (\d+);", text, re.M)}


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on PATH, else the toolkit's
    default location; raises when none exists."""
    cuda_home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(cuda_home, "bin", "nvcc")] if cuda_home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append(os.path.join(DEFAULT_CUDA_BIN, "nvcc"))
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (looked in $CUDA_HOME/bin, PATH and"
        f" {DEFAULT_CUDA_BIN}); the CUDA kernels cannot be built"
    )


@contextlib.contextmanager
def build_lock():
    """Hold the build directory's inter-process lock (``flock``)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(os.path.join(BUILD_DIR, ".build.lock"), "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(lock, fcntl.LOCK_UN)


def sources_hash(sources: List[str]) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def _declare(lib: ctypes.CDLL) -> None:
    vp, ci, cd, cll = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, ctypes.c_longlong
    weights = [cd] * 5                   # wc, wxm, wxp, wym, wyp
    sides = [ci] * 4                     # left, right, bottom, top
    band = [ci] * 2                      # band_w, seg_rows (band_geometry)
    signatures = {
        # K1: in, out, ny, nx, k, dtype, weights, fixes, bc_value, band, stream
        "climate_multistep_stencil":
            [vp, vp, ci, ci, ci, ci, *weights, *sides, cd, *band, vp],
        # K2: in, out, ny, nx, dtype, weights, band, stream
        "climate_prepadded_step": [vp, vp, ci, ci, ci, *weights, *band, vp],
        # K3: in, ld_in, out, ld_out, ny, nx, k, kh, dtype, weights, fixes,
        #     edge flags, bc_value, band, stream
        "climate_region_multistep":
            [vp, cll, vp, cll, ci, ci, ci, ci, ci, *weights, *sides, *sides, cd, *band, vp],
        # K4: tile, xhalo, yhalo, out, ny, nx, k, kh, dtype, weights, fixes,
        #     edge flags, bc_value, band, stream
        "climate_slab_multistep":
            [vp, vp, vp, vp, ci, ci, ci, ci, ci, *weights, *sides, *sides, cd, *band, vp],
        # K5: K4's arguments with the true extent (ly, lx) after (ny, nx)
        "climate_carrier_multistep":
            [vp, vp, vp, vp, ci, ci, ci, ci, ci, ci, ci, *weights, *sides, *sides, cd,
             *band, vp],
    }
    for name, argtypes in signatures.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ci
    err = lib.climate_cuda_error_string
    err.argtypes = [ci]
    err.restype = ctypes.c_char_p


def _build(sources: List[str], path: str):
    """Compile each source with its own ``nvcc``, all started together,
    and link them into ``path``; returns (seconds, nvcc's output)."""
    nvcc = find_nvcc()
    tmp = f"{path}.{os.getpid()}.tmp"
    objects = [f"{tmp}.{i}.o" for i in range(len(sources))]
    t0 = time.perf_counter()
    procs = [
        subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for src, obj in zip(sources, objects)
    ]
    outs = [(p.communicate()[0], p.returncode) for p in procs]
    log = "".join(out for out, _ in outs)
    rc = next((rc for _, rc in outs if rc), 0)
    if rc == 0:
        link = subprocess.run([nvcc, "-shared", "-o", tmp, *objects],
                              capture_output=True, text=True)
        log += link.stdout + link.stderr
        rc = link.returncode
    for obj in objects:
        if os.path.exists(obj):
            os.remove(obj)
    if rc != 0:
        raise RuntimeError(f"nvcc failed ({rc}):\n{log}")
    os.replace(tmp, path)  # atomic: a reader never sees a partial file
    return time.perf_counter() - t0, log


@functools.lru_cache(maxsize=1)
def load_library() -> KernelLibrary:
    """Build the library if no build of the current sources exists, then
    load it.  Raises on a missing ``nvcc`` or a failed build.  The span
    ``climate.library`` covers it all; its note is ``built`` or
    ``loaded``."""
    with tracing.span("climate.library") as span:
        sources = kernel_sources()
        digest = sources_hash(sources + kernel_headers())
        path = os.path.join(BUILD_DIR, f"libclimate_kernels_{digest}.so")
        built, seconds, log = False, 0.0, ""
        if not os.path.exists(path):
            with build_lock():
                if not os.path.exists(path):  # else another process built it meanwhile
                    seconds, log = _build(sources, path)
                    built = True
        span.note("built" if built else "loaded")
        lib = ctypes.CDLL(path)
        _declare(lib)
        return KernelLibrary(lib=lib, path=path, built=built, seconds=seconds, log=log)
