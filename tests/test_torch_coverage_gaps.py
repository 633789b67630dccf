"""In-process tests of the port's paths that other tests reach only in
subprocesses, or not at all on a CPU: the counterpart of
tests/test_coverage_gaps.py, which keeps the line-coverage gate
(``scripts/torch_coverage_check.py``, 90%) honest.

* The nvcc build (``ops/_build.py``) on a fake ``nvcc``: a script that
  compiles a C stub of the five C entry points with the host's C compiler.
  The build directory and a copy of the sources lie in ``tmp_path``; the
  repository's ``_build/`` is never touched.
* The wrappers' launch branches (``ops/cuda_stencil.py``,
  ``ops/cuda_sharded.py``) against that stub: a CPU tensor that reports a
  CUDA device takes the branch, and the stub records the arguments each
  wrapper passes, so the tests hold the marshalling to the C interface
  (the kernels themselves run only on the card, in ``chip_smoke.py``).
* A rank's side of ``runtime/distributed.py`` in a gloo group of world
  size 1 on 127.0.0.1.
* The JAX file's cases that apply to the port: the CLI's help, version,
  unknown flags and exit codes, kernel selection, dataset sniffing and
  regions, the file IC, config keys, and mesh-shape requests.
"""

import contextlib
import ctypes
import os
import runpy
import shutil
import socket
import sys
import textwrap

import numpy as np
import pytest
import torch

from climate_sim_tpu_torch.config import BCConfig, SimConfig, bc_from_string, merged_config
from climate_sim_tpu_torch.io import datasets
from climate_sim_tpu_torch.io.datasets import load_field, sniff_format
from climate_sim_tpu_torch.io.netcdf import NetCDFWriter
from climate_sim_tpu_torch.io.snapshots import SnapshotWriter
from climate_sim_tpu_torch.ops import _build
from climate_sim_tpu_torch.ops import cuda_sharded as tsh
from climate_sim_tpu_torch.ops import cuda_stencil as tcs
from climate_sim_tpu_torch.parallel.mesh import choose_mesh_shape, make_mesh
from climate_sim_tpu_torch.runtime import distributed
from climate_sim_tpu_torch.runtime.cli import main as cli_main

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HOST_CC = shutil.which("cc") or shutil.which("gcc")
needs_cc = pytest.mark.skipif(HOST_CC is None, reason="no host C compiler")

# ------------------------------------------------- the nvcc build, faked

# The five C entry points and the error string, split by the source that
# defines them; each records its integer and floating-point arguments (K1
# also its stream, so an argument too many shows).
STUB_C = textwrap.dedent("""\
    #include <stdio.h>
    typedef long long ll;
    #define REC_I(v) stub_ints[stub_ni++] = (ll)(v)
    #define REC_D(v) stub_doubles[stub_nd++] = (v)
    #define BEGIN(id) stub_last = (id); stub_ni = 0; stub_nd = 0; stub_calls++
    #define WEIGHTS REC_D(wc); REC_D(wxm); REC_D(wxp); REC_D(wym); REC_D(wyp)
    #define SIDES(a, b, c, d) REC_I(a); REC_I(b); REC_I(c); REC_I(d)
    #ifdef SRC_multistep_stencil
    ll stub_ints[64]; double stub_doubles[16];
    int stub_ni, stub_nd, stub_last, stub_calls, stub_error;
    static char msg[64];
    const char *climate_cuda_error_string(int e) {
        snprintf(msg, sizeof msg, "stub error %d", e);
        return msg;
    }
    int climate_multistep_stencil(void *in, void *out, int ny, int nx, int k, int dtype,
            double wc, double wxm, double wxp, double wym, double wyp,
            int fl, int fr, int fb, int ft, double bcv, int bw, int rows, void *s) {
        BEGIN(1); REC_I(ny); REC_I(nx); REC_I(k); REC_I(dtype); SIDES(fl, fr, fb, ft);
        REC_I(bw); REC_I(rows); REC_I((ll)s); WEIGHTS; REC_D(bcv);
        return stub_error;
    }
    #else
    extern ll stub_ints[64]; extern double stub_doubles[16];
    extern int stub_ni, stub_nd, stub_last, stub_calls, stub_error;
    #endif
    #ifdef SRC_region_stencil
    int climate_prepadded_step(void *in, void *out, int ny, int nx, int dtype,
            double wc, double wxm, double wxp, double wym, double wyp, int bw, int rows,
            void *s) {
        BEGIN(2); REC_I(ny); REC_I(nx); REC_I(dtype); REC_I(bw); REC_I(rows); WEIGHTS;
        return stub_error;
    }
    int climate_region_multistep(void *in, ll ld_in, void *out, ll ld_out, int ny, int nx,
            int k, int kh, int dtype, double wc, double wxm, double wxp, double wym,
            double wyp, int fl, int fr, int fb, int ft, int el, int er, int eb, int et,
            double bcv, int bw, int rows, void *s) {
        BEGIN(3); REC_I(ld_in); REC_I(ld_out); REC_I(ny); REC_I(nx); REC_I(k); REC_I(kh);
        REC_I(dtype); SIDES(fl, fr, fb, ft); SIDES(el, er, eb, et); REC_I(bw); REC_I(rows);
        WEIGHTS; REC_D(bcv);
        return stub_error;
    }
    #endif
    #ifdef SRC_slab_stencil
    int climate_slab_multistep(void *t, void *xh, void *yh, void *out, int ny, int nx,
            int k, int kh, int dtype, double wc, double wxm, double wxp, double wym,
            double wyp, int fl, int fr, int fb, int ft, int el, int er, int eb, int et,
            double bcv, int bw, int rows, void *s) {
        BEGIN(4); REC_I(ny); REC_I(nx); REC_I(k); REC_I(kh); REC_I(dtype);
        SIDES(fl, fr, fb, ft); SIDES(el, er, eb, et); REC_I(bw); REC_I(rows);
        WEIGHTS; REC_D(bcv);
        return stub_error;
    }
    int climate_carrier_multistep(void *t, void *xh, void *yh, void *out, int ny, int nx,
            int ly, int lx, int k, int kh, int dtype, double wc, double wxm, double wxp,
            double wym, double wyp, int fl, int fr, int fb, int ft, int el, int er,
            int eb, int et, double bcv, int bw, int rows, void *s) {
        BEGIN(5); REC_I(ny); REC_I(nx); REC_I(ly); REC_I(lx); REC_I(k); REC_I(kh);
        REC_I(dtype); SIDES(fl, fr, fb, ft); SIDES(el, er, eb, et); REC_I(bw);
        REC_I(rows); WEIGHTS; REC_D(bcv);
        return stub_error;
    }
    #endif
""")

# A fake nvcc: logs its arguments; ``-shared`` links with the host
# compiler, anything else compiles the stub's part for the source (the
# last argument) into the object after ``-o``.  FAKE_NVCC_FAIL makes it
# fail with a message.
FAKE_NVCC = textwrap.dedent("""\
    #!/bin/sh
    echo "$@" >> {log}
    if [ -n "$FAKE_NVCC_FAIL" ]; then
        echo "fake-nvcc: error: $FAKE_NVCC_FAIL"
        exit 3
    fi
    case " $* " in
        *" -shared "*) shift; exec {cc} -shared "$@" ;;
    esac
    prev=""; for a in "$@"; do [ "$prev" = "-o" ] && obj="$a"; prev="$a"; done
    name=$(basename "$prev" .cu)
    exec {cc} -fPIC -c -DSRC_$name -o "$obj" -x c {stub}
""")


def write_fake_nvcc(bindir, log):
    bindir.mkdir(parents=True, exist_ok=True)
    stub = bindir / "stub.c"
    stub.write_text(STUB_C)
    nvcc = bindir / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(log=log, cc=HOST_CC, stub=stub))
    nvcc.chmod(0o755)
    return nvcc


@contextlib.contextmanager
def fake_toolkit(mp, root):
    """The build pointed at ``root``: a CUDA_HOME whose bin/nvcc is the
    fake, a copy of the sources, and a build directory there; the cached
    library is dropped before and after."""
    log = root / "nvcc.log"
    write_fake_nvcc(root / "cuda" / "bin", log)
    shutil.copytree(_build.CSRC_DIR, root / "csrc")
    mp.setenv("CUDA_HOME", str(root / "cuda"))
    mp.delenv("FAKE_NVCC_FAIL", raising=False)
    mp.setattr(_build, "CSRC_DIR", str(root / "csrc"))
    mp.setattr(_build, "BUILD_DIR", str(root / "build"))
    _build.load_library.cache_clear()
    try:
        yield log
    finally:
        _build.load_library.cache_clear()


def nvcc_calls(log):
    return log.read_text().splitlines() if log.exists() else []


@needs_cc
def test_find_nvcc_lookup_order(tmp_path, monkeypatch):
    """$CUDA_HOME/bin, then PATH, then the toolkit's default location; a
    CUDA_HOME without nvcc falls through to PATH."""
    made = {}
    for where in ("home", "path", "default"):
        made[where] = write_fake_nvcc(tmp_path / where / "bin", tmp_path / "log")
    monkeypatch.setattr(_build, "DEFAULT_CUDA_BIN", str(tmp_path / "default" / "bin"))
    monkeypatch.setenv("PATH", str(tmp_path / "path" / "bin"))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "home"))
    assert _build.find_nvcc() == str(made["home"])
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "nowhere"))
    assert _build.find_nvcc() == str(made["path"])
    monkeypatch.delenv("CUDA_HOME")
    assert _build.find_nvcc() == str(made["path"])
    monkeypatch.setenv("PATH", str(tmp_path / "empty"))
    assert _build.find_nvcc() == str(made["default"])
    made["default"].chmod(0o644)  # not executable: not a candidate
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


@needs_cc
def test_build_compiles_each_source_then_links_and_caches(tmp_path, monkeypatch):
    with fake_toolkit(monkeypatch, tmp_path) as log:
        kl = _build.load_library()
        assert kl.built and kl.seconds > 0
        assert os.path.dirname(kl.path) == str(tmp_path / "build")
        sources = _build.kernel_sources()
        digest = _build.sources_hash(sources + _build.kernel_headers())
        assert os.path.basename(kl.path) == f"libclimate_kernels_{digest}.so"
        calls = nvcc_calls(log)
        # One compile per source, each for sm_90a, then one link.
        assert len(calls) == len(sources) + 1
        compiles, link = calls[:-1], calls[-1]
        for src, line in zip(sorted(sources), sorted(compiles, key=lambda c: c.split()[-1])):
            assert "-gencode arch=compute_90a,code=sm_90a" in line
            assert line.split()[-1] == src and " -c -o " in line
        assert link.startswith("-shared -o ")
        assert not [n for n in os.listdir(tmp_path / "build") if n.endswith((".tmp", ".o"))]
        # _declare: every entry point typed as the C interface declares it.
        lib = kl.lib
        arity = {"climate_multistep_stencil": 19, "climate_prepadded_step": 13,
                 "climate_region_multistep": 26, "climate_slab_multistep": 26,
                 "climate_carrier_multistep": 28}
        for name, n in arity.items():
            fn = getattr(lib, name)
            assert len(fn.argtypes) == n and fn.restype is ctypes.c_int
        assert lib.climate_cuda_error_string.restype is ctypes.c_char_p
        assert lib.climate_cuda_error_string(7) == b"stub error 7"

        # A cache hit on unchanged sources: no nvcc call, the same file.
        _build.load_library.cache_clear()
        again = _build.load_library()
        assert not again.built and again.seconds == 0.0 and again.path == kl.path
        assert len(nvcc_calls(log)) == len(calls)

        # A header edit changes the hash and rebuilds.
        header = _build.kernel_headers()[0]
        with open(header, "a") as f:
            f.write("\n// edited\n")
        _build.load_library.cache_clear()
        rebuilt = _build.load_library()
        assert rebuilt.built and rebuilt.path != kl.path
        assert len(nvcc_calls(log)) == 2 * len(calls)


@needs_cc
def test_failed_compile_raises_with_nvcc_output(tmp_path, monkeypatch):
    with fake_toolkit(monkeypatch, tmp_path):
        monkeypatch.setenv("FAKE_NVCC_FAIL", "no such intrinsic")
        with pytest.raises(RuntimeError, match="nvcc failed") as e:
            _build.load_library()
        assert "fake-nvcc: error: no such intrinsic" in str(e.value)
        assert not [n for n in os.listdir(tmp_path / "build") if n.endswith(".so")]


class CudaLike(torch.Tensor):
    """A CPU tensor that reports CUDA device 0, so that a wrapper takes its
    launch branch; its data pointer is a host address the stub never
    dereferences."""

    @property
    def device(self):
        return torch.device("cuda", 0)


def cuda_like(t):
    return t.contiguous().as_subclass(CudaLike)


@pytest.fixture
def launch_env(monkeypatch):
    """What a launch branch needs from torch.cuda on a CPU-only build: the
    current device (0) and its stream (a null handle), and ``torch.empty``
    with a CUDA device giving a CudaLike."""

    class Stream:
        cuda_stream = 0

    real_empty = torch.empty

    def empty(*size, device=None, **kw):
        if device is not None and torch.device(device).type == "cuda":
            return real_empty(*size, **kw).as_subclass(CudaLike)
        return real_empty(*size, device=device, **kw)

    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: Stream())
    monkeypatch.setattr(torch, "empty", empty)


@needs_cc
def test_library_that_fails_to_load_raises_and_never_falls_back(tmp_path, monkeypatch,
                                                               launch_env):
    with fake_toolkit(monkeypatch, tmp_path) as log:
        digest = _build.sources_hash(_build.kernel_sources() + _build.kernel_headers())
        os.makedirs(tmp_path / "build")
        (tmp_path / "build" / f"libclimate_kernels_{digest}.so").write_bytes(b"not an ELF")
        with pytest.raises(OSError):
            _build.load_library()
        assert nvcc_calls(log) == []  # the file was taken as built
        tcfg = make_cfg(64, 32)
        u = cuda_like(torch.rand(32, 64))
        before = tcs.multistep_kernel_step.launches
        with pytest.raises(OSError):
            tcs.multistep_kernel_step(u, tcfg, 0.1, 2)
        assert tcs.multistep_kernel_step.launches == before


def make_cfg(nx, ny, bcs=("dirichlet", "neumann", "periodic", "periodic"), compat=False):
    cfg = SimConfig(nx=nx, ny=ny, D=0.05, vx=0.5, vy=-0.25, dt=0.1)
    cfg.bc = BCConfig(*(bc_from_string(b) for b in bcs))
    cfg.strict_reference_compat = compat
    return cfg


@pytest.fixture(scope="module")
def stub_library(tmp_path_factory):
    """The stub built once through the fake toolkit, for the launch tests."""
    if HOST_CC is None:
        pytest.skip("no host C compiler")
    root = tmp_path_factory.mktemp("stub")
    with pytest.MonkeyPatch.context() as mp, fake_toolkit(mp, root):
        kl = _build.load_library()
    return kl


def recorded(kl):
    """(entry point id, integer arguments, float arguments) of the stub's
    last call."""
    lib = kl.lib
    ni = ctypes.c_int.in_dll(lib, "stub_ni").value
    nd = ctypes.c_int.in_dll(lib, "stub_nd").value
    ints = (ctypes.c_longlong * 64).in_dll(lib, "stub_ints")[:ni]
    doubles = (ctypes.c_double * 16).in_dll(lib, "stub_doubles")[:nd]
    return ctypes.c_int.in_dll(lib, "stub_last").value, ints, doubles


@pytest.fixture
def stub(stub_library, monkeypatch, launch_env):
    monkeypatch.setattr(_build, "load_library", lambda: stub_library)
    ctypes.c_int.in_dll(stub_library.lib, "stub_error").value = 0
    yield stub_library
    ctypes.c_int.in_dll(stub_library.lib, "stub_error").value = 0


def set_stub_error(kl, err):
    ctypes.c_int.in_dll(kl.lib, "stub_error").value = err


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_k1_launch_marshals_the_c_interface(stub, dtype):
    cfg = make_cfg(100, 40, compat=False)
    u = cuda_like(torch.rand(40, 100).to(dtype))
    before = tcs.multistep_kernel_step.launches
    out = tcs.multistep_kernel_step(u, cfg, 0.1, 3)
    assert tcs.multistep_kernel_step.launches == before + 1
    assert out.shape == u.shape and out.dtype == dtype
    geo = tcs.k1_geometry(40, 100, 3, dtype)
    assert geo.cpt == tcs.WIDE_COLUMNS[dtype]
    weights, fixes = tcs.stencil_constants(cfg, 0.1)
    assert recorded(stub) == (1, [40, 100, 3, tcs._DTYPE_CODES[dtype], *fixes, geo.width,
                                  geo.rows, 0], [*weights, 0.0])
    set_stub_error(stub, 9)
    with pytest.raises(RuntimeError, match=r"K1 launch failed: CUDA error 9 \(stub error 9\)"):
        tcs.multistep_kernel_step(u, cfg, 0.1, 3)
    assert tcs.multistep_kernel_step.launches == before + 1


def test_k2_to_k5_launches_marshal_the_c_interface(stub):
    cfg = make_cfg(48, 24, bcs=("periodic", "dirichlet", "neumann", "periodic"), compat=True)
    w, fixes = tcs.stencil_constants(cfg, 0.1)
    fixes = list(fixes)
    f32 = tcs._DTYPE_CODES[torch.float32]
    k, my, mx = 4, 24, 48
    win = torch.rand(my + 2 * k, mx + 2 * k)

    up = cuda_like(win[k - 1:-(k - 1), k - 1:-(k - 1)])
    out = tsh.prepadded_kernel_step(up, cfg, 0.1)
    assert out.shape == (my, mx) and isinstance(out, CudaLike)
    geo = tcs.band_geometry(my, mx, 1)
    assert recorded(stub) == (2, [my, mx, f32, geo.width, geo.rows], list(w))

    # K3 reading a strided view of a wider window into a region of a
    # larger output.
    wide = cuda_like(torch.rand(my + 2 * k, mx + 2 * k + 10))
    big = cuda_like(torch.zeros(my + 6, mx + 6))
    region = big[3:3 + my, 3:3 + mx]
    got = tsh.tile_region_multistep(wide, (1, 0, 0, 1), cfg, 0.1, k, my, mx, out=region)
    assert got is region
    geo = tcs.band_geometry(my, mx, k)
    assert recorded(stub) == (3, [mx + 2 * k + 10, mx + 6, my, mx, k, k, f32, *fixes,
                                  1, 0, 0, 1, geo.width, geo.rows], [*w, 0.0])
    tsh.tile_region_multistep(wide, (1, 1, 1, 1), cfg, 0.1, k, my, mx, flagged=False)
    assert recorded(stub)[1][7 + 4:7 + 8] == [0, 0, 0, 0]

    tile = cuda_like(win[k:-k, k:-k])
    xh = cuda_like(torch.cat([win[k:-k, :k], win[k:-k, -k:]], 1))
    yh = cuda_like(torch.cat([win[:k], win[-k:]], 0))
    tsh.sharded_tile_slab_multistep(tile, xh, yh, (0, 1, 1, 0), cfg, 0.1, 3, khalo=k)
    geo = tcs.band_geometry(my, mx, 3)
    assert recorded(stub) == (4, [my, mx, 3, k, f32, *fixes, 0, 1, 1, 0, geo.width,
                                  geo.rows], [*w, 0.0])
    tsh.carrier_tile_slab_multistep(tile, xh, yh, (0, 1, 0, 1, 20, 41), cfg, 0.1, 3,
                                    khalo=k)
    assert recorded(stub) == (5, [my, mx, 20, 41, 3, k, f32, *fixes, 0, 1, 0, 1,
                                  geo.width, geo.rows], [*w, 0.0])

    set_stub_error(stub, 4)
    for name, call in (
        ("K2", lambda: tsh.prepadded_kernel_step(up, cfg, 0.1)),
        ("K4", lambda: tsh.sharded_tile_slab_multistep(tile, xh, yh, (0, 0, 0, 0), cfg,
                                                       0.1, 3, khalo=k)),
        ("K5", lambda: tsh.carrier_tile_slab_multistep(tile, xh, yh, (0, 0, 0, 0, 1, 1),
                                                       cfg, 0.1, 3, khalo=k)),
    ):
        with pytest.raises(RuntimeError, match=rf"{name} launch failed: CUDA error 4"):
            call()


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
def test_k1_launch_passes_its_cut_to_the_c_interface(stub, dtype):
    """Passes up to WIDE_MAX_STEPS run the wide body (cpt > 1), deeper
    ones the one-column body; each launch's band (k1_geometry's) reaches
    the C interface."""
    cfg, u = make_cfg(100, 40), cuda_like(torch.rand(40, 100).to(dtype))
    launches = tcs.multistep_kernel_step.launches
    for k in (1, 3, 8, 9, 16, 32, 4):
        tcs.multistep_kernel_step(u, cfg, 0.1, k)
        geo = tcs.k1_geometry(40, 100, k, dtype)
        assert (geo.cpt > 1) == (k <= tcs.WIDE_MAX_STEPS)
        assert recorded(stub)[1][8:] == [geo.width, geo.rows, 0]  # 0: the stream
    assert tcs.multistep_kernel_step.launches == launches + 7


D, N, P = "dirichlet", "neumann", "periodic"
# (left, right, bottom, top): fixed bottom, top, both y sides, and both
# with the x sides wrapping.
Y_FIXED = {"bottom": (P, P, D, P), "top": (D, N, P, N), "both": (D, D, D, D),
           "both_x_wrap": (P, P, D, N)}


def written_out(cfg, dt):
    """The weights and side codes by the rule, written out: diffusion
    numbers ax, ay and Courant numbers cx, cy, the upwind side taking
    the advection; Dirichlet 1, Neumann 2, periodic 0 (live wrap) or 3
    (the reference's zero ghosts under ``strict_reference_compat``)."""
    ax, ay = dt * cfg.D / (cfg.dx * cfg.dx), dt * cfg.D / (cfg.dy * cfg.dy)
    cx, cy = dt * cfg.vx / cfg.dx, dt * cfg.vy / cfg.dy
    weights = (1.0 - 2.0 * ax - 2.0 * ay - abs(cx) - abs(cy),
               ax + (cx if cfg.vx >= 0.0 else 0.0), ax + (-cx if cfg.vx < 0.0 else 0.0),
               ay + (cy if cfg.vy >= 0.0 else 0.0), ay + (-cy if cfg.vy < 0.0 else 0.0))
    code = {"dirichlet": 1, "neumann": 2,
            "periodic": 3 if cfg.strict_reference_compat else 0}
    fixes = tuple(code[b.value] for b in (cfg.bc.left, cfg.bc.right, cfg.bc.bottom,
                                          cfg.bc.top))
    return weights, fixes


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16])
@pytest.mark.parametrize("bc_class", list(Y_FIXED))
def test_k1_launch_takes_the_stencil_constants(stub, bc_class, dtype):
    """Each launch passes the side codes and weights that
    ``stencil_constants`` gives, and they are the rule's, bit for bit."""
    cfg = make_cfg(100, 40, Y_FIXED[bc_class])
    u = cuda_like(torch.rand(40, 100).to(dtype))
    weights, fixes = written_out(cfg, 0.1)
    assert tcs.stencil_constants(cfg, 0.1) == (weights, fixes)
    for k in (8, 8, 4, 16, 3):
        tcs.multistep_kernel_step(u, cfg, 0.1, k)
        _, ints, doubles = recorded(stub)
        assert ints[4:8] == list(fixes) and doubles == [*weights, 0.0]


@pytest.mark.parametrize("compat", [False, True], ids=["live", "compat"])
@pytest.mark.parametrize("bc_class", list(Y_FIXED))
def test_k2_to_k5_launches_take_the_stencil_constants(stub, bc_class, compat):
    """K2-K5 pass the same weights and side codes as K1, periodic sides
    under ``strict_reference_compat`` as the zero ghosts' code."""
    cfg = make_cfg(48, 24, Y_FIXED[bc_class], compat=compat)
    weights, fixes = written_out(cfg, 0.1)
    assert tcs.stencil_constants(cfg, 0.1) == (weights, fixes)
    k, my, mx = 3, 24, 48
    win = torch.rand(my + 2 * k, mx + 2 * k)
    tile = cuda_like(win[k:-k, k:-k])
    xh = cuda_like(torch.cat([win[k:-k, :k], win[k:-k, -k:]], 1))
    yh = cuda_like(torch.cat([win[:k], win[-k:]], 0))
    tsh.prepadded_kernel_step(cuda_like(win[k - 1:-(k - 1), k - 1:-(k - 1)]), cfg, 0.1)
    assert recorded(stub)[2] == list(weights)
    for call, at in (
        (lambda: tsh.tile_region_multistep(cuda_like(win), (1, 0, 0, 1), cfg, 0.1, k, my,
                                           mx), 7),
        (lambda: tsh.sharded_tile_slab_multistep(tile, xh, yh, (0, 1, 1, 0), cfg, 0.1, k),
         5),
        (lambda: tsh.carrier_tile_slab_multistep(tile, xh, yh, (0, 1, 0, 1, 20, 41), cfg,
                                                 0.1, k), 7),
    ):
        call()
        _, ints, doubles = recorded(stub)
        assert ints[at:at + 4] == list(fixes) and doubles == [*weights, 0.0]


def test_equal_configurations_work_out_the_constants_once(stub, monkeypatch):
    """A launch with a configuration equal to one seen before (another
    object) works out neither the constants nor the cut again."""
    u = cuda_like(torch.rand(40, 100))
    tcs.multistep_kernel_step(u, make_cfg(100, 40), 0.1, 8)
    first = recorded(stub)

    def boom(*args, **kw):
        raise AssertionError("worked out again")

    monkeypatch.setattr(tcs, "_constants", boom)
    monkeypatch.setattr(tcs, "k1_geometry", boom)
    tcs.multistep_kernel_step(u, make_cfg(100, 40), 0.1, 8)
    assert recorded(stub) == first


@pytest.mark.parametrize("change", ["dt", "vx", "vy", "bottom"])
def test_a_configuration_that_differs_gets_its_own_constants(stub, change):
    """The same configuration object, changed in dt, a velocity or one BC
    after a launch: the next launch passes the changed one's constants."""
    cfg, u, dt = make_cfg(100, 40), cuda_like(torch.rand(40, 100)), 0.1
    tcs.multistep_kernel_step(u, cfg, dt, 8)
    before = recorded(stub)
    if change == "dt":
        dt = 0.05
    elif change == "bottom":
        cfg.bc.bottom = bc_from_string("neumann")
    else:
        setattr(cfg, change, -getattr(cfg, change))
    tcs.multistep_kernel_step(u, cfg, dt, 8)
    _, ints, doubles = recorded(stub)
    weights, fixes = written_out(cfg, dt)
    assert ints[4:8] == list(fixes) and doubles == [*weights, 0.0]
    assert (ints, doubles) != before[1:]


def test_a_patch_of_k1_after_the_advance_is_built_runs_in_its_passes(monkeypatch):
    """The advance builds each chunk length once, and its passes look K1 up
    by the module's name as they run: a wrapper put there after the build
    runs every pass."""
    cfg = make_cfg(128, 128)
    advance = tcs.build_multistep_advance(cfg, 0.1)
    body = advance(19)
    assert advance(19) is body and advance.pass_count(19) == 5
    real, seen = tcs.multistep_kernel_step, []

    def spy(u, cfg_, dt, k):
        seen.append(k)
        return real(u, cfg_, dt, k)

    monkeypatch.setattr(tcs, "multistep_kernel_step", spy)
    u = torch.rand(128, 128, dtype=torch.float64)
    got = body(u)
    assert seen == tcs.pass_schedule(cfg, 19) == [4, 4, 4, 4, 3]
    want = u
    for k in seen:
        want = tcs.multistep_pass_plain(want, cfg, 0.1, k)
    assert torch.equal(got, want)


def test_launch_refuses_tensors_of_two_devices(stub):
    cfg = make_cfg(16, 16)
    tile = cuda_like(torch.rand(16, 16))
    xh, yh = torch.rand(16, 4), torch.rand(4, 20)  # on the CPU
    with pytest.raises(RuntimeError, match="one device"):
        tsh.sharded_tile_slab_multistep(tile, xh, yh, (0, 0, 0, 0), cfg, 0.1, 2)


def test_meta_tensor_is_refused_by_k1():
    cfg = make_cfg(16, 8)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tcs.multistep_kernel_step(torch.empty(8, 16, device="meta"), cfg, 0.1, 1)


# ----------------------------------------- a rank's side, in one process


def free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture
def group():
    """Leave no process group behind."""
    yield
    distributed.shutdown()


def test_rank_side_in_a_group_of_one(group, monkeypatch):
    cfg = SimConfig(distributed=f"127.0.0.1:{free_port()},1,0")
    distributed.maybe_init_distributed(cfg)
    distributed.maybe_init_distributed(cfg)  # the same spec again: a no-op
    with pytest.raises(RuntimeError, match="cannot re-initialize"):
        distributed.maybe_init_distributed(SimConfig(distributed="127.0.0.1:1,1,0"))
    assert distributed.initialized()
    assert (distributed.rank(), distributed.world_size()) == (0, 1)
    assert distributed.is_controller() and distributed.local_rank() == 0
    assert distributed.global_devices([torch.device("cpu")] * 2) == [
        (0, "cpu", "cpu"), (0, "cpu", "cpu")]
    distributed.bounded_sync("test", timeout_s=30)
    np.testing.assert_array_equal(distributed.reduce([1.0, -2.0], "sum"), [1.0, -2.0])
    assert distributed.reduce([3.0], "max")[0] == 3.0
    distributed.raise_together(None, "nothing")
    with pytest.raises(ValueError, match="mine"):
        distributed.raise_together(ValueError("mine"), "this")
    tiles = [[torch.full((2, 3), float(3 * y + x)) for x in range(3)] for y in range(2)]
    np.testing.assert_array_equal(distributed.fetch_global(tiles),
                                  np.block([[t.numpy() for t in row] for row in tiles]))
    mesh = make_mesh(2, 1, ["cpu", "cpu"])
    transport = distributed.make_transport(mesh)
    assert transport.kind == "gloo"
    assert transport.describe() == "gloo (host-staged; tiles on the CPU)"
    assert transport.exchange([], []) == []
    assert distributed._host_copy(tiles[0][0].t()).is_contiguous()

    def broken(**kw):
        raise RuntimeError("peer gone")

    monkeypatch.setattr(distributed.dist, "monitored_barrier", broken)
    with pytest.raises(RuntimeError, match="barrier 'sync' failed on rank 0: peer gone"):
        distributed.bounded_sync("sync")
    distributed.shutdown()
    assert not distributed.initialized()


def test_auto_reads_the_launcher_environment(group, monkeypatch):
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(free_port()))
    monkeypatch.setenv("LOCAL_RANK", "0")
    distributed.maybe_init_distributed(SimConfig(distributed="auto"))
    assert distributed.world_size() == 1 and distributed.local_rank() == 0


def test_malformed_spec_and_no_card(group):
    with pytest.raises(ValueError, match="coordinator:port"):
        distributed.maybe_init_distributed(SimConfig(distributed="127.0.0.1:5"))
    assert distributed.parse_spec("h:1,4,2") == ("tcp://h:1", 4, 2)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="cuda.is_available"):
            distributed.default_devices()
    assert distributed.chip_name(torch.device("cpu")) == "cpu"


def test_driver_in_a_group_of_one(group, tmp_path, capsys):
    """A run with a ``distributed`` spec of one rank: the rank's side of the
    driver (the mesh over the group's devices, the bounded barrier at the
    snapshot file) with the one-process result."""
    args = ["--nx=24", "--ny=16", "--steps=4", "--out_every=2", "--kernel=pallas",
            "--mesh.x=2", "--mesh.y=1"]
    alone = _run(args + [f"--output.dir={tmp_path}/a"])
    ranked = _run(args + [f"--output.dir={tmp_path}/b",
                          f"--distributed=127.0.0.1:{free_port()},1,0"])
    assert distributed.world_size() == 1
    np.testing.assert_array_equal(ranked.u.numpy(), alone.u.numpy())
    with open(alone.output_path, "rb") as a, open(ranked.output_path, "rb") as b:
        assert a.read() == b.read()


def _run(args):
    from climate_sim_tpu_torch.runtime.driver import run_simulation

    return run_simulation(merged_config(None, args), ["cpu", "cpu"])


# --------------------------------------------------------------- CLI


def test_cli_help_anywhere(capsys):
    """-h, and --help after an override, print the usage and start no run
    (--help and --version alone: tests/test_torch_driver.py)."""
    for argv in (["-h"], ["--nx=64", "--help"], ["run", "--steps=2", "-h"]):
        assert cli_main(argv) == 0
        assert "python -m climate_sim_tpu_torch" in capsys.readouterr().out


def test_cli_unknown_flag_warns_but_runs(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("CLIMATE_SIM_PLATFORM", "cpu")
    rc = cli_main(["--nx=16", "--ny=16", "--steps=1", "--out_every=1",
                   "--step=100", f"--output.dir={tmp_path}/o"])
    assert rc == 0
    assert "ignored unknown flag --step" in capsys.readouterr().err


def test_cli_known_flag_missing_value_warns(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("CLIMATE_SIM_PLATFORM", "cpu")
    rc = cli_main(["--nx=16", "--ny=16", "--steps=1", "--out_every=1",
                   f"--output.dir={tmp_path}/o", "--dt"])
    assert rc == 0
    assert "ignored flag --dt (missing value)" in capsys.readouterr().err


def test_cli_run_subcommand_and_config_error(capsys, tmp_path):
    assert cli_main(["run", "--nx=-3", f"--output.dir={tmp_path}/o"]) == 2
    assert "error:" in capsys.readouterr().err


def test_cli_runtime_error_exits_one(capsys, tmp_path, monkeypatch):
    monkeypatch.setenv("CLIMATE_SIM_PLATFORM", "cpu")
    rc = cli_main(["--ic.mode=file", "--ic.path=/nonexistent/x.nc",
                   "--nx=16", "--ny=16", "--steps=1", f"--output.dir={tmp_path}/o"])
    assert rc == 1
    assert "error:" in capsys.readouterr().err
    assert not os.path.exists(tmp_path / "o")


def test_cli_without_a_card_exits_one(capsys, tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the run would take it")
    monkeypatch.delenv("CLIMATE_SIM_PLATFORM", raising=False)
    rc = cli_main(["--nx=16", "--ny=16", "--steps=1", f"--output.dir={tmp_path}/o"])
    assert rc == 1
    assert "is_available" in capsys.readouterr().err


def test_module_entry_point(monkeypatch, capsys):
    monkeypatch.setattr(sys, "argv", ["climate_sim_tpu_torch", "--version"])
    with pytest.raises(SystemExit) as e:
        runpy.run_module("climate_sim_tpu_torch", run_name="__main__")
    assert e.value.code == 0
    assert "PyTorch port" in capsys.readouterr().out


# ------------------------------------------------------ kernel selection


def test_select_kernel_auto_follows_the_device():
    from climate_sim_tpu_torch.ops.step import select_kernel

    assert select_kernel(SimConfig(kernel="auto"), "cpu") == "jnp"
    assert select_kernel(SimConfig(kernel="auto"), torch.device("cuda", 0)) == "pallas"
    assert select_kernel(SimConfig(kernel="jnp"), "cuda") == "jnp"
    assert select_kernel(SimConfig(kernel="pallas"), "cpu") == "pallas"


def test_kernel_branches_build_on_cpu():
    from climate_sim_tpu_torch.ops.step import build_single_device_advance, make_interior_step

    cfg = SimConfig(nx=256, ny=256, kernel="pallas_multistep", dt=0.1)
    adv = build_single_device_advance(cfg, cfg.dt, "cpu")
    assert adv.uses_kernel and adv.kernel == "K1"
    assert make_interior_step(cfg, cfg.dt).kernel == "K2"


def test_explicit_kernel_on_cpu_runs_its_plain_version(tmp_path):
    """kernel=pallas_multistep on the CPU runs K1's plain version (the JAX
    file's interpret-mode case)."""
    from climate_sim_tpu_torch.ops.init import gaussian_hotspot
    from climate_sim_tpu_torch.ops.step import reference_step
    from climate_sim_tpu_torch.runtime.driver import run_simulation

    cfg = merged_config(None, [
        "--nx=64", "--ny=48", "--D=0.2", "--vx=1.0", "--vy=0.5",
        "--dx=0.5", "--dy=2.0", "--dt=0.2", "--steps=2", "--out_every=2",
        "--kernel=pallas_multistep", "--bc.left=periodic",
        "--bc.right=neumann", f"--output.dir={tmp_path}/o",
    ])
    res = run_simulation(cfg, "cpu")
    u = gaussian_hotspot(cfg, torch.float32, "cpu")
    for _ in range(2):
        u = reference_step(u, cfg, res.dt)
    np.testing.assert_allclose(res.u.numpy(), u.numpy(), atol=1e-5)


# ------------------------------------------------------------- datasets


def test_sniff_format_rejects_garbage(tmp_path):
    p = tmp_path / "junk.bin"
    p.write_bytes(b"NOTANC__junkjunk")
    with pytest.raises(ValueError, match="not a NetCDF file"):
        sniff_format(str(p))


def _write_h5(path, name, arr):
    h5py = pytest.importorskip("h5py")
    with h5py.File(path, "w") as f:
        f.create_dataset(name, data=arr)


def test_load_field_hdf5_2d_and_last_record(tmp_path):
    a2 = np.arange(12.0).reshape(3, 4)
    p2 = str(tmp_path / "f2.h5")
    _write_h5(p2, "u", a2)
    assert sniff_format(p2) == "hdf5"
    np.testing.assert_array_equal(load_field(p2), a2)
    p3 = str(tmp_path / "f3.h5")
    _write_h5(p3, "u", np.stack([a2, a2 + 100.0]))
    np.testing.assert_array_equal(load_field(p3), a2 + 100.0)


def test_load_field_hdf5_errors(tmp_path):
    p = str(tmp_path / "bad.h5")
    _write_h5(p, "v", np.zeros((2, 2)))
    with pytest.raises(KeyError, match="'u' not found"):
        load_field(p)
    p4 = str(tmp_path / "bad4.h5")
    _write_h5(p4, "u", np.zeros((1, 1, 2, 2)))
    with pytest.raises(ValueError, match="must be 2D"):
        load_field(p4)
    p0 = str(tmp_path / "empty.h5")
    _write_h5(p0, "u", np.zeros((0, 2, 2)))
    with pytest.raises(ValueError, match="no records"):
        load_field(p0)


def test_hdf5_without_a_reader_names_the_fix(tmp_path, monkeypatch):
    p = str(tmp_path / "f.h5")
    _write_h5(p, "u", np.zeros((2, 2)))
    monkeypatch.setitem(sys.modules, "h5py", None)
    monkeypatch.setitem(sys.modules, "netCDF4", None)
    with pytest.raises(RuntimeError, match="neither netCDF4 nor h5py"):
        load_field(p)


def _classic(path, shape, dims=("y", "x"), data=None, name="u"):
    w = NetCDFWriter(path, version=5)
    for d, n in zip(dims, shape):
        w.def_dim(d, n)
    w.def_var(name, np.float64, dims)
    w.enddef()
    w.put_var(name, np.zeros(shape) if data is None else data)
    w.close()


def test_load_field_classic_missing_var(tmp_path):
    p = str(tmp_path / "c.nc")
    _classic(p, (2, 2), name="v")
    with pytest.raises(KeyError, match="'u' not found"):
        load_field(p)


def test_load_field_region_both_formats(tmp_path):
    from climate_sim_tpu_torch.io.datasets import load_field_region, probe_field

    a2 = np.arange(48.0).reshape(6, 8)
    p_h5 = str(tmp_path / "r.h5")
    _write_h5(p_h5, "u", np.stack([a2, a2 + 100.0]))
    cfg = SimConfig(nx=8, ny=6)
    p_nc = str(tmp_path / "r.nc")
    with SnapshotWriter(p_nc, cfg) as w:
        w.write(a2)
        w.write(a2 + 100.0)
    for p in (p_h5, p_nc):
        assert probe_field(p) == (6, 8)
        np.testing.assert_array_equal(load_field_region(p, "u", 2, 3, 1, 5),
                                      (a2 + 100.0)[2:5, 1:6])
        np.testing.assert_array_equal(load_field_region(p, "u", 0, 6, 0, 8), a2 + 100.0)


def test_field_handle_bounds_check_all_backends(tmp_path):
    a = np.arange(12.0).reshape(3, 4)
    ph, pc = str(tmp_path / "f.h5"), str(tmp_path / "f.nc")
    _write_h5(ph, "u", a)
    _classic(pc, (3, 4), data=a)
    for p in (ph, pc):
        with datasets.open_field(p) as h:
            np.testing.assert_array_equal(h.read_region(1, 2, 0, 4), a[1:3])
            for region in ((2, 2, 0, 4), (0, 3, 3, 2), (0, -1, 0, 4), (0, 4, 1, -2)):
                with pytest.raises(IndexError, match="outside field"):
                    h.read_region(*region)


def test_load_field_classic_fixed_time_dim(tmp_path):
    from climate_sim_tpu_torch.io.datasets import load_field_region

    a = np.arange(24.0).reshape(2, 3, 4)
    p = str(tmp_path / "fixed_time.nc")
    _classic(p, (2, 3, 4), dims=("time", "y", "x"), data=a)  # time FIXED
    np.testing.assert_array_equal(load_field(p), a[-1])
    np.testing.assert_array_equal(load_field_region(p, "u", 1, 2, 2, 2), a[-1, 1:3, 2:4])


def test_truncated_snapshot_is_refused(tmp_path):
    cfg = SimConfig(nx=8, ny=6)
    p = str(tmp_path / "t.nc")
    with SnapshotWriter(p, cfg) as w:
        w.write(np.ones((6, 8)))
        w.write(np.ones((6, 8)))
    with open(p, "r+b") as f:
        f.truncate(os.path.getsize(p) - 16)
    with pytest.raises(ValueError, match="truncated"):
        load_field(p)


# ------------------------------------------------------------------ init


def test_unknown_ic_mode_raises_on_a_mesh():
    from climate_sim_tpu_torch.ops.init import device_initial_condition

    cfg = SimConfig(nx=16, ny=16)
    cfg.ic.mode = "bogus"
    with pytest.raises(ValueError, match="Unknown IC mode"):
        device_initial_condition(cfg, torch.float32, make_mesh(1, 1, ["cpu"]))


def _ic_file(tmp_path, seed):
    cfg = SimConfig(nx=64, ny=32)
    frame = np.random.default_rng(seed).standard_normal((32, 64))
    path = str(tmp_path / "ic.nc")
    with SnapshotWriter(path, cfg) as w:
        w.write(frame)
    cfg.ic.mode, cfg.ic.path = "file", path
    return cfg, frame


def test_device_ic_file_mode_sharded(tmp_path):
    from climate_sim_tpu_torch.ops.init import device_initial_condition
    from climate_sim_tpu_torch.parallel.mesh import gather_field

    cfg, frame = _ic_file(tmp_path, 7)
    tiles = device_initial_condition(cfg, torch.float64, make_mesh(4, 2, ["cpu"] * 8))
    np.testing.assert_allclose(gather_field(tiles).numpy(), frame)


def test_device_ic_file_mode_reads_only_tiles(tmp_path, monkeypatch):
    """The file IC opens the file once and reads only tile-sized regions,
    never the (ny, nx) field."""
    from climate_sim_tpu_torch.ops import init as init_mod
    from climate_sim_tpu_torch.parallel.mesh import gather_field

    cfg, frame = _ic_file(tmp_path, 3)
    regions, opens = [], []
    real_region, real_open = datasets.FieldHandle.read_region, datasets.open_field

    def region_spy(self, y0, ny, x0, nx):
        regions.append((ny, nx))
        return real_region(self, y0, ny, x0, nx)

    def open_spy(path_, var_="u"):
        opens.append(path_)
        return real_open(path_, var_)

    monkeypatch.setattr(datasets.FieldHandle, "read_region", region_spy)
    monkeypatch.setattr(datasets, "open_field", open_spy)
    monkeypatch.setattr(init_mod, "from_file", lambda *a, **k: pytest.fail("global read"))
    tiles = init_mod.device_initial_condition(cfg, torch.float64,
                                              make_mesh(4, 2, ["cpu"] * 8))
    np.testing.assert_allclose(gather_field(tiles).numpy(), frame)
    assert regions and all(r == (32 // 2, 64 // 4) for r in regions)
    assert len(opens) == 1


def test_device_ic_file_mode_error_contracts(tmp_path):
    from climate_sim_tpu_torch.ops.init import device_initial_condition, from_file

    cfg = SimConfig(nx=8, ny=8)
    cfg.ic.mode, cfg.ic.path = "file", ""
    mesh = make_mesh(1, 1, ["cpu"])
    with pytest.raises(ValueError, match="requires ic.path"):
        device_initial_condition(cfg, torch.float32, mesh)
    p = str(tmp_path / "small.nc")
    _classic(p, (4, 4))
    cfg.ic.path = p
    with pytest.raises(ValueError, match="does not match grid"):
        device_initial_condition(cfg, torch.float32, mesh)
    with pytest.raises(ValueError, match="does not match grid"):
        from_file(cfg)


# ---------------------------------------------------------------- config


def test_yaml_extension_keys():
    from climate_sim_tpu_torch.config import load_yaml_dict

    cfg = load_yaml_dict({
        "precision": "bf16", "kernel": "jnp",
        "mesh": {"x": 2, "y": 4, "enable": False},
        "strict_reference_compat": True, "diagnostics_every": 3, "debug_nans": True,
        "profile_dir": "/tmp/tr", "max_devices": 2, "halo_overlap": True,
        "distributed": "auto",
        "output": {"path": "/tmp/x.nc", "write_final": True, "enable": True},
        "ic": {"mode": "file", "file": "/tmp/ic.nc", "var": "u"},
    })
    assert cfg.precision == "bf16" and cfg.kernel == "jnp"
    assert (cfg.mesh.x, cfg.mesh.y, cfg.mesh.enable) == (2, 4, False)
    assert cfg.strict_reference_compat and cfg.diagnostics_every == 3
    assert cfg.debug_nans and cfg.profile_dir == "/tmp/tr"
    assert cfg.max_devices == 2 and cfg.halo_overlap
    assert cfg.distributed == "auto"
    assert cfg.output_path == "/tmp/x.nc" and cfg.write_final
    assert cfg.ic.path == "/tmp/ic.nc" and cfg.ic.var == "u"


@pytest.mark.parametrize("attr,val", [
    ("precision", "f16"), ("kernel", "cuda"), ("max_devices", -1), ("nx", 0),
    ("dt", 0.0), ("steps", -1), ("out_every", 0), ("halo_overlap", "maybe"),
    ("steps_per_pass", 33), ("dy", -1.0), ("mesh.x", 0),
])
def test_validate_extension_errors(attr, val):
    cfg = SimConfig()
    owner, _, name = attr.rpartition(".")
    setattr(getattr(cfg, owner) if owner else cfg, name, val)
    with pytest.raises(ValueError):
        cfg.validate()


def test_cli_mesh_flags_and_flat_prefix():
    from climate_sim_tpu_torch.config import apply_overrides, parse_cli_overrides

    cfg = SimConfig()
    apply_overrides(cfg, parse_cli_overrides([
        "--mesh.x=4", "--mesh.y=2", "--mesh.enable=false",
        "--output.enable=false", "--output_prefix=alt",
    ]))
    assert (cfg.mesh.x, cfg.mesh.y, cfg.mesh.enable) == (4, 2, False)
    assert cfg.output_enable is False and cfg.output_prefix == "alt"


def test_config_to_dict_round_trip_strings():
    from climate_sim_tpu_torch.config import config_to_dict

    d = config_to_dict(SimConfig())
    assert d["bc"] == {"left": "dirichlet", "right": "dirichlet",
                       "bottom": "dirichlet", "top": "dirichlet"}
    assert d["nx"] == 256


def test_bad_bc_node_rejected():
    from climate_sim_tpu_torch.config import load_yaml_dict

    with pytest.raises(ValueError, match="bad bc node"):
        load_yaml_dict({"bc": [1, 2, 3]})


# ------------------------------------------------------------------ mesh


def test_choose_mesh_shape_explicit_requests():
    assert choose_mesh_shape(8, 64, 64, req_x=4, req_y=2) == (4, 2)
    assert choose_mesh_shape(8, 64, 64, req_x=2) == (2, 4)
    assert choose_mesh_shape(8, 64, 64, req_y=2) == (4, 2)
    with pytest.raises(ValueError, match="!= device count"):
        choose_mesh_shape(8, 64, 64, req_x=3, req_y=2)
    with pytest.raises(ValueError, match="does not divide"):
        choose_mesh_shape(8, 64, 64, req_x=3)
    with pytest.raises(ValueError, match="does not divide"):
        choose_mesh_shape(8, 64, 64, req_y=3)


def test_make_mesh_insufficient_devices():
    with pytest.raises(ValueError, match="need"):
        make_mesh(64, 64, ["cpu"])
