"""The port's snapshot writers against the JAX package's, on the CPU.

The native writer (``climate_sim_tpu_torch/native/cdf5_writer.cc``, a
verbatim copy held to its original by
``tests/test_torch_driver.py::test_verbatim_copies_equal_their_originals``)
builds here with the host C++ compiler.  Every file is compared byte for
byte: the port's native writer, its Python codec and the JAX package's
writers, for whole records, regions and out-of-order records.  The build
lock is checked with two processes that load at once and a stubbed
compiler.
"""

import os
import subprocess
import sys
import textwrap

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.io import native as jnative
from climate_sim_tpu.io import snapshots as jsnapshots
from climate_sim_tpu.parallel.mesh import field_sharding, make_mesh as jmake_mesh

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.io import native as tnative
from climate_sim_tpu_torch.io import snapshots as tsnapshots
from climate_sim_tpu_torch.io.netcdf import NetCDFFile
from climate_sim_tpu_torch.ops import _build

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ARGS = ["--nx=48", "--ny=24", "--D=0.25", "--vx=-1.5", "--vy=0.75", "--dt=0.05",
        "--steps=7", "--bc.left=periodic", "--bc.right=periodic"]


def configs():
    return jconfig.merged_config(None, ARGS), tconfig.merged_config(None, ARGS)


def frames(n=4, seed=5):
    return np.random.default_rng(seed).normal(size=(n, 24, 48))


def read(path):
    with open(path, "rb") as f:
        return f.read()


def jax_python_file(path, cfg, records):
    with jsnapshots.SnapshotWriter(path, cfg, use_native=False) as w:
        for i, f in records:
            w.write(f, step_index=i)


def test_native_library_builds_into_the_package_build_dir():
    lib = tnative.load_library()
    path = tnative.library_path()
    assert os.path.dirname(path) == os.path.join(REPO, "climate_sim_tpu_torch", "_build")
    assert os.path.basename(path).startswith("libclimate_nc_") and os.path.exists(path)
    assert tnative.load_library() is lib
    assert tnative.SOURCE == os.path.join(REPO, "climate_sim_tpu_torch", "native",
                                          "cdf5_writer.cc")


@pytest.mark.parametrize("order", [[0, 1, 2, 3], [2, 0, 3, 1]])
def test_native_whole_records_byte_identical(tmp_path, order):
    """Whole records, in order and out of order: the port's native writer,
    the port's Python codec, JAX's native writer and JAX's Python codec
    write one file."""
    jcfg, tcfg = configs()
    fr = frames()
    records = [(i, fr[i]) for i in order]
    paths = {k: str(tmp_path / f"{k}.nc") for k in ("tn", "tp", "jn", "jp")}
    with tsnapshots.SnapshotWriter(paths["tn"], tcfg, use_native=True) as w:
        assert w._native is not None
        for i, f in records:
            w.write(f, step_index=i)
    with tsnapshots.SnapshotWriter(paths["tp"], tcfg, use_native=False) as w:
        assert w._native is None
        for i, f in records:
            w.write(f, step_index=i)
    with jnative.NativeSnapshotWriter(paths["jn"], jcfg,
                                      jsnapshots.metadata_attrs(jcfg)) as w:
        for i, f in records:
            w.append(i, f)
    jax_python_file(paths["jp"], jcfg, records)
    want = read(paths["jp"])
    for k in ("tn", "tp", "jn"):
        assert read(paths[k]) == want, k
    with NetCDFFile(paths["tn"]) as ds:
        np.testing.assert_array_equal(ds.variables["u"][:, :, :], fr)


@pytest.mark.parametrize("use_native", [True, False])
def test_sharded_writer_matches_jax_regions(tmp_path, use_native):
    """The port's ShardedSnapshotWriter, given a 2x4 grid of regions and
    their offsets, writes JAX's ShardedSnapshotWriter(use_native=False)
    file of the same sharded field, byte for byte; a creator and an
    attached writer split the regions between them, as two ranks do."""
    jcfg, tcfg = configs()
    fr = frames(3)
    jmesh = jmake_mesh(4, 2, jax.devices()[:8])
    jpath = str(tmp_path / "j.nc")
    with jsnapshots.ShardedSnapshotWriter(jpath, jcfg, create=True, use_native=False) as w:
        for f in fr:
            w.write_shards(jax.device_put(jnp.asarray(f), field_sharding(jmesh)))

    tpath = str(tmp_path / "t" / "t.nc")
    creator = tsnapshots.ShardedSnapshotWriter(tpath, tcfg, create=True,
                                               use_native=use_native)
    attached = tsnapshots.ShardedSnapshotWriter(tpath, tcfg, create=False,
                                                use_native=use_native)
    assert (creator._native is not None) == use_native
    for f in fr:
        regions = [(y0, x0, f[y0:y0 + 12, x0:x0 + 12])
                   for y0 in (0, 12) for x0 in (0, 12, 24, 36)]
        assert attached.write_shards(regions[4:]) == creator.write_shards(regions[:4])
    attached.close()
    creator.close()
    assert creator.time_index == 3
    assert read(tpath) == read(jpath)


def test_native_attach_with_a_header_mismatch_raises(tmp_path):
    _, tcfg = configs()
    path = str(tmp_path / "a.nc")
    with tsnapshots.ShardedSnapshotWriter(path, tcfg, create=True):
        pass
    other = tconfig.merged_config(None, ARGS + ["--nx=50"])
    with pytest.raises(RuntimeError, match="ncw_attach failed"):
        tnative.NativeSnapshotWriter(path, other, tsnapshots.metadata_attrs(other),
                                     create=False)
    with pytest.raises(ValueError, match="header does not match"):
        tsnapshots.ShardedSnapshotWriter(path, other, create=False, use_native=False)


def test_native_writer_unavailable_falls_back_with_one_line(tmp_path, monkeypatch, capsys):
    _, tcfg = configs()

    def boom(*a, **k):
        raise OSError("no C++ compiler in this test")

    monkeypatch.setattr(tnative, "NativeSnapshotWriter", boom)
    path = str(tmp_path / "fb.nc")
    with tsnapshots.SnapshotWriter(path, tcfg) as w:
        assert w._native is None
        w.write(frames(1)[0])
    err = capsys.readouterr().err.splitlines()
    assert err == ["[climate_sim_tpu] native snapshot writer unavailable (OSError:"
                   " no C++ compiler in this test); using the Python codec"]
    jcfg, _ = configs()
    jax_python_file(str(tmp_path / "j.nc"), jcfg, [(0, frames(1)[0])])
    assert read(path) == read(str(tmp_path / "j.nc"))


LOADER = textwrap.dedent("""
    import os, sys, time, types
    sys.path.insert(0, {repo!r})
    build_dir, which, me, peer = sys.argv[1:5]
    from climate_sim_tpu_torch.ops import _build
    _build.BUILD_DIR = build_dir
    open(me, "w").close()
    while not os.path.exists(peer):   # both processes load at once
        time.sleep(0.01)
    if which == "kernels":
        _build.ctypes = types.SimpleNamespace(CDLL=lambda path: path)
        _build._declare = lambda lib: None
        print("BUILT", _build.load_library().built)
    else:
        from climate_sim_tpu_torch.io import native
        native.load_library()
        print("LOADED", os.path.basename(native.library_path()))
""")

# A stub compiler: logs its call, takes a while, writes its output (the
# native case then runs the real host compiler).
STUB = textwrap.dedent("""\
    #!/bin/sh
    echo "$@" >> {log}
    sleep 1
    {tail}
""")
TOUCH_OUTPUT = 'prev=""; for a in "$@"; do [ "$prev" = "-o" ] && touch "$a"; prev="$a"; done'


@pytest.mark.parametrize("which", ["kernels", "native"])
def test_two_processes_that_load_at_once_build_once(tmp_path, which):
    log = tmp_path / "compiler.log"
    bindir = tmp_path / "bin"
    bindir.mkdir()
    stub = bindir / ("nvcc" if which == "kernels" else "cxx")
    real = _build.shutil.which("c++") or _build.shutil.which("g++")
    if which == "native" and real is None:
        pytest.skip("no host C++ compiler")
    tail = TOUCH_OUTPUT if which == "kernels" else f'exec {real} "$@"'
    stub.write_text(STUB.format(log=log, tail=tail))
    stub.chmod(0o755)
    env = dict(os.environ, CUDA_HOME=str(tmp_path), CXX=str(stub))
    build_dir = tmp_path / "build"
    flags = [tmp_path / "a", tmp_path / "b"]
    procs = [
        subprocess.Popen(
            [sys.executable, "-c", LOADER.format(repo=REPO), str(build_dir), which,
             str(flags[i]), str(flags[1 - i])],
            cwd=REPO, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for i in range(2)
    ]
    outs = [p.communicate(timeout=120)[0] for p in procs]
    for p, o in zip(procs, outs):
        assert p.returncode == 0, o[-2000:]
    calls = log.read_text().splitlines()
    if which == "kernels":
        # One nvcc per source and one link, once; one process built.
        assert len(calls) == len(_build.kernel_sources()) + 1
        assert sorted(o.strip().splitlines()[-1] for o in outs) == ["BUILT False",
                                                                     "BUILT True"]
    else:
        assert len(calls) == 1
        assert outs[0].strip().splitlines()[-1] == outs[1].strip().splitlines()[-1]
    assert not [n for n in os.listdir(build_dir) if n.endswith(".tmp")]
