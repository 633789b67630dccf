"""The port's multi-process runs: real gloo ranks on the CPU.

Workers are spawned with ``subprocess`` (as tests/test_multihost.py does
for the JAX package) and import the port only.  Each group runs at the JAX
test's size (128x64, 8 steps, ``out_every=4``) with bench_4096.yaml's mixed
BCs, or the small grids that put the carrier's wrap-heads across ranks, and
its snapshot file is held to the port's single-process run of the same
mesh, byte for byte, and to the JAX package's single-process run at the
tolerances of tests/test_torch_driver.py (f64 ``1e-12``, f32 ``2e-5``).

Every worker runs under the no-global-field guard: ``gather_field``,
``apply_initial_condition``, ``io.datasets.load_field`` and
``fetch_global`` raise, and ``all_gather`` / ``all_gather_object`` raise
above 16 elements, so a run that passes built, read and gathered only its
own tiles.

The in-process tests hold the pieces of a rank's run (its IC tiles, the
carrier's per-rank embed, the spec parser, the mesh's ownership) to their
single-process counterparts.
"""

import os
import socket
import subprocess
import sys
import textwrap
import time

import jax
import numpy as np
import pytest
import torch

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.runtime import driver as jdriver

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.convert import from_reference_local
from climate_sim_tpu_torch.io.netcdf import NetCDFFile
from climate_sim_tpu_torch.io.snapshots import SnapshotWriter
from climate_sim_tpu_torch.ops.init import (
    DTYPES,
    apply_initial_condition,
    device_initial_condition,
)
from climate_sim_tpu_torch.parallel import halo as thalo
from climate_sim_tpu_torch.parallel import mesh as tmesh
from climate_sim_tpu_torch.runtime import distributed as tdist
from climate_sim_tpu_torch.runtime import driver as tdriver

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH = os.path.join(REPO, "configs", "bench_4096.yaml")
SIZE = ["--nx=128", "--ny=64", "--steps=8", "--out_every=4"]
PHYS = ["--D=0.05", "--vx=0.5", "--vy=-0.25"]

WORKER = textwrap.dedent("""
    import os, sys
    rank, port, nproc, tiles = (int(a) if a.isdigit() else a for a in sys.argv[1:5])
    sys.path.insert(0, {repo!r})
    import torch
    import torch.distributed as dist
    from climate_sim_tpu_torch.parallel import mesh as mesh_mod
    from climate_sim_tpu_torch.ops import init as init_mod
    from climate_sim_tpu_torch.io import datasets
    from climate_sim_tpu_torch.runtime import cli, distributed, driver

    def refuse(name):
        def f(*a, **k):
            raise RuntimeError("GLOBAL_FIELD: " + name)
        return f

    for mod in (mesh_mod, driver):
        mod.gather_field = refuse("gather_field")
    for mod in (init_mod, driver):
        mod.apply_initial_condition = refuse("apply_initial_condition")
    datasets.load_field = refuse("load_field")
    distributed.fetch_global = refuse("fetch_global")

    def small(obj):
        n = getattr(obj, "size", None)
        n = n() if callable(n) else n
        if n is None:
            n = len(obj) if hasattr(obj, "__len__") else 1
        return int(n) <= 16 and all(small(o) for o in obj) if isinstance(obj, (list, tuple)) \\
            else int(n) <= 16

    _all_gather, _all_gather_object = dist.all_gather, dist.all_gather_object
    def all_gather(out, tensor, *a, **k):
        if tensor.numel() > 16:
            raise RuntimeError("BIG_ALLGATHER %s" % (tuple(tensor.shape),))
        return _all_gather(out, tensor, *a, **k)
    def all_gather_object(out, obj, *a, **k):
        if not small(obj):
            raise RuntimeError("BIG_ALLGATHER object")
        return _all_gather_object(out, obj, *a, **k)
    dist.all_gather, dist.all_gather_object = all_gather, all_gather_object

    if os.environ.get("MP_KILL_CONTROLLER") and rank == 0:
        class Boom:
            def __init__(self, *a, **k):
                raise OSError(28, "No space left on device (simulated)")
        driver.ShardedSnapshotWriter = Boom

    if os.environ.get("MP_KILL_AFTER_RECORD"):
        # Hard-kill every rank right after its regions of that record are
        # synced: os._exit skips every destructor and atexit hook, as a
        # scheduler killing the job mid-run would.
        from climate_sim_tpu_torch.io import snapshots
        _write_shards = snapshots.ShardedSnapshotWriter.write_shards
        def write_then_die(self, regions, step_index=None):
            idx = _write_shards(self, regions, step_index)
            if idx >= int(os.environ["MP_KILL_AFTER_RECORD"]):
                self.sync()
                print("MP_KILLED_AT", idx, flush=True)
                os._exit(137)
            return idx
        snapshots.ShardedSnapshotWriter.write_shards = write_then_die

    if os.environ.get("MP_AUTO"):   # torchrun's environment
        os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank), WORLD_SIZE=str(nproc),
                          MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
        argv = ["--distributed=auto", *sys.argv[5:]]
    else:
        argv = ["--distributed=127.0.0.1:%s,%d,%d" % (port, nproc, rank), *sys.argv[5:]]
    if tiles == "cli":
        os.environ["CLIMATE_SIM_PLATFORM"] = "cpu"
        rc = cli.main(argv)
    else:
        from climate_sim_tpu_torch.config import extract_config_path, merged_config
        try:
            cfg = merged_config(extract_config_path(argv), argv)
            driver.run_simulation(cfg, ["cpu"] * tiles)
            rc = 0
        except Exception as e:
            print("error:", e, file=sys.stderr)
            rc = 1
        distributed.shutdown()
    if rc == 0:
        print("MP_OK", rank, flush=True)
    if os.environ.get("MP_PROBE_GUARD"):
        import torch
        probes = {{
            "gather_field": lambda: mesh_mod.gather_field([[torch.zeros(1)]]),
            "apply_initial_condition": lambda: init_mod.apply_initial_condition(None),
            "load_field": lambda: datasets.load_field("ic.nc"),
            "fetch_global": lambda: distributed.fetch_global([[torch.zeros(1)]]),
            "all_gather": lambda: dist.all_gather([torch.zeros(17)] * 2, torch.zeros(17)),
            "all_gather_object": lambda: dist.all_gather_object([None] * 2, list(range(17))),
        }}
        for name, probe in probes.items():
            try:
                probe()
            except RuntimeError as e:
                if "GLOBAL_FIELD" in str(e) or "BIG_ALLGATHER" in str(e):
                    print("GUARD", name, file=sys.stderr, flush=True)
    sys.exit(rc)
""").format(repo=REPO)


def free_port():
    s = socket.socket()
    s.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def start(nproc, tiles, args, env=None, timeout=180):
    """``nproc`` ranks of WORKER (``tiles`` CPU tiles each, or "cli": the
    CLI on one), run to their end; every rank still running when the
    group outlasts ``timeout`` seconds is killed, and the test fails."""
    port = str(free_port())
    procs = [subprocess.Popen(
        [sys.executable, "-c", WORKER, str(i), port, str(nproc), str(tiles), *args],
        cwd=REPO, env={**os.environ, **(env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in range(nproc)]
    deadline = time.monotonic() + timeout
    try:
        outs = [p.communicate(timeout=max(1.0, deadline - time.monotonic())) for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return procs, outs


def spawn(nproc, tiles, args, env=None, timeout=180):
    """:func:`start`, with one retry on a lost port."""
    for attempt in range(2):
        procs, outs = start(nproc, tiles, args, env, timeout)
        if all(p.returncode == 0 for p in procs) or attempt == 1:
            return procs, outs
    raise AssertionError("unreachable")


def assert_ok(procs, outs):
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {i} failed:\n{out[-2000:]}\n{err[-3000:]}"
        assert f"MP_OK {i}" in out
        assert "native snapshot writer unavailable" not in err
    # Only the controller logs.
    assert "climate-sim-tpu" in outs[0][0] and "timing: total_max=" in outs[0][0]
    for i, (out, _) in enumerate(outs[1:], 1):
        assert out.split() == ["MP_OK", str(i)]


def single(tmp_path, name, n, args):
    """The port's single-process run of the same mesh (``n`` CPU tiles)."""
    args = args + [f"--output.dir={tmp_path}/{name}"]
    cfg = tconfig.merged_config(tconfig.extract_config_path(args), args)
    tdriver.run_simulation(cfg, ["cpu"] * n)
    return cfg.resolved_output_path()


def read(path):
    with open(path, "rb") as f:
        return f.read()


def frames(path):
    with NetCDFFile(path) as ds:
        return np.asarray(ds.variables["u"][:, :, :])


@pytest.mark.parametrize("kernel, precision", [("jnp", "f64"), ("pallas", "f32")])
def test_two_ranks_of_four_tiles_match_single_process_and_jax(tmp_path, kernel, precision):
    """The 8-tile mesh of the JAX package's two-process test (2 ranks x 4
    tiles, a 4x2 mesh): per-step torch ops (``jnp``) and K4's plain
    version (``pallas``)."""
    args = [f"--config={BENCH}", *SIZE, f"--kernel={kernel}", f"--precision={precision}",
            "--write_final=true"]
    procs, outs = spawn(2, 4, args + [f"--output.dir={tmp_path}/mp"])
    assert_ok(procs, outs)
    assert "  mesh: x=4 y=2 (8 devices)" in outs[0][0].splitlines()
    assert "transport: gloo (host-staged; tiles on the CPU)" in outs[0][0]
    path = str(tmp_path / "mp" / "snapshots.nc")
    assert read(path) == read(single(tmp_path, "single", 8, args))

    jcfg = jconfig.merged_config(BENCH, SIZE + [f"--precision={precision}", "--kernel=jnp",
                                                "--write_final=true",
                                                f"--output.dir={tmp_path}/jax"])
    jres = jdriver.run_simulation(jcfg, devices=jax.devices()[:1])
    atol = 1e-12 if precision == "f64" else 2e-5
    np.testing.assert_allclose(frames(path), frames(jres.output_path), rtol=0, atol=atol)


def test_four_ranks_run_and_restart_through_the_cli(tmp_path):
    """Four ranks through the CLI, one tile each (2x2, so the snapshot
    regions are x-fragmented), then a four-rank restart from the written
    file (``ic.mode=file``: each rank reads its own regions); each file is
    the single-process run's and restart's."""
    args = [f"--config={BENCH}", *SIZE, "--kernel=pallas"]
    procs, outs = spawn(4, "cli", args + [f"--output.dir={tmp_path}/mp"])
    assert_ok(procs, outs)
    path = str(tmp_path / "mp" / "snapshots.nc")
    assert read(path) == read(single(tmp_path, "single", 4, args))

    restart = args + ["--ic.mode=file", f"--ic.path={path}"]
    procs, outs = spawn(4, "cli", restart + [f"--output.dir={tmp_path}/mp_restart"])
    assert_ok(procs, outs)
    got = str(tmp_path / "mp_restart" / "snapshots.nc")
    assert read(got) == read(single(tmp_path, "single_restart", 4, restart))
    np.testing.assert_array_equal(frames(got)[0], frames(path)[-1])


@pytest.mark.parametrize("case, nproc, tiles, args", [
    # 33x33 periodic on 2x2 ranks: the carrier (36x36) stages its x and y
    # wrap-heads from tile 0 to the edge tile, another rank's, K5 plain.
    ("carrier", 4, 1, ["--nx=33", "--ny=33", "--bc=periodic", *PHYS, "--kernel=pallas"]),
    # The same grid without a kernel: the per-step path on remainder tiles.
    ("remainder", 4, 1, ["--nx=33", "--ny=33", "--bc=periodic", *PHYS, "--kernel=jnp"]),
    # One-sided periodic on both axes, halo_overlap on 2 ranks: K3 plain.
    ("overlap", 2, 1, ["--nx=128", "--ny=64", *PHYS, "--bc.left=periodic",
                       "--bc.right=dirichlet", "--bc.bottom=periodic", "--bc.top=neumann",
                       "--kernel=pallas", "--halo_overlap=true", "--steps=19",
                       "--out_every=19", "--write_final=true"]),
    # max_devices cuts the global list (rank 0's two tiles, rank 1's
    # two): a 3x1 mesh of which rank 1 owns one tile, and a 2x1 mesh of
    # which it owns none (it still takes part in every reduction).
    ("uneven", 2, 2, [f"--config={BENCH}", "--nx=96", "--ny=64", "--kernel=pallas",
                      "--max_devices=3"]),
    ("idle rank", 2, 2, [f"--config={BENCH}", "--nx=96", "--ny=64", "--kernel=pallas",
                         "--max_devices=2", "--diagnostics_every=1"]),
    # The runs chip_smoke.py makes over NCCL on four cards, at this size:
    # the overlap path (K3 plain) and the per-step path with torch ops, one
    # rank a tile; K2's remainder tiles are the test below.
    ("overlap 4 ranks", 4, 1, [f"--config={BENCH}", "--nx=128", "--ny=64", "--kernel=pallas",
                               "--halo_overlap=true", "--write_final=true"]),
    ("per-step 4 ranks", 4, 1, [f"--config={BENCH}", "--nx=128", "--ny=64", "--kernel=jnp",
                                "--write_final=true"]),
], ids=["carrier", "remainder", "overlap", "uneven", "idle rank", "overlap 4 ranks",
        "per-step 4 ranks"])
def test_paths_across_ranks_match_single_process(tmp_path, case, nproc, tiles, args):
    args = ["--steps=8", "--out_every=4", *args]
    procs, outs = spawn(nproc, tiles, args + [f"--output.dir={tmp_path}/mp"])
    assert_ok(procs, outs)
    path = {"carrier": "carrier, K5 plain version", "overlap": "overlap, K3 plain version",
            "remainder": "remainder per-step, torch ops per step",
            "uneven": "slab, K4 plain version", "idle rank": "slab, K4 plain version",
            "overlap 4 ranks": "overlap, K3 plain version",
            "per-step 4 ranks": "per-step, torch ops per step"}[case]
    assert f"path: {path}" in outs[0][0]
    got = str(tmp_path / "mp" / "snapshots.nc")
    assert read(got) == read(single(tmp_path, "single", nproc * tiles, args))


def test_kill_mid_run_then_restart_reproduces_the_uninterrupted_run(tmp_path):
    """The JAX package's drill (tests/test_multihost.py, four processes):
    four ranks are hard-killed right after record 2 (step 8) is synced; the
    file holds exactly the 3 records written, and a four-rank restart from
    its last record reproduces the uninterrupted run's remaining records
    bit for bit (the same cadence, so the same pass grouping; the records
    are f64 of the f32 field, so the round trip is exact)."""
    args = ["--nx=128", "--ny=64", "--steps=16", "--out_every=4", "--kernel=jnp"]
    deadline = time.monotonic() + 120
    procs, outs = start(4, 1, args + [f"--output.dir={tmp_path}/killed"],
                        env={"MP_KILL_AFTER_RECORD": "2"}, timeout=60)
    for i, (p, (out, err)) in enumerate(zip(procs, outs)):
        assert p.returncode == 137, f"rank {i} exit {p.returncode}:\n{out[-2000:]}\n{err[-2000:]}"
        assert "MP_KILLED_AT 2" in out and "MP_OK" not in out
    killed = str(tmp_path / "killed" / "snapshots.nc")
    with NetCDFFile(killed) as ds:
        assert ds.dimensions["time"] == 3
    whole = frames(single(tmp_path, "uninterrupted", 4, args))
    assert whole.shape[0] == 4
    np.testing.assert_array_equal(frames(killed), whole[:3])

    resume = [*args, "--steps=8", "--ic.mode=file", f"--ic.path={killed}"]
    # spawn may try twice: each attempt gets half of what is left
    procs, outs = spawn(4, 1, resume + [f"--output.dir={tmp_path}/resumed"],
                        timeout=max(1.0, (deadline - time.monotonic()) / 2))
    assert_ok(procs, outs)
    resumed = frames(str(tmp_path / "resumed" / "snapshots.nc"))
    assert resumed.shape[0] == 2  # steps 8 and 12 of the whole run
    np.testing.assert_array_equal(resumed, whole[2:])


def test_remainder_tiles_with_k2_across_ranks_match_single_process_and_jax(tmp_path):
    """The per-step path on the reference's remainder tiles with the kernel
    named (K2's plain version) across four ranks: a 2x2 mesh over a grid
    the carrier cannot stage (three torus rows on two tiles), so the
    driver takes it with its warning.  The file is the single-process
    run's byte for byte, and within the f32 tolerance of JAX's run."""
    size = ["--nx=64", "--ny=3", "--bc=periodic", *PHYS, "--steps=8", "--out_every=4",
            "--write_final=true"]
    args = [*size, "--kernel=pallas", "--mesh.x=2", "--mesh.y=2"]
    cfg = tconfig.merged_config(None, args)
    assert thalo.build_carrier_slab_advance(cfg, tmesh.make_mesh(2, 2, ["cpu"] * 4), cfg.dt) is None
    procs, outs = spawn(4, 1, args + [f"--output.dir={tmp_path}/mp"], timeout=60)
    assert_ok(procs, outs)
    assert "path: remainder per-step, K2 plain version" in outs[0][0]
    assert "fits no carrier layout" in outs[0][1]
    got = str(tmp_path / "mp" / "snapshots.nc")
    assert read(got) == read(single(tmp_path, "single", 4, args))

    jcfg = jconfig.merged_config(None, [*size, "--kernel=jnp", f"--output.dir={tmp_path}/jax"])
    jres = jdriver.run_simulation(jcfg, devices=jax.devices()[:1])
    np.testing.assert_allclose(frames(got), frames(jres.output_path), rtol=0, atol=2e-5)


def test_auto_reads_the_torchrun_environment(tmp_path):
    """``--distributed=auto`` joins the group from ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT``, as torchrun sets
    them."""
    args = [f"--config={BENCH}", *SIZE, "--kernel=pallas"]
    procs, outs = spawn(2, "cli", args + [f"--output.dir={tmp_path}/mp"], env={"MP_AUTO": "1"})
    assert_ok(procs, outs)
    assert "  ranks: 2  transport: gloo" in outs[0][0]
    assert read(str(tmp_path / "mp" / "snapshots.nc")) == read(single(tmp_path, "single", 2, args))


def test_the_guard_refuses_a_global_field(tmp_path):
    """The workers' guard is live: after a run that passed under it, each
    guarded function, and an all-gather of more than 16 elements, raises
    on every rank (a file IC read whole is among them: the restart test
    passes because the driver reads by region)."""
    procs, outs = spawn(2, 1, [*SIZE, "--output.enable=false"], env={"MP_PROBE_GUARD": "1"})
    assert_ok(procs, outs)
    for _, err in outs:
        assert [ln.split()[1] for ln in err.splitlines() if ln.startswith("GUARD ")] == [
            "gather_field", "apply_initial_condition", "load_field", "fetch_global",
            "all_gather", "all_gather_object"]


def test_controller_death_before_the_open_barrier_fails_the_peer(tmp_path):
    """The controller fails to create the snapshot file (simulated disk
    full) before the open barrier: the peer errors out within the bounded
    barrier (``CLIMATE_SIM_SYNC_TIMEOUT_S``), and no file is left."""
    out = tmp_path / "mp"
    t0 = time.time()
    procs, outs = spawn(2, "cli", [*SIZE, f"--output.dir={out}"],
                        env={"MP_KILL_CONTROLLER": "1", "CLIMATE_SIM_SYNC_TIMEOUT_S": "20"},
                        timeout=120)
    elapsed = time.time() - t0
    assert procs[0].returncode == 1
    assert "No space left on device (simulated)" in outs[0][1]
    assert procs[1].returncode == 1
    assert "snapshot_open" in outs[1][1]
    assert "MP_OK" not in outs[0][0] + outs[1][0]
    assert not os.path.exists(out / "snapshots.nc")
    assert elapsed < 2 * 60


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the ranks share cuda:0")
    return torch.device("cuda", 0)


@pytest.mark.gpu
def test_two_ranks_sharing_a_card_match_single_process(tmp_path, cuda_device):
    """Two ranks on cuda:0 (gloo, host-staged) against the single-process
    2x2 mesh of the same card."""
    args = [f"--config={BENCH}", "--nx=512", "--ny=512", "--steps=40", "--out_every=20",
            "--kernel=pallas", "--mesh.x=2", "--mesh.y=2"]
    code = WORKER.replace('["cpu"] * tiles', '["cuda:0"] * tiles')
    port = str(free_port())
    procs = [subprocess.Popen([sys.executable, "-c", code, str(i), port, "2", "2", *args,
                               f"--output.dir={tmp_path}/mp"], cwd=REPO,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for i in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert_ok(procs, outs)
    assert "transport: gloo (host-staged; ranks share a card)" in outs[0][0]
    args = args + [f"--output.dir={tmp_path}/single"]
    cfg = tconfig.merged_config(tconfig.extract_config_path(args), args)
    tdriver.run_simulation(cfg, ["cuda:0"] * 4)
    assert read(str(tmp_path / "mp" / "snapshots.nc")) == read(cfg.resolved_output_path())


# ------------------------------------------------------------- in-process


def rank_mesh(px, py, nproc, rank):
    """A px x py CPU mesh whose tiles are spread over ``nproc`` ranks in
    row-major runs, seen from ``rank``."""
    n = px * py
    owners = [i * nproc // n for i in range(n)]
    return tmesh.make_mesh(px, py, ["cpu"] * n, owners, rank, ["cpu"] * n)


def test_mesh_ownership_and_local_windows():
    m = rank_mesh(2, 2, 2, 1)
    assert [m.owner(y, x) for y in range(2) for x in range(2)] == [0, 0, 1, 1]
    assert m.local_tiles() == [(1, 0), (1, 1)] and m.is_local(1, 0) and not m.is_local(0, 1)
    assert m.distinct_devices() == [torch.device("cpu")] and m.chip_count() == 1
    assert tmesh.local_windows(m, 33, 31) == {(1, 0): (16, 33, 0, 15), (1, 1): (16, 33, 15, 31)}
    four_cards = tmesh.make_mesh(2, 2, ["cpu"] * 4, [0, 1, 2, 3], 2, ["a", "b", "c", "d"])
    assert four_cards.chip_count() == 4 and four_cards.local_tiles() == [(1, 0)]
    shared = tmesh.make_mesh(2, 2, ["cpu"] * 4, [0, 1, 2, 3], 2, ["a"] * 4)
    assert shared.chip_count() == 1


@pytest.mark.parametrize("preset, precision", [
    ("gaussian_hotspot", "f32"), ("gaussian_hotspot", "f64"), ("gaussian_hotspot", "bf16"),
    ("constant_zero", "f32"), ("file", "f64"),
])
@pytest.mark.parametrize("grid", [(128, 64), (33, 31)])
def test_device_ic_tiles_are_slices_of_the_global_ic(tmp_path, preset, precision, grid):
    nx, ny = grid
    args = [f"--nx={nx}", f"--ny={ny}", f"--precision={precision}"]
    if preset == "file":
        path = str(tmp_path / "ic.nc")
        cfg = tconfig.merged_config(None, args)
        with SnapshotWriter(path, cfg, use_native=False) as w:
            for seed in (1, 2):
                w.write(np.random.default_rng(seed).random((ny, nx)))
        args += ["--ic.mode=file", f"--ic.path={path}"]
    else:
        args.append(f"--ic.preset={preset}")
    cfg = tconfig.merged_config(None, args)
    dtype = DTYPES[precision]
    whole = apply_initial_condition(cfg, dtype)
    for rank in range(2):
        m = rank_mesh(2, 2, 2, rank)
        tiles = device_initial_condition(cfg, dtype, m)
        wins = tmesh.local_windows(m, ny, nx)
        for y in range(2):
            for x in range(2):
                if (y, x) not in wins:
                    assert tiles[y][x] is None
                    continue
                y0, y1, x0, x1 = wins[(y, x)]
                t = tiles[y][x]
                assert t.dtype == dtype and t.is_contiguous()
                assert torch.equal(t, whole[y0:y1, x0:x1])
        # convert's rank-local form cuts the same tiles from a numpy field.
        _, conv = from_reference_local(tconfig.config_to_dict(cfg),
                                       whole.to(torch.float64).numpy(), m)
        for row_c, row_t in zip(conv, tiles):
            for c, t in zip(row_c, row_t):
                assert (c is None and t is None) or torch.equal(c, t)


def test_bad_ic_file_raises_like_the_global_reader(tmp_path):
    cfg = tconfig.merged_config(None, ["--nx=16", "--ny=8", "--ic.mode=file",
                                       f"--ic.path={tmp_path}/none.nc"])
    m = rank_mesh(2, 2, 2, 0)
    with pytest.raises(FileNotFoundError):
        device_initial_condition(cfg, torch.float64, m)
    path = str(tmp_path / "small.nc")
    with SnapshotWriter(path, tconfig.merged_config(None, ["--nx=8", "--ny=8"]),
                        use_native=False) as w:
        w.write(np.zeros((8, 8)))
    cfg = tconfig.merged_config(None, ["--nx=16", "--ny=8", "--ic.mode=file",
                                       f"--ic.path={path}"])
    with pytest.raises(ValueError) as te:
        device_initial_condition(cfg, torch.float64, m)
    with pytest.raises(ValueError) as ge:
        apply_initial_condition(cfg, torch.float64)
    assert str(te.value) == str(ge.value)


@pytest.mark.parametrize("nx, ny, bc", [(33, 33, "periodic"), (509, 72, "dirichlet")])
def test_carrier_embed_per_rank_equals_embed_of_the_global_field(nx, ny, bc):
    cfg = tconfig.merged_config(None, [f"--nx={nx}", f"--ny={ny}", f"--bc={bc}", *PHYS,
                                       "--kernel=pallas", "--precision=f64"])
    u = torch.from_numpy(np.random.default_rng(0).random((ny, nx)))
    whole = thalo.build_carrier_slab_advance(cfg, tmesh.make_mesh(2, 2, ["cpu"] * 4), cfg.dt)
    want = whole.embed(u)
    for rank in range(4):
        m = rank_mesh(2, 2, 4, rank)
        adv = thalo.build_carrier_slab_advance(cfg, m, cfg.dt)
        got = adv.embed_from(lambda w, dev: u[w[0]:w[1], w[2]:w[3]], u.dtype)
        ic = device_initial_condition(cfg, torch.float64, m, adv.embed_from)
        preset = whole.embed(apply_initial_condition(cfg, torch.float64))
        for y in range(2):
            for x in range(2):
                if m.is_local(y, x):
                    assert torch.equal(got[y][x], want[y][x])
                    assert torch.equal(ic[y][x], preset[y][x])
                else:
                    assert got[y][x] is None and ic[y][x] is None
        ext = adv.extract(got)
        assert sum(t is not None for row in ext for t in row) == len(adv.windows)


@pytest.mark.parametrize("spec", ["true", "auto,1", "127.0.0.1:5,2", "a:1,2,3,4",
                                  "127.0.0.1:5,two,0", "127.0.0.1:5,2,first", "host:1,,0"])
def test_spec_errors_match_jax(spec):
    """JAX parses the spec before it initializes, so its errors can be
    compared in this process."""
    with pytest.raises(ValueError) as je:
        jdriver.maybe_init_distributed(jconfig.merged_config(None, [f"--distributed={spec}"]))
    with pytest.raises(ValueError) as te:
        tdist.maybe_init_distributed(tconfig.merged_config(None, [f"--distributed={spec}"]))
    assert str(te.value) == str(je.value)
    assert not tdist.initialized()


def test_a_second_spec_raises_like_jax(monkeypatch):
    monkeypatch.setattr(jdriver, "_distributed_spec", "h:1,2,0")
    monkeypatch.setattr(tdist, "_spec", "h:1,2,0")
    args = ["--distributed=h:1,2,1"]
    with pytest.raises(RuntimeError) as je:
        jdriver.maybe_init_distributed(jconfig.merged_config(None, args))
    with pytest.raises(RuntimeError) as te:
        tdist.maybe_init_distributed(tconfig.merged_config(None, args))
    assert str(te.value) == str(je.value)
    # The same spec again is a no-op in both.
    jdriver.maybe_init_distributed(jconfig.merged_config(None, ["--distributed=h:1,2,0"]))
    tdist.maybe_init_distributed(tconfig.merged_config(None, ["--distributed=h:1,2,0"]))


def test_one_process_helpers():
    """Outside a process group: rank 0 of 1, the controller; reductions
    and barriers are local; fetch_global assembles the tile grid."""
    assert (tdist.rank(), tdist.world_size(), tdist.is_controller()) == (0, 1, True)
    tdist.bounded_sync("noop")
    np.testing.assert_array_equal(tdist.reduce([1.0, 2.0], "max"), [1.0, 2.0])
    tdist.raise_together(None, "nothing")
    with pytest.raises(KeyError):
        tdist.raise_together(KeyError("mine"), "mine")
    u = torch.from_numpy(np.random.default_rng(1).random((12, 10)))
    m = tmesh.make_mesh(2, 3, ["cpu"] * 6)
    np.testing.assert_array_equal(tdist.fetch_global(tmesh.shard_field(u, m)), u.numpy())
    assert tdist.global_devices([torch.device("cpu")] * 2) == [(0, "cpu", "cpu")] * 2
