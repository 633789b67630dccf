"""The port's sharded path against the JAX package's, on the CPU.

The port runs a mesh of tiles over ``[cpu] * n`` in one process; JAX runs
``shard_map`` over ``jax.devices()[:n]`` (the 8 virtual CPU devices of
tests/conftest.py), its Pallas kernels in interpret mode.  Both start from
one numpy field made from a seed.  Tolerances: f64 ``atol 1e-12`` for
advances and runs (the two packages sum in different orders), bf16 within
``8e-3`` of the f64 oracle (tests/test_torch_kernel.py's bound).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.ops.step import make_interior_step as jmake_interior_step
from climate_sim_tpu.parallel import halo as jhalo
from climate_sim_tpu.parallel import mesh as jmesh
from climate_sim_tpu.runtime.driver import run_simulation as jrun

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.convert import from_reference_sharded
from climate_sim_tpu_torch.io.netcdf import NetCDFFile as TNetCDFFile
from climate_sim_tpu_torch.ops import cuda_sharded as tsh
from climate_sim_tpu_torch.ops.cuda_stencil import pick_steps_per_pass
from climate_sim_tpu_torch.ops.step import make_interior_step, reference_step
from climate_sim_tpu_torch.parallel import halo as thalo
from climate_sim_tpu_torch.parallel import mesh as tmesh
from climate_sim_tpu_torch.runtime import driver as tdriver

from test_torch_kernel import make_cfgs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, "configs", "dev.yaml")
BENCH = os.path.join(REPO, "configs", "bench_4096.yaml")

MESHES = [(1, 1), (2, 2), (1, 4), (4, 1)]  # (px, py)
# The BC classes of the sharded-path checks (tests/test_torch_kernel.py's
# names): D4, P4, the bench mix, one-sided x, one-sided y, both axes
# one-sided, compat.
ADVANCE_CLASSES = ["D4", "P4", "MIX1", "one_sided_x", "one_sided_y", "both_axes", "compat"]


def grid_for(px, py, mx=96, my=64):
    return mx * px, my * py


def both_meshes(px, py):
    return (jmesh.make_mesh(px, py, jax.devices()[: px * py]),
            tmesh.make_mesh(px, py, ["cpu"] * (px * py)))


def field(ny, nx, seed=0):
    return np.random.default_rng(seed).random((ny, nx))


# ----------------------------------------------------------- mesh copies


@pytest.mark.parametrize("size", [1, 2, 3, 4, 6, 7, 8, 12, 16, 64, 97])
def test_dims_create_matches_original(size):
    assert tmesh.dims_create(size) == jmesh.dims_create(size)


@pytest.mark.parametrize("req", [(None, None), (2, None), (None, 2), (4, 2),
                                 (3, None), (None, 3), (3, 3), (1, 8)])
def test_choose_mesh_shape_matches_original(req):
    for n in (1, 2, 4, 6, 8):
        for nx, ny in ((64, 64), (96, 64), (30, 20), (17, 64), (64, 17)):
            try:
                want = jmesh.choose_mesh_shape(n, nx, ny, *req)
            except ValueError as e:
                with pytest.raises(ValueError, match=str(e)):
                    tmesh.choose_mesh_shape(n, nx, ny, *req)
                continue
            assert tmesh.choose_mesh_shape(n, nx, ny, *req) == want


def test_mesh_repeats_devices_and_flags_the_edges():
    m = tmesh.make_mesh(2, 2, ["cpu"] * 4)
    assert m.shape == {"x": 2, "y": 2} and m.size == 4
    assert m.distinct_devices() == [torch.device("cpu")]
    assert [m.edge_flags(y, x) for y in range(2) for x in range(2)] == [
        (1, 0, 1, 0), (0, 1, 1, 0), (1, 0, 0, 1), (0, 1, 0, 1)]
    assert tmesh.make_mesh(1, 4, ["cpu"] * 4).edge_flags(1, 0) == (1, 1, 0, 0)
    with pytest.raises(ValueError, match="need 4 devices"):
        tmesh.make_mesh(2, 2, ["cpu"] * 3)
    assert tmesh.divisible(m, 64, 32) and not tmesh.divisible(m, 63, 32)


@pytest.mark.parametrize("px, py", MESHES)
def test_from_reference_sharded_round_trips_a_jax_sharded_field(px, py):
    """The JAX sharded field (np.asarray of a sharded jax.Array) becomes the
    port's tile grid, each tile its shard, and gathers back exactly."""
    nx, ny = grid_for(px, py, 16, 8)
    jcfg = jconfig.SimConfig(nx=nx, ny=ny, precision="f64")
    jm, tm = both_meshes(px, py)
    u = jax.device_put(jnp.asarray(field(ny, nx)), jmesh.field_sharding(jm))
    cfg, tiles = from_reference_sharded(jconfig.config_to_dict(jcfg), np.asarray(u), tm)
    assert (cfg.nx, cfg.ny) == (nx, ny)
    for shard in u.addressable_shards:
        ys, xs = shard.index
        y, x = (ys.start or 0) // (ny // py), (xs.start or 0) // (nx // px)
        np.testing.assert_array_equal(tiles[y][x].numpy(), np.asarray(shard.data))
        assert tiles[y][x].is_contiguous()
    np.testing.assert_array_equal(tmesh.gather_field(tiles, tm).numpy(), np.asarray(u))
    # An indivisible field splits into the reference's remainder tiles
    # (decomp.cpp:29-30) and gathers back exactly.
    v = torch.from_numpy(field(ny + (py > 1), nx + (px > 1)))
    rem = tmesh.shard_field(v, tm)
    assert rem[-1][-1].shape == (ny // py + (py > 1), nx // px + (px > 1))
    torch.testing.assert_close(tmesh.gather_field(rem, tm), v, rtol=0, atol=0)


# --------------------------------------------------------------- exchange


def rank_tiles(mesh, my, mx):
    px = mesh.shape["x"]
    return [[torch.full((my, mx), float(y * px + x), dtype=torch.float64)
             for x in range(px)] for y in range(mesh.shape["y"])]


def test_halo_exchange_rank_id_faces():
    """Each tile holds its linear id; after the width-1 exchange each ghost
    face holds the neighbour's id (tests/test_parallel.py:159, and the
    reference's test_halo.cpp:8-63)."""
    cfg = tconfig.SimConfig(nx=16, ny=8)
    cfg.bc = tconfig.BCConfig(*(tconfig.BCType.PERIODIC,) * 4)
    mesh = tmesh.make_mesh(4, 2, ["cpu"] * 8)
    tile = thalo.exchange_and_pad(rank_tiles(mesh, 4, 4), cfg, mesh)[0][1]
    assert torch.all(tile[1:-1, 1:-1] == 1.0)     # own rank id
    assert torch.all(tile[1:-1, 0] == 0.0)        # left neighbour rank 0
    assert torch.all(tile[1:-1, -1] == 2.0)       # right neighbour rank 2
    assert torch.all(tile[-1, 1:-1] == 5.0)       # up neighbour rank 5
    assert torch.all(tile[0, 1:-1] == 5.0)        # periodic wrap down -> rank 5


def test_exchange_halos_k_holds_neighbours_and_diagonal_corners():
    """k-wide halos hold the cyclic neighbours' ids, corners the diagonal
    neighbours' (x first, then y at the x-extended width).  py >= 3 so the
    up and wrap-down neighbours differ."""
    px, py, k, m = 2, 4, 3, 8
    mesh = tmesh.make_mesh(px, py, ["cpu"] * 8)
    padded = thalo.exchange_halos_k(rank_tiles(mesh, m, m), mesh, k)
    xhalo, yhalo = thalo.exchange_halos_slabs(rank_tiles(mesh, m, m), mesh, k)

    def rank(y, x):
        return float((y % py) * px + (x % px))

    for y in range(py):
        for x in range(px):
            p = padded[y][x]
            assert p.shape == (m + 2 * k, m + 2 * k)
            assert torch.all(p[k:-k, :k] == rank(y, x - 1))
            assert torch.all(p[k:-k, -k:] == rank(y, x + 1))
            assert torch.all(p[:k, k:-k] == rank(y - 1, x))
            assert torch.all(p[-k:, k:-k] == rank(y + 1, x))
            assert torch.all(p[:k, :k] == rank(y - 1, x - 1))
            assert torch.all(p[-k:, -k:] == rank(y + 1, x + 1))
            # the slabs are the same data, compact
            torch.testing.assert_close(
                tsh.slab_window(p[k:-k, k:-k], xhalo[y][x], yhalo[y][x], k), p)


def test_truncated_axes_deliver_zeros():
    """A non-wrapping axis sends nothing across its wrap edge: edge tiles
    get zeros there (never read as values: the BC or edge rule covers
    them); compat truncates both axes; a size-1 non-wrapping axis gets
    zeros, a size-1 wrapping axis its own data."""
    mesh = tmesh.make_mesh(2, 2, ["cpu"] * 4)
    tiles = rank_tiles(mesh, 4, 4)
    tiles = [[t + 1.0 for t in row] for row in tiles]
    p = thalo.exchange_halos_k(tiles, mesh, 2, wrap_x=False, wrap_y=True)
    assert torch.all(p[0][0][2:-2, :2] == 0.0) and torch.all(p[0][0][2:-2, -2:] == 2.0)
    assert torch.all(p[0][1][2:-2, -2:] == 0.0)
    assert torch.all(p[0][0][:2, 2:-2] == 3.0)        # y wraps: from tile (1, 0)
    solo = tmesh.make_mesh(1, 1, ["cpu"])
    t = [[torch.arange(16.0).reshape(4, 4)]]
    torch.testing.assert_close(thalo.exchange_halos_k(t, solo, 1, False, False)[0][0][1:-1, 0],
                               torch.zeros(4))
    torch.testing.assert_close(thalo.exchange_halos_k(t, solo, 1, True, True)[0][0][1:-1, 0],
                               t[0][0][:, -1])
    cfg = tconfig.SimConfig()
    cfg.bc = tconfig.BCConfig(*(tconfig.BCType.PERIODIC,) * 4)
    cfg.strict_reference_compat = True
    assert thalo.axis_wrap_flags(cfg) == (False, False)
    cfg.strict_reference_compat = False
    assert thalo.axis_wrap_flags(cfg) == (True, True)


@pytest.mark.parametrize("path", ["slab", "overlap", "perstep"])
@pytest.mark.parametrize("bc_class, wraps", [
    ("D4", set()), ("compat", set()), ("MIX2", {"x"}), ("one_sided_y", {"y"}),
    ("P4", {"x", "y"}),
])
def test_exchange_copies_carry_no_wrap_payload_on_nonperiodic_axes(path, bc_class, wraps):
    """The MPI_PROC_NULL skip (reference: src/halo.cpp:28-43,
    tests/test_parallel.py:378-445): ``mesh.copies`` counts a wrap payload
    on an axis only where that axis has a live-periodic side."""
    _, cfg = make_cfgs(256, 128, bc_class, kernel="pallas", out_every=8)
    mesh = tmesh.make_mesh(4, 2, ["cpu"] * 8)
    adv = {
        "slab": lambda: thalo.build_sharded_multistep_advance(cfg, mesh, 0.1),
        "overlap": lambda: thalo.build_sharded_overlap_advance(cfg, mesh, 0.1),
        "perstep": lambda: thalo.build_sharded_advance(
            cfg, mesh, 0.1, make_interior_step(cfg, 0.1)),
    }[path]()
    adv(2)(tmesh.shard_field(torch.from_numpy(field(128, 256)), mesh))
    passes = adv.pass_count(2)
    for axis in ("x", "y"):
        n = mesh.shape[axis]
        other = mesh.size // n
        # per pass and axis: two directions, n-1 inner pairs each, per row
        assert mesh.copies[(axis, False)] == passes * 2 * (n - 1) * other
        want_wrap = passes * 2 * other if axis in wraps else 0
        assert mesh.copies[(axis, True)] == want_wrap, (axis, mesh.copies)


# --------------------------------------------------------------- advances


def jax_advance(path, jcfg, jm):
    if path == "slab":
        return jhalo.build_sharded_multistep_advance(jcfg, jm, 0.1, interpret=True,
                                                     dtype_name="float64")
    if path == "overlap":
        return jhalo.build_sharded_overlap_advance(jcfg, jm, 0.1, interpret=True,
                                                   dtype_name="float64")
    return jhalo.build_sharded_advance(jcfg, jm, 0.1, jmake_interior_step(jcfg, 0.1))


def port_advance(path, tcfg, tm):
    if path == "slab":
        return thalo.build_sharded_multistep_advance(tcfg, tm, 0.1)
    if path == "overlap":
        return thalo.build_sharded_overlap_advance(tcfg, tm, 0.1)
    return thalo.build_sharded_advance(tcfg, tm, 0.1, make_interior_step(tcfg, 0.1))


@pytest.mark.parametrize("path", ["slab", "overlap", "perstep"])
@pytest.mark.parametrize("i, bc_class", list(enumerate(ADVANCE_CLASSES)))
def test_sharded_advance_matches_jax(path, i, bc_class):
    """Each port advance against its JAX counterpart on the same mesh shape
    (the meshes cycle over the classes): an 11-step and a 5-step chunk,
    each in passes of k = 2 (96x64 tiles) with a 1-step remainder."""
    px, py = MESHES[i % len(MESHES)]
    nx, ny = grid_for(px, py)
    jcfg, tcfg = make_cfgs(nx, ny, bc_class, kernel="pallas", out_every=8,
                           precision="f64")
    jm, tm = both_meshes(px, py)
    u = field(ny, nx, seed=i)
    jadv, tadv = jax_advance(path, jcfg, jm), port_advance(path, tcfg, tm)
    assert jadv is not None and tadv is not None
    ju = jax.device_put(jnp.asarray(u), jmesh.field_sharding(jm))
    _, tiles = from_reference_sharded(jconfig.config_to_dict(jcfg), u, tm)
    for chunk in (11, 5):
        ju = jadv(chunk)(ju)
        tiles = tadv(chunk)(tiles)
    np.testing.assert_allclose(tmesh.gather_field(tiles, tm).numpy(), np.asarray(ju),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("px, py", MESHES)
def test_port_advances_match_the_per_step_oracle_on_every_mesh(px, py):
    """All three advances, every class, on every mesh shape: 13 steps
    against the single-device per-step oracle, f64."""
    nx, ny = grid_for(px, py)
    u = torch.from_numpy(field(ny, nx, seed=px + 10 * py))
    for bc_class in ADVANCE_CLASSES:
        _, tcfg = make_cfgs(nx, ny, bc_class, kernel="pallas", out_every=8)
        want = u
        for _ in range(13):
            want = reference_step(want, tcfg, 0.1)
        tm = tmesh.make_mesh(px, py, ["cpu"] * (px * py))
        for path in ("slab", "overlap", "perstep"):
            adv = port_advance(path, tcfg, tm)
            got = tmesh.gather_field(adv(13)(tmesh.shard_field(u, tm)), tm)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-12,
                                       msg=f"{bc_class} {path}")


@pytest.mark.parametrize("path", ["slab", "overlap"])
def test_bf16_advance_within_bound_of_oracle(path):
    """bf16 storage on a 2x2 mesh: one rounding per pass (6 passes of k = 2
    for 11 steps), within 8e-3 of the f64 oracle."""
    nx, ny = grid_for(2, 2)
    _, tcfg = make_cfgs(nx, ny, "one_sided_y", kernel="pallas", out_every=8)
    tm = tmesh.make_mesh(2, 2, ["cpu"] * 4)
    u = torch.from_numpy(field(ny, nx, seed=3))
    ub = u.to(torch.bfloat16)
    want = ub.to(torch.float64)
    for _ in range(11):
        want = reference_step(want, tcfg, 0.1)
    adv = port_advance(path, tcfg, tm)
    assert adv.pass_count(11) == 6
    got = tmesh.gather_field(adv(11)(tmesh.shard_field(ub, tm)), tm)
    assert got.dtype == torch.bfloat16
    assert float((got.to(torch.float64) - want).abs().max()) < 8e-3


def test_overlap_declines_tiles_without_interior_and_indivisible_grids():
    _, cfg = make_cfgs(32, 32, "D4", out_every=8)   # 16x16 tiles: k = 1
    tm = tmesh.make_mesh(2, 2, ["cpu"] * 4)
    assert thalo.build_sharded_overlap_advance(cfg, tm, 0.1) is not None
    _, cfg = make_cfgs(4, 64, "D4", out_every=8)    # 2-wide tiles
    assert thalo.build_sharded_overlap_advance(cfg, tm, 0.1) is None
    _, cfg = make_cfgs(33, 32, "D4", out_every=8)
    assert thalo.build_sharded_multistep_advance(cfg, tm, 0.1) is None
    assert thalo.build_sharded_overlap_advance(cfg, tm, 0.1) is None


# ----------------------------------------------------------------- driver


def read_back(path):
    with TNetCDFFile(path) as ds:
        attrs = {k: ds.getncattr(k) for k in ds.ncattrs()}
        return dict(ds.dimensions), attrs, np.asarray(ds.variables["u"][:, :, :])


DRIVER_CASES = {
    # name: (yaml, overrides, (px, py), port kernel)
    "bench_2x2_slab": (BENCH, ["--nx=192", "--ny=128", "--steps=23", "--out_every=10",
                               "--write_final=true"], (2, 2), "pallas"),
    "bench_2x2_overlap": (BENCH, ["--nx=192", "--ny=128", "--steps=23", "--out_every=10",
                                  "--halo_overlap=true"], (2, 2), "pallas"),
    "dev_1x4": (DEV, ["--nx=96", "--ny=256", "--steps=20", "--out_every=10"], (1, 4), "pallas"),
    "dev_4x1": (DEV, ["--nx=384", "--ny=64", "--steps=20", "--out_every=10"], (4, 1), "pallas"),
    "dev_2x2_perstep": (DEV, ["--nx=64", "--ny=64", "--steps=12", "--out_every=5"], (2, 2), "jnp"),
    "compat_2x2": (DEV, ["--nx=64", "--ny=64", "--steps=9", "--out_every=4",
                         "--strict_reference_compat=true"], (2, 2), "pallas"),
}


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_run_simulation_on_a_mesh_matches_jax(tmp_path, capsys, case):
    yaml_path, extra, (px, py), kernel = DRIVER_CASES[case]
    n = px * py
    args = extra + ["--precision=f64", f"--mesh.x={px}"]
    jcfg = jconfig.merged_config(yaml_path, args + ["--kernel=jnp", f"--output.dir={tmp_path}/j"])
    jres = jrun(jcfg, devices=jax.devices()[:n])
    jout = capsys.readouterr().out
    tcfg = tconfig.merged_config(yaml_path, args + [f"--kernel={kernel}",
                                                    f"--output.dir={tmp_path}/t"])
    tres = tdriver.run_simulation(tcfg, ["cpu"] * n)
    tout = capsys.readouterr().out

    jmesh_lines = [ln for ln in jout.splitlines() if "mesh:" in ln]
    tmesh_lines = [ln for ln in tout.splitlines() if "mesh:" in ln]
    assert tmesh_lines == jmesh_lines and len(tmesh_lines) == 1
    assert tres.mesh_shape == jres.mesh_shape == (py, px)
    assert tres.snapshots_written == jres.snapshots_written
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-12)
    jd, ja, jf = read_back(jres.output_path)
    td, ta, tf = read_back(tres.output_path)
    assert td == jd and ta == ja
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-12)

    # Passes per tile: the sharded k is fixed once from the tile and
    # out_every; spans split at snapshots, each span in passes of k.
    spans = tdriver.span_lengths(tcfg)
    if kernel == "jnp":
        want = sum(spans)
    else:
        tile = dataclasses.replace(tcfg, nx=tcfg.nx // px, ny=tcfg.ny // py)
        k = pick_steps_per_pass(tile, tcfg.out_every)
        want = sum(-(-s // k) for s in spans)
    assert f"passes: timed={want} warmup=1" in tout
    assert tres.timed_passes == want


def test_indivisible_grid_on_a_mesh_raises():
    """On a mesh, an indivisible grid raises only for a malformed
    multi-process request, with the JAX package's error (``true`` is no
    spec in JAX either); tests/test_torch_multiprocess.py runs the
    carrier across ranks."""
    from climate_sim_tpu.runtime.driver import maybe_init_distributed

    # No factor pair of 4 divides 33x33, so the mesh is the near-square 2x2.
    args = ["--nx=33", "--ny=33", "--kernel=pallas", "--distributed=true"]
    with pytest.raises(ValueError) as je:
        maybe_init_distributed(jconfig.merged_config(None, args))
    with pytest.raises(ValueError) as te:
        tdriver.run_simulation(tconfig.merged_config(None, args), ["cpu"] * 4,
                               write_output=False)
    assert str(te.value) == str(je.value)


def test_indivisible_grid_on_a_mesh_runs_the_carrier(capsys):
    """The same grid without ``distributed`` runs the carrier path (K5's
    plain version) and matches the JAX package's run on a 2x2 mesh
    (tests/test_torch_carrier.py covers the routes)."""
    args = ["--nx=33", "--ny=33", "--steps=5", "--precision=f64"]
    res = tdriver.run_simulation(tconfig.merged_config(None, args + ["--kernel=pallas"]),
                                 ["cpu"] * 4, write_output=False)
    assert "CARRIER path (34x34 carrier" in capsys.readouterr().out
    assert res.mesh_shape == (2, 2) and res.u.shape == (33, 33)
    jres = jrun(jconfig.merged_config(None, args + ["--kernel=jnp"]),
                devices=jax.devices()[:4], write_output=False)
    np.testing.assert_allclose(res.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-12)


def test_mesh_run_reports_per_distinct_device_throughput(capsys):
    cfg = tconfig.merged_config(None, ["--nx=64", "--ny=64", "--steps=4",
                                       "--out_every=4", "--kernel=pallas"])
    tdriver.run_simulation(cfg, ["cpu"] * 4, write_output=False)
    out = capsys.readouterr().out
    assert "path: slab, K4 plain version" in out
    line = next(ln for ln in out.splitlines() if ln.startswith("throughput:"))
    total, per_chip = (float(w) for w in line.replace(",", "").split()[1::3][:2])
    assert total == per_chip   # one distinct device
