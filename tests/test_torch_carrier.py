"""The port's paths for grids a mesh does not divide, against the JAX
package, on the CPU.

* K5's plain version (``carrier_pass_plain``, which the wrapper takes on a
  CPU tensor) against the JAX ``carrier_tile_slab_multistep`` in Pallas
  interpret mode, compared on the true extent of each tile: the pad evolves
  differently in the two (the JAX kernel's lane rolls wrap circularly).
* The carrier advance (``build_carrier_slab_advance``) and the remainder-tile
  per-step advance (``build_padded_advance``) on meshes of ``[cpu] * n``
  against the JAX oracle ``reference_step``.
* ``run_simulation`` of both packages on indivisible grids.

Inputs are made with numpy from a seed.  Tolerances: kernel f64 ``atol
1e-13`` and f32 ``2e-5`` per pass (tests/test_torch_sharded_kernels.py);
advances and runs f64 ``atol 1e-12`` (the packages sum in different
orders); bf16 storage within ``8e-3`` of the f32 run.  K5's CUDA kernel is
compared with its plain version on the card (``chip_smoke.py`` and the
``gpu``-marked test below).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.ops import pallas_stencil as jps
from climate_sim_tpu.ops.step import reference_step as jreference_step
from climate_sim_tpu.parallel import halo as jhalo
from climate_sim_tpu.runtime.driver import run_simulation as jrun

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.convert import from_reference, from_reference_sharded
from climate_sim_tpu_torch.io.netcdf import NetCDFFile as TNetCDFFile
from climate_sim_tpu_torch.ops import cuda_sharded as tsh
from climate_sim_tpu_torch.parallel import halo as thalo
from climate_sim_tpu_torch.parallel import mesh as tmesh
from climate_sim_tpu_torch.runtime import driver as tdriver

from test_torch_kernel import BC_CLASSES, make_cfgs
from test_torch_sharded_kernels import jax_slabs, port_slabs, window

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DEV = os.path.join(REPO, "configs", "dev.yaml")

D, N, P = "dirichlet", "neumann", "periodic"
# Every orientation of a one-sided periodic axis, and both axes at once.
ONE_SIDED = {
    "low_y": (D, N, P, D),    # the reference's dev.yaml mix
    "high_y": (N, D, D, P),
    "low_x": (P, N, D, D),
    "high_x": (D, P, N, D),
    "low_x_high_y": (P, D, D, P),
    "high_x_low_y": (D, P, P, N),
}


def cfgs(nx, ny, bcs, compat=False, **kw):
    """(JAX config, port config) with these (left, right, bottom, top)."""
    kw = {"out_every": 8, "kernel": "pallas", **kw}
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.SimConfig(nx=nx, ny=ny, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                            precision="f64", **kw)
        cfg.bc = mod.BCConfig(*(mod.bc_from_string(b) for b in bcs))
        cfg.strict_reference_compat = compat
        out.append(cfg)
    return out


def field(ny, nx, seed=0):
    return np.random.default_rng(seed).random((ny, nx))


def jax_oracle(u, jcfg, steps):
    v = jnp.asarray(u)
    for _ in range(steps):
        v = jreference_step(v, jcfg, jcfg.dt)
    return np.asarray(v)


def cpu_mesh(px, py):
    return tmesh.make_mesh(px, py, ["cpu"] * (px * py))


def run_carrier(tcfg, px, py, u, chunks):
    """The carrier advance over ``chunks`` from the global field ``u``;
    returns (global field, advance, mesh)."""
    m = cpu_mesh(px, py)
    adv = thalo.build_carrier_slab_advance(tcfg, m, tcfg.dt)
    assert adv is not None, "the carrier declined"
    c = adv.embed(torch.from_numpy(u))
    assert [[tuple(t.shape) for t in row] for row in c] == [
        [(adv.carrier_shape[0] // py, adv.carrier_shape[1] // px)] * px] * py
    for chunk in chunks:
        c = adv(chunk)(c)
    return tmesh.gather_field(adv.extract(c)).numpy(), adv, m


# ------------------------------------------------------------------- K5


def carrier_flag_sets():
    """Edge flags of the tiles of 2x2, 1x4 and 4x1 carrier meshes (edge
    tile last), and of a trailing all-pad tile."""
    out = []
    for px, py in ((2, 2), (1, 4), (4, 1)):
        m = cpu_mesh(px, py)
        for y in range(py):
            for x in range(px):
                if m.edge_flags(y, x) not in out:
                    out.append(m.edge_flags(y, x))
    return out + [(0, 0, 0, 0)]


K5_FLAGS = carrier_flag_sets()
K5_EXTENTS = [(64, 128), (45, 100), (8, 8)]


def k5_cases(w, jcfg, tcfg, k, atol):
    """K5's plain version against the JAX kernel over every flag set and
    true extent (runtime data: one JAX compile), on the true extent."""
    my, mx = w.shape[0] - 16, w.shape[1] - 16
    jt, jx, jy = (jnp.asarray(a) for a in jax_slabs(w, 8))
    tt, tx, ty = port_slabs(w, 8)
    for ly, lx in K5_EXTENTS:
        for flags in K5_FLAGS:
            f6 = (*flags, ly, lx)
            want = np.asarray(jps.carrier_tile_slab_multistep(
                jt, jx, jy, jnp.asarray(f6, jnp.int32), jcfg, 0.1, k,
                interpret=True, khalo=8,
            ))
            got = tsh.carrier_tile_slab_multistep(tt, tx, ty, f6, tcfg, 0.1, k, khalo=8)
            assert got.dtype == tt.dtype and got.shape == (my, mx)
            hy, hx = (ly if flags[3] else my), (lx if flags[1] else mx)
            np.testing.assert_allclose(got.numpy()[:hy, :hx], want[:hy, :hx],
                                       rtol=0, atol=atol, err_msg=f"flags6 {f6}")


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_k5_plain_matches_jax_kernel_f64(bc_class, k):
    jcfg, tcfg = make_cfgs(128, 64, bc_class, vy=0.4 if k == 8 else -0.25)
    k5_cases(window(64, 128, 8, np.float64, seed=40 + k), jcfg, tcfg, k, 1e-13)


@pytest.mark.parametrize("bc_class", ["P4", "one_sided_y", "both_axes"])
def test_k5_plain_matches_jax_kernel_f32(bc_class):
    jcfg, tcfg = make_cfgs(128, 64, bc_class)
    k5_cases(window(64, 128, 8, np.float32, seed=50), jcfg, tcfg, 8, 2e-5)


@pytest.mark.parametrize("bcs", [ONE_SIDED["high_y"], ONE_SIDED["high_x"], (D, P, N, P)])
def test_k5_plain_matches_jax_kernel_high_side_periodic(bcs):
    """One-sided axes whose HIGH side wraps (none of BC_CLASSES): the wrap
    block sits above the true edge, and its outer line (g == l) takes the
    low side's BC."""
    jcfg, tcfg = cfgs(128, 64, bcs)
    for k in (3, 8):
        k5_cases(window(64, 128, 8, np.float64, seed=60 + k), jcfg, tcfg, k, 1e-13)


def test_k5_at_the_full_extent_is_k4_and_checks_its_inputs():
    _, tcfg = make_cfgs(128, 64, "both_axes")
    tile, xh, yh = port_slabs(window(64, 128, 8, np.float64, seed=7), 8)
    count = tsh.carrier_tile_slab_multistep.launches
    for flags in K5_FLAGS:
        torch.testing.assert_close(
            tsh.carrier_tile_slab_multistep(tile, xh, yh, (*flags, 64, 128), tcfg, 0.1, 5, khalo=8),
            tsh.sharded_tile_slab_multistep(tile, xh, yh, flags, tcfg, 0.1, 5, khalo=8),
            rtol=0, atol=0)
    assert tsh.carrier_tile_slab_multistep.launches == count  # CPU: no launch
    with pytest.raises(ValueError, match="true extent"):
        tsh.carrier_tile_slab_multistep(tile, xh, yh, (1, 1, 1, 1, 65, 10), tcfg, 0.1, 2, khalo=8)
    with pytest.raises(ValueError, match="true extent"):
        tsh.carrier_tile_slab_multistep(tile, xh, yh, (1, 1, 1, 1, 10, 0), tcfg, 0.1, 2, khalo=8)
    with pytest.raises(ValueError, match="six"):
        tsh.carrier_tile_slab_multistep(tile, xh, yh, (1, 1, 1, 1), tcfg, 0.1, 2, khalo=8)
    with pytest.raises(ValueError, match="yhalo"):
        tsh.carrier_tile_slab_multistep(tile, xh, yh[:, 2:], (0,) * 4 + (8, 8), tcfg, 0.1, 2,
                                        khalo=8)


# ------------------------------------------------------------ geometry


@pytest.mark.parametrize("mode", ["none", "two", "low", "high"])
def test_carrier_axis_plan_matches_jax(mode):
    """The port plans at the JAX plan's ``align=1``, the only alignment it
    has."""
    for p in (1, 2, 3, 4, 8):
        for kh in (1, 4, 8, 16):
            for n in (5, 9, 36, 101, 131, 251, 509, 511, 1000, 1024, 2500, 4001):
                assert thalo._carrier_axis_plan(n, p, mode, kh) == \
                    jhalo._carrier_axis_plan(n, p, mode, 1, kh), (n, p, mode, kh)


def test_split_sizes_and_remainder_tiles_round_trip():
    """The reference's decomposition (decomp.cpp:29-30): n // p each, the
    last tile the remainder; shard_field and gather_field take it."""
    assert tmesh.split_sizes(509, 4) == [127, 127, 127, 128]
    assert tmesh.split_sizes(131, 1) == [131]
    assert tmesh.split_sizes(8, 4) == [2, 2, 2, 2]
    with pytest.raises(ValueError, match="cannot be split"):
        tmesh.split_sizes(3, 4)
    u = torch.from_numpy(field(101, 251))
    m = cpu_mesh(2, 2)
    tiles = tmesh.shard_field(u, m)
    assert [[tuple(t.shape) for t in row] for row in tiles] == [
        [(50, 125), (50, 126)], [(51, 125), (51, 126)]]
    assert all(t.is_contiguous() for row in tiles for t in row)
    torch.testing.assert_close(tmesh.gather_field(tiles, m), u, rtol=0, atol=0)


def test_from_reference_sharded_takes_indivisible_grids_and_the_carrier_embeds():
    """A JAX field of an indivisible grid becomes remainder tiles; for the
    carrier it goes in through the advance's embed and comes back through
    extract."""
    jcfg, _ = cfgs(251, 101, (D, N, P, P))
    u = field(101, 251, seed=3)
    cfg, tiles = from_reference_sharded(jconfig.config_to_dict(jcfg), u, cpu_mesh(2, 2))
    assert tiles[1][1].shape == (51, 126)
    np.testing.assert_array_equal(tmesh.gather_field(tiles).numpy(), u)
    _, t = from_reference(jconfig.config_to_dict(jcfg), u)
    adv = thalo.build_carrier_slab_advance(cfg, cpu_mesh(2, 2), cfg.dt)
    carrier = adv.embed(t)
    np.testing.assert_array_equal(tmesh.gather_field(adv.extract(carrier)).numpy(), u)
    full = tmesh.gather_field(carrier).numpy()
    assert full.shape == adv.carrier_shape and not full[101:].any() and not full[:, 251:].any()


# -------------------------------------------------------------- advances

CARRIER_CASES = {
    # name: ((nx, ny), (px, py), bcs, compat, chunks, config extras)
    "251x101_2x2_D4": ((251, 101), (2, 2), (D, D, D, D), False, (11, 5), {}),
    "251x101_2x2_P4": ((251, 101), (2, 2), (P, P, P, P), False, (11, 5), {}),
    "251x101_2x2_bench_mix": ((251, 101), (2, 2), (D, N, P, P), False, (11, 5), {}),
    "251x101_2x2_compat": ((251, 101), (2, 2), (P, P, P, P), True, (11, 5), {}),
    "509x131_1x4_dev": ((509, 131), (1, 4), ONE_SIDED["low_y"], False, (11, 5), {}),
    "509x131_4x1_dev": ((509, 131), (4, 1), ONE_SIDED["low_y"], False, (11, 5), {}),
    # 258x259 tiles: k = 8, a chunk of 19 ends in a remainder pass of 3
    "515x517_2x2_P4": ((515, 517), (2, 2), (P, P, P, P), False, (19,), {}),
    "515x517_2x2_compat": ((515, 517), (2, 2), (P, P, P, P), True, (19,), {}),
    **{f"515x517_2x2_{name}": ((515, 517), (2, 2), bcs, False, (19,), {})
       for name, bcs in ONE_SIDED.items()},
    # k = 16 on 514x515 tiles: one pass of 16 and a remainder of 3
    "1027x1029_2x2_spp16_P4": ((1027, 1029), (2, 2), (P, P, P, P), False, (19,),
                               {"steps_per_pass": 16, "out_every": 32}),
    "1027x1029_2x2_spp16_high_x_low_y": ((1027, 1029), (2, 2), ONE_SIDED["high_x_low_y"],
                                         False, (19,), {"steps_per_pass": 16, "out_every": 32}),
    # the y edge on tile 2 of 4 (k = 1, a true extent of 1 line there):
    # tile 3 is all pad, and its garbage wraps to tile 0's bottom halo,
    # behind the Dirichlet fixup
    "200x9_1x4_high_y_trailing_pad_tile": ((200, 9), (1, 4), ONE_SIDED["high_y"], False,
                                           (7,), {}),
    "9x200_4x1_D4_trailing_pad_tile": ((9, 200), (4, 1), (D, N, D, D), False, (7,), {}),
}


@pytest.mark.parametrize("case", list(CARRIER_CASES))
def test_carrier_advance_matches_jax_oracle(case):
    (nx, ny), (px, py), bcs, compat, chunks, extra = CARRIER_CASES[case]
    jcfg, tcfg = cfgs(nx, ny, bcs, compat, **extra)
    u = field(ny, nx, seed=len(case))
    got, adv, _ = run_carrier(tcfg, px, py, u, chunks)
    assert adv.kernel == "K5" and adv.path == "carrier"
    np.testing.assert_allclose(got, jax_oracle(u, jcfg, sum(chunks)), rtol=0, atol=1e-12)


def test_carrier_plan_of_the_cases():
    """The geometry the cases above rely on: padding on the axes they name,
    the pass size, and the trailing all-pad tiles."""
    def plan(case):
        (nx, ny), (px, py), bcs, compat, _, extra = CARRIER_CASES[case]
        _, tcfg = cfgs(nx, ny, bcs, compat, **extra)
        adv = thalo.build_carrier_slab_advance(tcfg, cpu_mesh(px, py), tcfg.dt)
        return adv.carrier_shape, adv.pass_count(19), adv.flags6

    assert plan("515x517_2x2_P4")[:2] == ((534, 532), 3)
    assert plan("1027x1029_2x2_spp16_P4")[:2] == ((1062, 1060), 2)
    shape, passes, flags6 = plan("200x9_1x4_high_y_trailing_pad_tile")
    assert shape == (16, 200) and passes == 19
    assert [flags6(y, 0) for y in range(4)] == [
        (1, 1, 1, 0, 1, 200), (1, 1, 0, 0, 1, 200), (1, 1, 0, 1, 1, 200), (1, 1, 0, 0, 1, 200)]
    shape, _, flags6 = plan("9x200_4x1_D4_trailing_pad_tile")
    assert shape == (200, 12) and flags6(0, 3) == (0, 0, 1, 1, 200, 3)


def test_carrier_bf16_within_bound_of_f32():
    """bf16 storage on the carrier: f32 arithmetic, one rounding per pass
    (3 passes here), within 8e-3 of the f32 run."""
    _, tcfg = cfgs(515, 517, ONE_SIDED["low_y"])
    u = field(517, 515, seed=9)
    m = cpu_mesh(2, 2)
    adv = thalo.build_carrier_slab_advance(tcfg, m, tcfg.dt)
    runs = {}
    for dtype in (torch.float32, torch.bfloat16):
        c = adv(19)(adv.embed(torch.from_numpy(u).to(dtype)))
        assert c[0][0].dtype == dtype
        runs[dtype] = tmesh.gather_field(adv.extract(c)).to(torch.float32)
    assert float((runs[torch.bfloat16] - runs[torch.float32]).abs().max()) < 8e-3


def test_carrier_stages_only_pad_lines_so_a_held_field_stays_valid():
    """The driver copies a held snapshot while the next span runs.  The
    staging (tail-mirror, heads, and the pad zeroing of a dt outside the
    convex envelope) writes only pad lines of its input, so the true
    extent of the held carrier is unchanged after the next span."""
    _, tcfg = cfgs(515, 517, (P, P, P, P))
    for dt in (0.1, 4.0):   # 4.0: sum |w| > 1, so the pads are zeroed
        adv = thalo.build_carrier_slab_advance(tcfg, cpu_mesh(2, 2), dt)
        held = adv(8)(adv.embed(torch.from_numpy(field(517, 515, seed=2))))
        views = adv.extract(held)
        before = [[v.clone() for v in row] for row in views]
        pads = tmesh.gather_field(held).clone()
        adv(8)(held)
        for row_v, row_b in zip(views, before):
            for v, b in zip(row_v, row_b):
                assert torch.equal(v, b)
        assert not torch.equal(tmesh.gather_field(held), pads)   # the pads were staged


@pytest.mark.parametrize("bc_class, wraps, heads", [
    ("D4", set(), set()), ("compat", set(), set()), ("MIX2", {"x"}, {"x"}),
    ("low_y", {"y"}, set()), ("high_y", {"y"}, {"y"}), ("P4", {"x", "y"}, {"x", "y"}),
])
def test_carrier_copies_carry_no_wrap_or_head_payload_on_nonperiodic_axes(
        bc_class, wraps, heads):
    """``mesh.copies`` on a 2x2 carrier: a wrap payload and a wrap-head
    payload on an axis only where that axis has a live-periodic side, the
    head only where the high side wraps."""
    bcs, compat = ONE_SIDED.get(bc_class), False
    if bcs is None:
        bcs, compat = BC_CLASSES[bc_class]
    _, tcfg = cfgs(515, 517, bcs, compat)
    _, adv, m = run_carrier(tcfg, 2, 2, field(517, 515), (16,))
    passes = adv.pass_count(16)
    for axis in ("x", "y"):
        assert m.copies[(axis, False)] == passes * 2 * 2
        assert m.copies[(axis, True)] == (passes * 2 * 2 if axis in wraps else 0)
        assert m.copies[(axis, "head")] == (passes * 2 if axis in heads else 0), m.copies


@pytest.mark.parametrize("kernel", ["jnp", "pallas"])
@pytest.mark.parametrize("px, py", [(2, 2), (1, 4), (4, 1)])
def test_padded_advance_matches_jax_oracle(px, py, kernel):
    """The per-step path on remainder tiles, torch ops (``jnp``) or K2's
    plain version (``pallas``), for every BC class in turn."""
    m = cpu_mesh(px, py)
    for i, bc_class in enumerate(BC_CLASSES):
        bcs, compat = BC_CLASSES[bc_class]
        jcfg, tcfg = cfgs(67 + 4 * i, 45 + 2 * i, bcs, compat, kernel=kernel)
        u = field(tcfg.ny, tcfg.nx, seed=i)
        adv = thalo.build_padded_advance(tcfg, m, tcfg.dt)
        assert adv.kernel == ("K2" if kernel == "pallas" else None)
        assert adv.pass_count(7) == 7
        got = tmesh.gather_field(adv(7)(tmesh.shard_field(torch.from_numpy(u), m)), m)
        np.testing.assert_allclose(got.numpy(), jax_oracle(u, jcfg, 7), rtol=0, atol=1e-12,
                                   err_msg=bc_class)


# ---------------------------------------------------------------- driver


def read_back(path):
    with TNetCDFFile(path) as ds:
        attrs = {k: ds.getncattr(k) for k in ds.ncattrs()}
        return dict(ds.dimensions), attrs, np.asarray(ds.variables["u"][:, :, :])


DRIVER_CASES = {
    # name: (yaml, overrides, (px, py), port kernel, port path)
    "dev_509x131_4x1_carrier": (DEV, ["--nx=509", "--ny=131", "--steps=20", "--out_every=10"],
                                (4, 1), "pallas", "carrier, K5 plain version"),
    "dev_509x131_1x4_carrier": (DEV, ["--nx=509", "--ny=131", "--steps=20", "--out_every=10",
                                      "--write_final=true", "--diagnostics_every=1"],
                                (1, 4), "pallas", "carrier, K5 plain version"),
    "p4_251x101_2x2_carrier": (DEV, ["--nx=251", "--ny=101", "--steps=13", "--out_every=4",
                                     "--bc.left=periodic", "--bc.right=periodic",
                                     "--bc.bottom=periodic", "--bc.top=periodic"],
                               (2, 2), "pallas", "carrier, K5 plain version"),
    "dev_251x101_2x2_padded": (DEV, ["--nx=251", "--ny=101", "--steps=12", "--out_every=5"],
                               (2, 2), "jnp", "remainder per-step, torch ops per step"),
}


@pytest.mark.parametrize("case", list(DRIVER_CASES))
def test_run_simulation_on_an_indivisible_grid_matches_jax(tmp_path, capsys, case):
    """The port's carrier (K5 plain version) or remainder-tile path against
    the JAX package's jnp-class path on the same grid and mesh: snapshots,
    diagnostics and the final field, f64."""
    yaml_path, extra, (px, py), kernel, path = DRIVER_CASES[case]
    n = px * py
    nx, ny = (int(a.split("=")[1]) for a in extra[:2])
    args = extra + ["--precision=f64", f"--mesh.x={px}"]
    jres = jrun(jconfig.merged_config(yaml_path, args + ["--kernel=jnp",
                                                        f"--output.dir={tmp_path}/j"]),
                devices=jax.devices()[:n])
    jout = capsys.readouterr().out
    tres = tdriver.run_simulation(
        tconfig.merged_config(yaml_path, args + [f"--kernel={kernel}", f"--output.dir={tmp_path}/t"]),
        ["cpu"] * n)
    tout = capsys.readouterr().out
    assert f"path: {path}" in tout
    assert ("CARRIER path" in tout) == (kernel == "pallas")
    assert tres.mesh_shape == jres.mesh_shape == (py, px)
    assert tres.u.shape == (ny, nx)
    assert tres.snapshots_written == jres.snapshots_written
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-12)
    jd, ja, jf = read_back(jres.output_path)
    td, ta, tf = read_back(tres.output_path)
    assert td == jd and ta == ja and tf.shape[1:] == (ny, nx)
    np.testing.assert_allclose(tf, jf, rtol=0, atol=1e-12)
    for line in ("IC min/max", "diag: step="):
        assert ([ln for ln in tout.splitlines() if ln.startswith(line)]
                == [ln for ln in jout.splitlines() if ln.startswith(line)])


def test_carrier_restart_from_own_snapshot(tmp_path):
    """Two 4-step carrier runs chained through the first's final snapshot
    equal one 8-step run (spans of 4, one pass each, so the pass grouping
    is the same)."""
    base = ["--nx=251", "--ny=101", "--out_every=4", "--precision=f64", "--kernel=pallas",
            "--mesh.x=2"]
    devs = ["cpu"] * 4
    r1 = tdriver.run_simulation(tconfig.merged_config(
        DEV, base + ["--steps=4", "--write_final=true", f"--output.dir={tmp_path}/a"]), devs)
    r2 = tdriver.run_simulation(tconfig.merged_config(
        DEV, base + ["--steps=4", "--ic.mode=file", f"--ic.path={r1.output_path}",
                     f"--output.dir={tmp_path}/b"]), devs)
    r3 = tdriver.run_simulation(tconfig.merged_config(
        DEV, base + ["--steps=8", f"--output.dir={tmp_path}/c"]), devs)
    assert r1.mesh_shape == r2.mesh_shape == (2, 2)
    torch.testing.assert_close(r2.u, r3.u, rtol=0, atol=0)


@pytest.mark.parametrize("nx, ny", [(5, 5), (13, 3)])
def test_driver_warns_when_the_carrier_declines(nx, ny, capsys):
    """5x5: the carrier would hold more than twice the grid; 13x3: a
    periodic y axis of 3 lines cannot stage on 2 tiles.  The driver warns
    and takes the remainder-tile path with K2."""
    args = [f"--nx={nx}", f"--ny={ny}", "--steps=3", "--out_every=3", "--precision=f64",
            "--bc.left=periodic", "--bc.right=periodic", "--bc.bottom=periodic",
            "--bc.top=periodic"]
    tres = tdriver.run_simulation(tconfig.merged_config(None, args + ["--kernel=pallas"]),
                                  ["cpu"] * 4, write_output=False)
    out, err = capsys.readouterr()
    assert "[warn] kernel=pallas requested" in err and "downgrading" in err
    assert "path: remainder per-step, K2 plain version" in out
    jres = jrun(jconfig.merged_config(None, args + ["--kernel=jnp"]), devices=jax.devices()[:4],
                write_output=False)
    np.testing.assert_allclose(tres.u.numpy(), np.asarray(jres.u), rtol=0, atol=1e-12)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K5's CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(96, 120), (300, 260), (333, 241)])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_k5_cuda_kernel_matches_plain_on_card(cuda_device, bc_class, shape):
    """Carrier tiles of one band, of two bands, and one column wider than
    a band's output with a ragged last segment; true extents inside."""
    my, mx = shape
    _, tcfg = make_cfgs(mx, my, bc_class)
    tile, xh, yh = (t.to(cuda_device) for t in port_slabs(window(my, mx, 8, np.float32, 6), 8))
    for ly, lx in ((my, mx), (my - 51, mx - 20), (8, 8)):
        for flags in K5_FLAGS:
            f6 = (*flags, ly, lx)
            n = tsh.carrier_tile_slab_multistep.launches
            got = tsh.carrier_tile_slab_multistep(tile, xh, yh, f6, tcfg, 0.1, 8, khalo=8)
            torch.cuda.synchronize(cuda_device)
            assert tsh.carrier_tile_slab_multistep.launches == n + 1
            want = tsh.carrier_pass_plain(tile, xh, yh, f6, tcfg, 0.1, 8, 8)
            torch.testing.assert_close(got, want, rtol=0, atol=1e-6)
