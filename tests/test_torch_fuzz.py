"""Seeded differential nets of the PyTorch port against the JAX package, on
the CPU: the counterparts of the JAX package's fuzzes
(tests/test_pallas.py ``test_seeded_fuzz_matches_oracle``,
tests/test_carrier.py ``test_carrier_fuzz_random_geometries``, and the
driver fuzz behind tests/test_driver.py's stability advisory).

Each draw is made from a seed fixed in this file (``random.Random`` or a
numpy generator), and each is its own case of a parametrised test, whose
id names the draw.  The JAX side runs as its own tests run it: Pallas in
interpret mode, or the jnp path, on the conftest's 8 virtual devices.  The
port runs on CPU tensors, so its kernels take their plain versions (the
CUDA kernels are held to those on the card by ``chip_smoke.py``'s fuzz
phase).

* K1: the port's ``multistep_kernel_step`` against JAX's, f32 within
  ``3e-5`` and f64 within ``1e-12`` of the field's scale (JAX's measure:
  the max error over ``max(1, max |ref|)``).  Where JAX's kernel declines
  a draw, or the pass is longer than a wrapping axis (where JAX's kernel
  is off its own per-step path), JAX's per-step path over the same k
  steps stands in.  The band geometry of every k is one the CUDA core
  launches (the card's fuzz found odd k in 9-15 refused).
* The carrier: the port's ``_carrier_axis_plan`` equals JAX's at
  ``align=1`` on both axes, and the port's carrier advance on a tile mesh
  of the CPU device matches JAX's carrier run within ``7e-5`` in f32
  (JAX's bound; the JAX oracle where JAX's carrier declines).
* The driver: ``run_simulation`` of both packages in f64 on random
  configs and meshes; final fields within ``1e-11`` of the field's scale,
  snapshot counts, headers and attributes equal (read with both readers),
  and the same exception type where one package raises.
"""

import random

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.io import netcdf as jnetcdf
from climate_sim_tpu.ops import pallas_stencil as jps
from climate_sim_tpu.ops.init import gaussian_hotspot as jgaussian
from climate_sim_tpu.ops.step import reference_step as jreference_step
from climate_sim_tpu.parallel import halo as jhalo
from climate_sim_tpu.parallel.mesh import make_mesh as jmake_mesh
from climate_sim_tpu.runtime.driver import run_simulation as jrun

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.io.netcdf import NetCDFFile as TNetCDFFile
from climate_sim_tpu_torch.ops import cuda_stencil as tcs
from climate_sim_tpu_torch.parallel import halo as thalo
from climate_sim_tpu_torch.parallel import mesh as tmesh
from climate_sim_tpu_torch.runtime import driver as tdriver

KINDS = ("dirichlet", "neumann", "periodic")
DTYPES = {"f32": (np.float32, 3e-5), "f64": (np.float64, 1e-12)}


def cfg_pair(bcs, compat=False, **kw):
    """(JAX config, port config) with the same fields and BCs (left,
    right, bottom, top)."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.SimConfig(**kw)
        cfg.bc = mod.BCConfig(*(mod.bc_from_string(b) for b in bcs))
        cfg.strict_reference_compat = compat
        out.append(cfg)
    return out


def scaled_err(got, want):
    """JAX's fuzz measure: max abs error over max(1, max |want|)."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def jax_oracle(u, jcfg, dt, steps):
    v = jnp.asarray(u)
    for _ in range(steps):
        v = jreference_step(v, jcfg, dt)
    return np.asarray(v)


# ------------------------------------------------------------------- K1


def band_edge_width(k, dtype):
    """nx one more than K1's band output width at pass size k and dtype on
    a tall grid (the streaming core's edge; ``chip_smoke.py``'s fuzz)."""
    torch_dtype = {"f32": torch.float32, "f64": torch.float64}[dtype]
    return tcs.k1_geometry(4096, 4096, k, torch_dtype).width - 2 * k + 1


def k1_draws(n=16, seed=20260817):
    """tests/test_pallas.py's generator (its seed, grids, spacings, D/v and
    dt inside the combined bound, compat in a quarter, edge-parked mass in
    half), with k in {1, 2, 5, 8, 32}, grids narrower than one band and
    widths one more than a band's output width, and a dtype a draw."""
    rng = random.Random(seed)
    draws = []
    for trial in range(n):
        k = rng.choice([1, 2, 5, 8, 32])
        nx = rng.choice([20, 40, 96, 128, 136, 200, None])  # None: K1's band edge
        ny = rng.choice([7, 24, 64, 96, 130])
        D = rng.choice([0.0, 0.1, 0.24])
        vx = rng.choice([0.0, -0.7, 1.0])
        vy = rng.choice([0.5, -0.5, 0.9])
        dx = rng.choice([0.5, 1.0, 2.0])
        dy = rng.choice([0.5, 1.0, 2.0])
        denom = abs(vx) / dx + abs(vy) / dy + 2 * D * (1 / dx**2 + 1 / dy**2)
        dt = 0.9 / denom if denom > 0 else 0.1
        bcs = tuple(rng.choice(KINDS) for _ in range(4))
        compat = rng.random() < 0.25
        park = rng.choice([0, 1]) if rng.random() < 0.5 else None
        dtype = rng.choice(list(DTYPES))
        if nx is None:
            nx = band_edge_width(k, dtype)
        draws.append(pytest.param(
            dict(nx=nx, ny=ny, D=D, vx=vx, vy=vy, dx=dx, dy=dy, dt=dt, k=k, bcs=bcs,
                 compat=compat, park=park, dtype=dtype),
            id=f"t{trial}-{nx}x{ny}-k{k}-{dtype}-{''.join(b[0] for b in bcs)}"
               f"{'-compat' if compat else ''}{'' if park is None else f'-park{park}'}"))
    return draws


def wraps_past_extent(tcfg, k):
    """A pass longer than a wrapping axis is wide: JAX's K1 stages one
    k-line copy of the opposite edge, which such an axis does not hold, so
    it is off its own per-step path there (or raises); the port's K1
    re-wraps every sub-step.  JAX's driver never asks for such a pass
    (``pick_steps_per_pass`` keeps k <= n // 32)."""
    wrap_x, wrap_y = thalo.axis_wrap_flags(tcfg)
    return (wrap_x and k > tcfg.nx) or (wrap_y and k > tcfg.ny)


def k1_case(draw):
    """(JAX config, port config, the input field, k, tolerance)."""
    d = dict(draw)
    k, dtype = d.pop("k"), d.pop("dtype")
    park, bcs, compat = d.pop("park"), d.pop("bcs"), d.pop("compat")
    jcfg, tcfg = cfg_pair(bcs, compat, steps=8, out_every=8, **d)
    np_dtype, tol = DTYPES[dtype]
    u = np.asarray(jgaussian(jcfg, jnp.float64))
    if park is not None:
        # Mass parked against an edge: a centred bump decays to ~0 there
        # and would mask edge handling.
        u = u + 0.5 * np.roll(u, u.shape[park] // 2 - 2, axis=park)
    return jcfg, tcfg, u.astype(np_dtype), k, tol


@pytest.mark.parametrize("draw", k1_draws())
def test_k1_fuzz_matches_jax(draw):
    """The port's K1 against JAX's; where JAX's kernel declines the draw,
    or the pass is longer than a wrapping axis (:func:`wraps_past_extent`),
    against JAX's per-step path over the same k steps."""
    jcfg, tcfg, u, k, tol = k1_case(draw)
    want = None
    if not wraps_past_extent(tcfg, k):
        want = jps.multistep_kernel_step(jnp.asarray(u), jcfg, jcfg.dt, k, interpret=True)
    if want is None:
        want = jax_oracle(u, jcfg, jcfg.dt, k)
    got = tcs.multistep_kernel_step(torch.from_numpy(u), tcfg, tcfg.dt, k)
    assert got.dtype == torch.from_numpy(u).dtype and got.shape == u.shape
    assert np.asarray(want).dtype == u.dtype
    err = scaled_err(got.numpy(), want)
    assert err < tol, (draw, err)


def test_k1_pass_longer_than_a_periodic_axis():
    """The fuzz's draw that found JAX's K1 off its own per-step path: a
    32-step pass on an all-periodic 193x24 grid.  The port's K1 holds to
    that path, in f64."""
    draw = dict(nx=193, ny=24, D=0.24, vx=0.0, vy=0.9, dx=2.0, dy=1.0, dt=0.6, k=32,
                bcs=("periodic",) * 4, compat=False, park=0, dtype="f64")
    jcfg, tcfg, u, k, tol = k1_case(draw)
    assert wraps_past_extent(tcfg, k)
    want = jax_oracle(u, jcfg, jcfg.dt, k)
    got = tcs.multistep_kernel_step(torch.from_numpy(u), tcfg, tcfg.dt, k)
    assert scaled_err(got.numpy(), want) < tol


@pytest.mark.parametrize("k", range(1, tcs.MAX_STEPS_PER_PASS + 1))
def test_band_geometry_fits_the_core_at_every_k(k):
    """Every band geometry is one the CUDA core launches (its ``band_ok``:
    whole warps, at most MAX_BAND, wider than the 2k halo).  The card's
    fuzz found odd k in 9-15 given widths of 16 mod 32, which the core
    refused (the K1 draw 326x262, k = 11)."""
    rng = np.random.default_rng(k)
    shapes = [(262, 326), (4096, 4096), (1, 1), (8, 2048), (2048, 8)]
    shapes += [tuple(int(v) for v in rng.integers(1, 5000, 2)) for _ in range(40)]
    for ny, nx in shapes:
        g = tcs.band_geometry(ny, nx, k)
        assert g.width % 32 == 0 and 2 * k < g.width <= tcs.MAX_BAND and g.rows >= 1, (
            ny, nx, g)


@pytest.mark.parametrize("k", range(1, tcs.MAX_STEPS_PER_PASS + 1))
def test_k1_geometry_fits_the_core_at_every_k(k):
    """K1's geometry is one the core launches, for every dtype: the wide
    body (cpt > 1, up to WIDE_MAX_STEPS) takes whole warps of cpt columns
    a thread, at most WIDE_THREADS threads, wider than the 2k halo; deeper
    passes take band_geometry's one-column cut."""
    rng = np.random.default_rng(100 + k)
    shapes = [(262, 326), (4096, 4096), (1, 1), (8, 2048), (2048, 8)]
    shapes += [tuple(int(v) for v in rng.integers(1, 5000, 2)) for _ in range(40)]
    for dtype in (torch.float32, torch.bfloat16, torch.float64):
        for ny, nx in shapes:
            g = tcs.k1_geometry(ny, nx, k, dtype)
            if k > tcs.WIDE_MAX_STEPS:
                assert g == (*tcs.band_geometry(ny, nx, k), 1), (ny, nx, g)
                continue
            assert g.cpt == tcs.WIDE_COLUMNS[dtype], (ny, nx, g)
            assert g.width % (32 * g.cpt) == 0 and 2 * k < g.width, (ny, nx, g)
            assert g.width <= tcs.WIDE_THREADS * g.cpt and g.rows >= 1, (ny, nx, g)


# -------------------------------------------------------------- carrier


CARRIER_MESHES = [(4, 2), (2, 4), (2, 2), (1, 8), (8, 1), (1, 1), (2, 1)]


def carrier_draws(n=10, seed=12345):
    """tests/test_carrier.py's generator (the conftest's numpy seed, its
    meshes, grids 150-300·px x 40-90·py, steps 3-13, compat in a quarter)."""
    rng = np.random.default_rng(seed)
    draws = []
    for trial in range(n):
        px, py = CARRIER_MESHES[rng.integers(len(CARRIER_MESHES))]
        nx = int(rng.integers(150 * px, 300 * px))
        ny = int(rng.integers(40 * py, 90 * py))
        bcs = tuple(KINDS[rng.integers(3)] for _ in range(4))
        steps = int(rng.integers(3, 14))
        compat = bool(rng.integers(4) == 0)
        draws.append(pytest.param(
            (px, py, nx, ny, bcs, steps, compat),
            id=f"t{trial}-{nx}x{ny}-{px}x{py}-{''.join(b[0] for b in bcs)}-s{steps}"
               f"{'-compat' if compat else ''}"))
    return draws


CARRIER_DRAWS = carrier_draws()


def carrier_cfgs(nx, ny, bcs, compat):
    return cfg_pair(bcs, compat, nx=nx, ny=ny, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                    steps=16, out_every=8)


def port_carrier(tcfg, px, py):
    return thalo.build_carrier_slab_advance(
        tcfg, tmesh.make_mesh(px, py, ["cpu"] * (px * py)), tcfg.dt)


@pytest.mark.parametrize("draw", CARRIER_DRAWS)
def test_carrier_fuzz_matches_jax(draw):
    px, py, nx, ny, bcs, steps, compat = draw
    jcfg, tcfg = carrier_cfgs(nx, ny, bcs, compat)
    adv = port_carrier(tcfg, px, py)
    # The planner: the port's plan is JAX's at align=1 (no TPU alignment),
    # at the staging depth of the ceil(n/p) tile.
    kh = tcs.pick_steps_per_pass(tconfig.SimConfig(nx=-(-nx // px), ny=-(-ny // py)),
                                 tcfg.out_every)
    assert adv is None or adv.steps_per_pass == kh
    for n, p, (lo, hi) in ((nx, px, (tcfg.bc.left, tcfg.bc.right)),
                           (ny, py, (tcfg.bc.bottom, tcfg.bc.top))):
        mode = thalo._axis_mode(lo, hi, compat)
        assert thalo._carrier_axis_plan(n, p, mode, kh) == \
            jhalo._carrier_axis_plan(n, p, mode, 1, kh), (n, p, mode, kh)

    u = np.array(jgaussian(jcfg, jnp.float32))  # writable, for torch.from_numpy
    jmesh = jmake_mesh(px, py, jax.devices()[: px * py])
    jadv = jhalo.build_carrier_slab_advance(jcfg, jmesh, jcfg.dt, interpret=True)
    if jadv is not None:
        want = np.asarray(jadv.extract(jadv(steps)(jadv.embed(jnp.asarray(u)))))
    else:
        want = jax_oracle(u, jcfg, jcfg.dt, steps)
    if adv is None:
        # The port declined (its driver then runs the remainder tiles):
        # nothing of the carrier to compare; the count test below holds
        # the net to enough carrier runs.
        return
    got = tmesh.gather_field(adv.extract(adv(steps)(adv.embed(torch.from_numpy(u)))))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=7e-5, err_msg=str(draw))


def test_carrier_fuzz_exercises_the_carrier():
    """As in JAX's net, at least 6 draws run the carrier."""
    ran = sum(port_carrier(carrier_cfgs(nx, ny, bcs, compat)[1], px, py) is not None
              for px, py, nx, ny, bcs, steps, compat in (p.values[0] for p in CARRIER_DRAWS))
    assert ran >= 6, f"the net ran the carrier on only {ran} draws"


# --------------------------------------------------------------- driver


DRIVER_MESHES = [(1, 1), (1, 2), (2, 1), (2, 2), (1, 4), (4, 1), (8, 1)]
PORT_KERNELS = ["jnp", "pallas", "pallas_multistep"]


def driver_draws(n=28, seed=20261017):
    """Random configs: grids 4-90 (the mesh often does not divide them),
    all 81 BC mixes, D, vx, vy (both signs), dx, dy, dt (inside and past
    the combined bound, and past the clamp), steps 1-40, out_every 1-25,
    compat, steps_per_pass, the port's kernel and the JAX kernel, the mesh
    and halo_overlap.  The mesh and the port's kernel cycle, so that every
    pair of them is drawn."""
    rng = random.Random(seed)
    draws = []
    for trial in range(n):
        px, py = DRIVER_MESHES[trial % len(DRIVER_MESHES)]
        kernel = PORT_KERNELS[trial % len(PORT_KERNELS)]
        nx, ny = rng.randint(4, 90), rng.randint(4, 90)
        bcs = tuple(rng.choice(KINDS) for _ in range(4))
        D = rng.choice([0.0, 0.02, 0.1, 0.2])
        vx = rng.choice([0.0, 0.3, -0.5, 1.0, -1.0])
        vy = rng.choice([0.0, 0.25, -0.4, 0.9, -0.9])
        dx, dy = rng.choice([0.5, 1.0, 2.0]), rng.choice([0.5, 1.0, 2.0])
        denom = abs(vx) / dx + abs(vy) / dy + 2 * D * (1 / dx**2 + 1 / dy**2)
        dt = round(rng.uniform(0.3, 1.2) / denom if denom else rng.uniform(0.05, 1.0), 6)
        d = dict(nx=nx, ny=ny, bcs=bcs, D=D, vx=vx, vy=vy, dx=dx, dy=dy, dt=dt,
                 steps=rng.randint(1, 40), out_every=rng.randint(1, 25),
                 compat=rng.random() < 0.25, steps_per_pass=rng.choice([0, 1, 3, 8]),
                 kernel=kernel, jax_kernel=rng.choice(["jnp", "pallas"]), mesh=(px, py),
                 halo_overlap=rng.choice(["auto", "true", "false"]))
        draws.append(pytest.param(
            d, id=f"t{trial}-{nx}x{ny}-{px}x{py}-{kernel}-j{d['jax_kernel']}"
                  f"-{''.join(b[0] for b in bcs)}{'-compat' if d['compat'] else ''}"))
    return draws


def read_back(path, reader):
    with reader(path) as ds:
        attrs = {k: ds.getncattr(k) for k in ds.ncattrs()}
        return dict(ds.dimensions), attrs, np.asarray(ds.variables["u"][:, :, :])


def run_or_raise(fn):
    try:
        return fn(), None
    except Exception as e:  # the type is compared across the packages
        return None, e


@pytest.mark.parametrize("draw", driver_draws())
def test_driver_fuzz_matches_jax(tmp_path, draw):
    d = draw
    px, py = d["mesh"]
    args = [f"--nx={d['nx']}", f"--ny={d['ny']}", f"--D={d['D']}", f"--vx={d['vx']}",
            f"--vy={d['vy']}", f"--dx={d['dx']}", f"--dy={d['dy']}", f"--dt={d['dt']}",
            f"--steps={d['steps']}", f"--out_every={d['out_every']}",
            f"--steps_per_pass={d['steps_per_pass']}", f"--halo_overlap={d['halo_overlap']}",
            f"--strict_reference_compat={str(d['compat']).lower()}", "--precision=f64",
            *(f"--bc.{side}={b}" for side, b in zip(("left", "right", "bottom", "top"),
                                                     d["bcs"])),
            f"--mesh.x={px}", f"--mesh.y={py}"]
    jcfg = jconfig.merged_config(None, args + [f"--kernel={d['jax_kernel']}",
                                               f"--output.dir={tmp_path}/jax"])
    tcfg = tconfig.merged_config(None, args + [f"--kernel={d['kernel']}",
                                               f"--output.dir={tmp_path}/port"])
    jres, jerr = run_or_raise(lambda: jrun(jcfg, devices=jax.devices()[: px * py]))
    tres, terr = run_or_raise(lambda: tdriver.run_simulation(tcfg, ["cpu"] * (px * py)))
    assert type(terr) is type(jerr), (jerr, terr)
    if jerr is not None:
        return
    assert tres.snapshots_written == jres.snapshots_written
    assert tres.mesh_shape == jres.mesh_shape
    assert tres.dt == jres.dt and tres.clamped == jres.clamped
    assert scaled_err(tres.u.numpy(), jres.u) < 1e-11
    for reader in (jnetcdf.NetCDFFile, TNetCDFFile):
        jd, ja, ju = read_back(jres.output_path, reader)
        td, ta, tu = read_back(tres.output_path, reader)
        assert td == jd and ta == ja
        assert tu.shape == ju.shape
        assert scaled_err(tu, ju) < 1e-11
