"""Parity of the PyTorch port's ops with the JAX package's, on the CPU.

The same inputs, made with numpy from a seed, go through each JAX function
and its counterpart in ``climate_sim_tpu_torch.ops``: boundary (ghost ring),
stencil, initial conditions and the stability guard, for every BC class,
compat mode and the dev.yaml mix.  Tolerances: f64 ``atol 1e-12`` (round-off
of a different evaluation order), f32 ``atol 2e-5`` (the JAX kernel tests'
bound), pure data movement exactly.
"""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.io.snapshots import SnapshotWriter as JSnapshotWriter
from climate_sim_tpu.ops import boundary as jb
from climate_sim_tpu.ops import init as ji
from climate_sim_tpu.ops import stability as jst
from climate_sim_tpu.ops import stencil as js
from climate_sim_tpu.ops import step as jstep

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.ops import boundary as tb
from climate_sim_tpu_torch.ops import init as ti
from climate_sim_tpu_torch.ops import stability as tst
from climate_sim_tpu_torch.ops import stencil as ts
from climate_sim_tpu_torch.ops import step as tstep

D, N, P = "dirichlet", "neumann", "periodic"
# (left, right, bottom, top), compat
BC_CLASSES = {
    "D4": ((D, D, D, D), False),
    "N4": ((N, N, N, N), False),
    "P4": ((P, P, P, P), False),
    "bench": ((D, N, P, P), False),
    "MIX2": ((P, P, D, N), False),
    "dev": ((D, N, P, D), False),
    "one_sided_x": ((P, N, D, D), False),
    "both_axes": ((P, D, P, N), False),
    "compat": ((P, P, P, P), True),
}


def make_cfgs(nx, ny, bc_class, **kw):
    """The same config in both packages: (jax cfg, port cfg)."""
    bcs, compat = BC_CLASSES[bc_class]
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.SimConfig(nx=nx, ny=ny, **kw)
        cfg.bc = mod.BCConfig(*(mod.bc_from_string(b) for b in bcs))
        cfg.strict_reference_compat = compat
        out.append(cfg)
    return out


def edge_parked(ny, nx, seed=0):
    """Random values with mass hard against every edge, so ghost handling
    is load-bearing."""
    rng = np.random.default_rng(seed)
    u = 0.1 * rng.random((ny, nx))
    u[:, :2] += rng.random((ny, 2))
    u[:, -2:] += rng.random((ny, 2))
    u[:2, :] += rng.random((2, nx))
    u[-2:, :] += rng.random((2, nx))
    return u


def both(a, dtype=np.float64):
    a = np.asarray(a, dtype)
    return jnp.asarray(a), torch.from_numpy(a.copy())


@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_pad_with_ghosts_matches_jax(bc_class):
    jcfg, tcfg = make_cfgs(10, 7, bc_class)
    ju, tu = both(edge_parked(7, 10))
    compat = jcfg.strict_reference_compat
    want = np.asarray(jb.pad_with_ghosts(ju, jcfg.bc, 0.0, compat))
    got = tb.pad_with_ghosts(tu, tcfg.bc, 0.0, compat).numpy()
    # Corner ghosts are never read, but both packages build them the same
    # way: compare the whole ring exactly.
    np.testing.assert_array_equal(got, want)
    jp, tp = both(want + 1.0)
    np.testing.assert_array_equal(
        tb.apply_boundary(tp, tcfg.bc, 0.0, compat).numpy(),
        np.asarray(jb.apply_boundary(jp, jcfg.bc, 0.0, compat)),
    )


@pytest.mark.parametrize("value", [0.0, 2.5])
def test_dirichlet_value_matches_jax(value):
    jcfg, tcfg = make_cfgs(6, 5, "D4")
    ju, tu = both(edge_parked(5, 6, seed=3))
    np.testing.assert_array_equal(
        tb.pad_with_ghosts(tu, tcfg.bc, value).numpy(),
        np.asarray(jb.pad_with_ghosts(ju, jcfg.bc, value)),
    )


VELOCITIES = [(0.5, -0.25), (0.0, 0.0), (-0.7, 0.3), (0.25, 0.0)]


@pytest.mark.parametrize("vx,vy", VELOCITIES)
def test_stencil_operators_match_jax(vx, vy):
    """laplacian, diffusion, upwind differences (vx >= 0 backward, 0
    included), the accumulating advection and the fused step, in f64."""
    rng = np.random.default_rng(7)
    jup, tup = both(rng.random((9, 13)))
    D_, dt, dx, dy = 0.07, 0.1, 0.8, 1.3
    pairs = [
        (js.laplacian(jup, dx, dy), ts.laplacian(tup, dx, dy)),
        (js.diffusion_step(jup, D_, dt, dx, dy), ts.diffusion_step(tup, D_, dt, dx, dy)),
        (js.upwind_gradient(jup, vx, vy, dx, dy)[0], ts.upwind_gradient(tup, vx, vy, dx, dy)[0]),
        (js.upwind_gradient(jup, vx, vy, dx, dy)[1], ts.upwind_gradient(tup, vx, vy, dx, dy)[1]),
        (js.advection_increment(jup, vx, vy, dt, dx, dy),
         ts.advection_increment(tup, vx, vy, dt, dx, dy)),
        (js.advection_step(jup, jup[1:-1, 1:-1], vx, vy, dt, dx, dy),
         ts.advection_step(tup, tup[1:-1, 1:-1], vx, vy, dt, dx, dy)),
        (js.fused_step(jup, D_, vx, vy, dt, dx, dy), ts.fused_step(tup, D_, vx, vy, dt, dx, dy)),
    ]
    for want, got in pairs:
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)


def test_fused_step_storage_bf16_matches_jax():
    """bf16 storage: f32 arithmetic, one rounding.  Both packages round the
    same f32 value, which can differ in its last bits, so the results agree
    to one bf16 ulp of the value."""
    rng = np.random.default_rng(11)
    a = rng.random((17, 23)).astype(np.float32)
    want = js.fused_step_storage(
        jnp.asarray(a).astype(jnp.bfloat16), 0.05, 0.5, -0.25, 0.1, 1.0, 1.0
    )
    got = ts.fused_step_storage(
        torch.from_numpy(a).to(torch.bfloat16), 0.05, 0.5, -0.25, 0.1, 1.0, 1.0
    )
    assert got.dtype == torch.bfloat16
    w = np.asarray(want.astype(jnp.float32))
    g = got.to(torch.float32).numpy()
    assert np.all(np.abs(g - w) <= np.abs(w) * 2.0**-7 + 1e-30)
    # f32 input passes straight through fused_step
    got32 = ts.fused_step_storage(torch.from_numpy(a), 0.05, 0.5, -0.25, 0.1, 1.0, 1.0)
    want32 = js.fused_step_storage(jnp.asarray(a), 0.05, 0.5, -0.25, 0.1, 1.0, 1.0)
    np.testing.assert_allclose(got32.numpy(), np.asarray(want32), atol=2e-6)


@pytest.mark.parametrize("dtype", ["f64", "f32", "bf16"])
@pytest.mark.parametrize("shape,frac", [((48, 32), (0.5, 0.5)), ((33, 20), (0.2, 0.9))])
def test_gaussian_hotspot_matches_jax(dtype, shape, frac):
    jdt = {"f64": jnp.float64, "f32": jnp.float32, "bf16": jnp.bfloat16}[dtype]
    nx, ny = shape
    jcfg, tcfg = make_cfgs(nx, ny, "D4", dx=0.7, dy=1.2)
    for c in (jcfg, tcfg):
        c.ic.xc_frac, c.ic.yc_frac = frac
        c.ic.A = 1.5
    want = np.asarray(ji.gaussian_hotspot(jcfg, jdt).astype(jnp.float64))
    got = ti.gaussian_hotspot(tcfg, ti.DTYPES[dtype]).to(torch.float64).numpy()
    assert got.shape == (ny, nx)
    # f64: exp() round-off; f32: a few f32 ulps of exp; bf16: the same f32
    # value rounded once, so one bf16 ulp, and XLA flushes f32 subnormals
    # (below 1.2e-38) to zero where torch keeps them.
    if dtype == "bf16":
        assert np.all(np.abs(got - want) <= np.abs(want) * 2.0**-7 + 2e-38)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12 if dtype == "f64" else 2e-6)


def test_constant_zero_and_dispatch_match_jax(tmp_path):
    jcfg, tcfg = make_cfgs(12, 8, "dev")
    for c in (jcfg, tcfg):
        c.ic.preset = "constant_zero"
    z = ti.apply_initial_condition(tcfg, torch.float32)
    assert z.shape == (8, 12) and z.dtype == torch.float32 and not z.any()
    np.testing.assert_array_equal(
        z.numpy(), np.asarray(ji.apply_initial_condition(jcfg, jnp.float32))
    )
    for c in (jcfg, tcfg):
        c.ic.preset = "nope"
    with pytest.raises(ValueError, match="Unknown IC preset"):
        ji.apply_initial_condition(jcfg)
    with pytest.raises(ValueError, match="Unknown IC preset"):
        ti.apply_initial_condition(tcfg)
    for c in (jcfg, tcfg):
        c.ic.mode = "bogus"
    with pytest.raises(ValueError, match="Unknown IC mode"):
        ti.apply_initial_condition(tcfg)


def test_from_file_matches_jax(tmp_path):
    """A snapshot file written by the JAX package restarts the port from
    its last record, like it restarts the JAX package."""
    jcfg, tcfg = make_cfgs(12, 8, "dev")
    path = str(tmp_path / "ic.nc")
    frames = [edge_parked(8, 12, seed=s) for s in (1, 2)]
    with JSnapshotWriter(path, jcfg, use_native=False) as w:
        for f in frames:
            w.write(f)
    for c in (jcfg, tcfg):
        c.ic.mode, c.ic.path = "file", path
    got = ti.apply_initial_condition(tcfg, torch.float64)
    want = np.asarray(ji.apply_initial_condition(jcfg, jnp.float64))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), frames[-1])
    tcfg.nx = 13
    with pytest.raises(ValueError, match="does not match grid"):
        ti.from_file(tcfg)


STABILITY_CASES = [
    # dx, dy, vx, vy, D, dt
    (1.0, 1.0, 0.5, -0.25, 0.05, 0.1),
    (1.0, 1.0, 0.9, 0.0, 0.15, 1.0),
    (0.5, 2.0, 0.0, 0.0, 1.0, 0.3),
    (1.0, 1.0, 0.0, 0.0, 0.0, 5.0),
    (0.25, 0.25, -3.0, 2.0, 0.0, 0.04),
]


@pytest.mark.parametrize("dx,dy,vx,vy,D_,dt", STABILITY_CASES)
def test_stability_matches_jax(dx, dy, vx, vy, D_, dt):
    assert tst.safe_dt(dx, dy, vx, vy, D_) == jst.safe_dt(dx, dy, vx, vy, D_)
    assert tst.combined_dt_limit(dx, dy, vx, vy, D_) == jst.combined_dt_limit(
        dx, dy, vx, vy, D_
    )
    assert tst.clamp_dt(dt, dx, dy, vx, vy, D_) == jst.clamp_dt(dt, dx, dy, vx, vy, D_)
    assert math.isinf(tst.safe_dt(1.0, 1.0, 0.0, 0.0, 0.0))


@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_plain_advance_200_steps_matches_jax_f64(bc_class):
    """The port's plain per-step advance against the JAX jnp advance over
    200 steps in f64, mass parked against the edges."""
    kw = dict(D=0.05, vx=0.5, vy=-0.25, dt=0.1)
    if bc_class == "dev":
        kw["vy"] = 0.0  # configs/dev.yaml's physics
    jcfg, tcfg = make_cfgs(40, 24, bc_class, kernel="jnp", **kw)
    ju, tu = both(edge_parked(24, 40, seed=5))
    want = np.asarray(jstep.build_single_device_advance(jcfg, 0.1)(200)(ju))
    adv = tstep.build_single_device_advance(tcfg, 0.1, "cpu")
    assert not adv.uses_kernel and adv.pass_count(200) == 200
    got = adv(200)(tu)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-12)


def test_plain_advance_f32_matches_jax():
    jcfg, tcfg = make_cfgs(40, 24, "dev", kernel="jnp", D=0.05, vx=0.5, dt=0.1)
    ju, tu = both(edge_parked(24, 40, seed=6), np.float32)
    want = np.asarray(jstep.build_single_device_advance(jcfg, 0.1)(200)(ju))
    got = tstep.build_single_device_advance(tcfg, 0.1, "cpu")(200)(tu)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("bc_class", ["dev", "compat"])
def test_reference_step_matches_jax(bc_class):
    jcfg, tcfg = make_cfgs(16, 12, bc_class, D=0.1, vx=-0.4, vy=0.6)
    ju, tu = both(edge_parked(12, 16, seed=9))
    np.testing.assert_allclose(
        tstep.reference_step(tu, tcfg, 0.2).numpy(),
        np.asarray(jstep.reference_step(ju, jcfg, 0.2)),
        rtol=0, atol=1e-12,
    )


def test_select_kernel_follows_the_device():
    _, tcfg = make_cfgs(16, 12, "D4")
    assert tstep.select_kernel(tcfg, "cpu") == "jnp"
    assert tstep.select_kernel(tcfg, torch.device("cuda", 0)) == "pallas"
    tcfg.kernel = "jnp"
    assert tstep.select_kernel(tcfg, "cuda:0") == "jnp"
    tcfg.kernel = "pallas_multistep"
    assert tstep.select_kernel(tcfg, "cpu") == "pallas_multistep"
