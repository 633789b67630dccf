"""K1 of the PyTorch port against the JAX package's K1, on the CPU.

On a CPU tensor the port's ``multistep_kernel_step`` takes K1's plain
version (``multistep_pass_plain``); the JAX kernel runs as its own tests run
it, in Pallas interpret mode.  Inputs are made with numpy from a seed, with
mass parked against every edge.  Tolerances follow tests/test_pallas.py: f32
``atol 2e-5`` per pass (5e-5 over a chunk of passes), f64 ``atol 1e-13``,
bf16 storage within ``8e-3`` of the f32 oracle.  The CUDA kernel itself is
compared with the plain version on the card (``chip_smoke.py``, and the
``gpu``-marked test below).
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.ops import pallas_stencil as jps
from climate_sim_tpu.ops.step import reference_step as jreference_step

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.ops import cuda_stencil as tcs
from climate_sim_tpu_torch.ops.step import build_single_device_advance

D, N, P = "dirichlet", "neumann", "periodic"
BC_CLASSES = {
    "D4": ((D, D, D, D), False),
    "N4": ((N, N, N, N), False),
    "P4": ((P, P, P, P), False),
    "MIX1": ((D, N, P, P), False),
    "MIX2": ((P, P, D, N), False),
    "one_sided_y": ((D, N, P, D), False),
    "one_sided_x": ((P, N, D, D), False),
    "both_axes": ((P, D, P, N), False),
    "compat": ((P, P, P, P), True),
}


def make_cfgs(nx, ny, bc_class, *, D_=0.05, vx=0.5, vy=-0.25, **kw):
    bcs, compat = BC_CLASSES[bc_class]
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.SimConfig(nx=nx, ny=ny, D=D_, vx=vx, vy=vy, dt=0.1, **kw)
        cfg.bc = mod.BCConfig(*(mod.bc_from_string(b) for b in bcs))
        cfg.strict_reference_compat = compat
        out.append(cfg)
    return out


def edge_parked(ny, nx, seed=0):
    rng = np.random.default_rng(seed)
    u = 0.2 * rng.random((ny, nx))
    u[:, :3] += rng.random((ny, 3))
    u[:, -3:] += rng.random((ny, 3))
    u[:3, :] += rng.random((3, nx))
    u[-3:, :] += rng.random((3, nx))
    return u


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
@pytest.mark.parametrize("shape", [(128, 64), (120, 96)])
def test_kernel_step_matches_jax_kernel(shape, bc_class, k):
    nx, ny = shape
    jcfg, tcfg = make_cfgs(nx, ny, bc_class)
    u = edge_parked(ny, nx, seed=k).astype(np.float32)
    want = np.asarray(
        jps.multistep_kernel_step(jnp.asarray(u), jcfg, 0.1, k, interpret=True)
    )
    got = tcs.multistep_kernel_step(torch.from_numpy(u), tcfg, 0.1, k)
    assert got.dtype == torch.float32 and got.shape == (ny, nx)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("bc_class", ["P4", "one_sided_y", "both_axes", "compat"])
def test_plain_pass_matches_jax_kernel_f64(bc_class):
    jcfg, tcfg = make_cfgs(128, 64, bc_class, vx=-0.3, vy=0.6)
    u = edge_parked(64, 128, seed=2)
    want = np.asarray(
        jps.multistep_kernel_step(jnp.asarray(u), jcfg, 0.1, 8, interpret=True)
    )
    got = tcs.multistep_pass_plain(torch.from_numpy(u), tcfg, 0.1, 8)
    assert got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("bc_class", ["MIX1", "one_sided_y", "one_sided_x", "compat"])
def test_advance_with_remainder_matches_jax(bc_class):
    """19 steps at k=8: two full passes and a 3-step remainder."""
    jcfg, tcfg = make_cfgs(256, 256, bc_class, vx=0.3, vy=-0.5)
    u = edge_parked(256, 256, seed=4).astype(np.float32)
    want = np.asarray(
        jps.build_multistep_advance(jcfg, 0.1, interpret=True)(19)(jnp.asarray(u))
    )
    adv = tcs.build_multistep_advance(tcfg, 0.1)
    assert adv.pass_count(19) == 3
    got = adv(19)(torch.from_numpy(u))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=5e-5)


def test_single_device_advance_routes_kernel_values_to_k1():
    _, tcfg = make_cfgs(128, 64, "MIX1", kernel="pallas")
    adv = build_single_device_advance(tcfg, 0.1, "cpu")
    assert adv.uses_kernel and adv.pass_count(11) == 6  # k = 64 // 32 = 2
    u = torch.from_numpy(edge_parked(64, 128).astype(np.float32))
    want = u
    for kk in tcs.pass_schedule(tcfg, 11):
        want = tcs.multistep_pass_plain(want, tcfg, 0.1, kk)
    np.testing.assert_array_equal(adv(11)(u).numpy(), want.numpy())


@pytest.mark.parametrize("bc_class", ["MIX1", "one_sided_y"])
def test_bf16_storage_within_bound_of_f32_oracle(bc_class):
    """bf16 storage: f32 arithmetic and one rounding per pass, so the error
    against the f32 oracle stays at single-rounding scale (the bound of
    tests/test_pallas.py), and the port agrees with the JAX kernel's bf16
    pass to one bf16 ulp of the value."""
    jcfg, tcfg = make_cfgs(256, 256, bc_class)
    u32 = edge_parked(256, 256, seed=8).astype(np.float32)
    ub = torch.from_numpy(u32).to(torch.bfloat16)
    got = tcs.multistep_kernel_step(ub, tcfg, 0.1, 8)
    assert got.dtype == torch.bfloat16
    ref = jnp.asarray(ub.to(torch.float32).numpy())
    for _ in range(8):
        ref = jreference_step(ref, jcfg, 0.1)
    g = got.to(torch.float32).numpy()
    assert np.abs(g - np.asarray(ref)).max() < 8e-3
    jb = jps.multistep_kernel_step(
        jnp.asarray(ub.to(torch.float32).numpy()).astype(jnp.bfloat16),
        jcfg, 0.1, 8, interpret=True,
    )
    w = np.asarray(jb.astype(jnp.float32))
    assert np.all(np.abs(g - w) <= np.abs(w) * 2.0**-7 + 1e-30)


def test_pick_steps_per_pass_matches_jax():
    for nx in (16, 64, 100, 256, 4096):
        for ny in (16, 96, 512):
            for spp in (0, 1, 5, 16, 32):
                for chunk in (1, 3, 8, 11, 244, 256):
                    jcfg, tcfg = make_cfgs(nx, ny, "D4", steps_per_pass=spp)
                    assert tcs.pick_steps_per_pass(tcfg, chunk) == (
                        jps.pick_steps_per_pass(jcfg, chunk)
                    ), (nx, ny, spp, chunk)


def test_bench_pass_schedule():
    """configs/bench_4096.yaml at out_every=500: each 500-step span runs as
    pieces of 256 and 244 steps, 32 + 31 passes, 126 over 1000 steps."""
    _, tcfg = make_cfgs(4096, 4096, "MIX1")
    assert tcs.pass_schedule(tcfg, 256) == [8] * 32
    assert tcs.pass_schedule(tcfg, 244) == [8] * 30 + [4]


@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_one_sided_predicates_and_weights_match_jax(bc_class):
    jcfg, tcfg = make_cfgs(64, 64, bc_class)
    for name in ("one_sided_periodic", "one_sided_periodic_x", "one_sided_periodic_y"):
        assert getattr(tcs, name)(tcfg) == getattr(jps, name)(jcfg)
    for vx, vy in ((0.5, -0.25), (0.0, 0.0), (-1.0, 0.5)):
        args = (0.1, 0.05, vx, vy, 1.0, 0.5)
        assert tcs._stencil_weights(*args) == jps._stencil_weights(*args)


def test_wrapper_checks_and_cpu_launch_count():
    _, tcfg = make_cfgs(32, 16, "D4")
    u = torch.zeros((16, 32))
    before = tcs.multistep_kernel_step.launches
    tcs.multistep_kernel_step(u, tcfg, 0.1, 2)
    assert tcs.multistep_kernel_step.launches == before  # no launch on the CPU
    with pytest.raises(ValueError, match="shape"):
        tcs.multistep_kernel_step(torch.zeros((32, 16)), tcfg, 0.1, 1)
    with pytest.raises(TypeError, match="dtype"):
        tcs.multistep_kernel_step(u.to(torch.float16), tcfg, 0.1, 1)
    with pytest.raises(ValueError, match="contiguous"):
        tcs.multistep_kernel_step(torch.zeros((32, 16)).t(), tcfg, 0.1, 1)
    for bad_k in (0, 33, 2.0):
        with pytest.raises(ValueError, match="k must be"):
            tcs.multistep_kernel_step(u, tcfg, 0.1, bad_k)
    with pytest.raises(RuntimeError, match="cuda or cpu"):
        tcs.multistep_kernel_step(u.to("meta"), tcfg, 0.1, 1)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_cuda_kernel_matches_plain_on_card(cuda_device, bc_class):
    _, tcfg = make_cfgs(120, 96, bc_class)
    u = torch.from_numpy(edge_parked(96, 120).astype(np.float32)).to(cuda_device)
    before = tcs.multistep_kernel_step.launches
    got = tcs.multistep_kernel_step(u, tcfg, 0.1, 8)
    torch.cuda.synchronize(cuda_device)
    assert tcs.multistep_kernel_step.launches == before + 1
    want = tcs.multistep_pass_plain(u, tcfg, 0.1, 8)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
