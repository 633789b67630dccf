"""K1 of the PyTorch port against the JAX package's K1, on the CPU.

On a CPU tensor the port's ``multistep_kernel_step`` takes K1's plain
version (``multistep_pass_plain``); the JAX kernel runs as its own tests run
it, in Pallas interpret mode.  Inputs are made with numpy from a seed, with
mass parked against every edge.  Tolerances follow tests/test_pallas.py: f32
``atol 2e-5`` per pass (5e-5 over a chunk of passes), f64 ``atol 1e-13``,
bf16 storage within ``8e-3`` of the f32 oracle.  The CUDA kernel itself is
compared with the plain version on the card (``chip_smoke.py``, and the
``gpu``-marked test below).

The kernels' band geometry (``band_geometry``) and their streaming
decomposition are held here too: :func:`stream_pass_emulated` runs, in
torch on the CPU, what each block of the CUDA core does (one band segment,
its window read through the kernel's source, the k levels one row apart
with the vertical operands kept per level, xm/xp from the level's previous
row, the edge bits as a per-row history and per-column bits), and the
tests hold it to the plain versions in f64.
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


_FIX_NEUMANN, _FIX_DIRICHLET = 2, 1


def stream_pass_emulated(load, row_bits, col_bits, ny, nx, k, weights, fixes,
                         bc_value=0.0):
    """One pass of the streaming core (csrc/stencil_core.cuh) emulated in
    f64, the blocks of one segment height side by side: ``load(tr, tc)``
    gives, for each block, window row ``tr[b]`` at the columns ``tc[b]`` as
    the kernel's source reads them; ``row_bits(tr)`` and ``col_bits(tc)``
    are the source's edge bits.  Asserts that every output cell is written
    by exactly one block, and returns the (ny, nx) output."""
    wc, wxm, wxp, wym, wyp = weights
    fl, fr, fb, ft = fixes
    geo = tcs.band_geometry(ny, nx, k)
    w = geo.width
    out = torch.zeros((ny, nx), dtype=torch.float64)
    writes = torch.zeros((ny, nx), dtype=torch.int64)
    lane = torch.arange(w)

    def ghost(fix, a):
        if fix == _FIX_NEUMANN:
            return a
        return torch.full_like(a, bc_value if fix == _FIX_DIRICHLET else 0.0)

    by_rows = {}  # window rows of a block -> its (x0, y0)
    for by in range(geo.segments):
        for bx in range(geo.bands):
            y0 = by * geo.rows
            by_rows.setdefault(min(geo.rows, ny - y0) + 2 * k, []).append(
                (bx * (w - 2 * k), y0))
    for rows, corners in by_rows.items():
        x0 = torch.tensor([c[0] for c in corners])
        y0 = torch.tensor([c[1] for c in corners])
        tc = x0[:, None] - k + lane[None, :]
        cb = col_bits(tc)
        x_lo, x_hi = (cb & 1).bool(), (cb & 2).bool()
        zero = torch.zeros((len(corners), 1), dtype=torch.float64)
        m1 = [torch.zeros(tc.shape, dtype=torch.float64) for _ in range(k)]
        m2 = [torch.zeros(tc.shape, dtype=torch.float64) for _ in range(k)]
        h_lo = h_hi = torch.zeros(len(corners), dtype=torch.int64)
        keep = (lane >= k) & (lane < w - k) & (tc < nx)
        for i in range(rows):
            v = load(y0 - k + i, tc)
            b = row_bits(y0 - k + i)
            h_lo, h_hi = (h_lo << 1) | (b & 1), (h_hi << 1) | ((b >> 1) & 1)
            for s in range(1, k + 1):
                # Level s's row i-s: ym, c from its registers, yp from
                # level s-1's row of this iteration, xm/xp from level
                # s-1's row of the last iteration (the shared row).  A
                # block without edge bits runs the same arithmetic.
                a, ym, yp = m1[s - 1], m2[s - 1], v
                xm, xp = torch.cat([zero, a[:, :-1]], 1), torch.cat([a[:, 1:], zero], 1)
                ym = torch.where(((h_lo >> s) & 1).bool()[:, None], ghost(fb, a), ym)
                yp = torch.where(((h_hi >> s) & 1).bool()[:, None], ghost(ft, a), yp)
                xm = torch.where(x_lo, ghost(fl, a), xm)
                xp = torch.where(x_hi, ghost(fr, a), xp)
                r = wc * a + wym * ym + wyp * yp + wxm * xm + wxp * xp
                m2[s - 1], m1[s - 1], v = a, v, r
            if i >= 2 * k:
                rr = (y0 + i - 2 * k)[:, None].expand(tc.shape)
                out[rr[keep], tc[keep]] = v[keep]
                writes.index_put_((rr[keep], tc[keep]), torch.ones_like(rr[keep]),
                                  accumulate=True)
    assert bool((writes == 1).all()), "an output cell was not written exactly once"
    return out


def wrap_source(u, fixes):
    """K1's source: the wrapped global field and its edge bits."""
    ny, nx = u.shape
    fl, fr, fb, ft = fixes

    def load(tr, tc):
        return u[(tr % ny)[:, None], tc % nx]

    def row_bits(tr):
        g = tr % ny
        return ((g == 0) & (fb != 0)).long() | (((g == ny - 1) & (ft != 0)).long() << 1)

    def col_bits(tc):
        g = tc % nx
        return ((g == 0) & (fl != 0)).long() | (((g == nx - 1) & (fr != 0)).long() << 1)

    return load, row_bits, col_bits


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


@pytest.mark.parametrize("k", [1, 2, 3, 8, 11, 16, 31, 32])
@pytest.mark.parametrize("shape", [(4096, 4096), (2048, 2048), (2009, 2001), (300, 40),
                                   (40, 300), (8, 2048), (2048, 8), (64, 128), (1, 1),
                                   (333, 241), (5000, 3)])
def test_band_geometry_covers_every_output_once(shape, k):
    """Bands of width a multiple of 32 (at most 256, more than 2k), their
    outputs tile the width exactly once, segments (a multiple of 8 rows,
    or the whole height) tile the height once; a shape with fewer than
    MIN_BLOCKS blocks has 8-row segments (or its whole height) and bands
    no narrower than 32 columns allow."""
    ny, nx = shape
    g = tcs.band_geometry(ny, nx, k)
    assert g.width % 32 == 0 and 2 * k < g.width <= tcs.MAX_BAND
    assert g.width <= -(-max(128, 16 * k) // 32) * 32 and g.width < nx + 2 * k + 32
    assert g.rows == ny or (g.rows % 8 == 0 and g.rows <= max(16, 8 * k))
    out_w = g.width - 2 * k
    assert (g.bands - 1) * out_w < nx <= g.bands * out_w
    assert (g.segments - 1) * g.rows < ny <= g.segments * g.rows
    if g.bands * g.segments < tcs.MIN_BLOCKS:
        assert g.rows <= 8 and g.width - 32 <= 2 * k
    owned = np.zeros((ny, nx), np.int64)
    for by in range(g.segments):
        for bx in range(g.bands):
            owned[by * g.rows:(by + 1) * g.rows, bx * out_w:(bx + 1) * out_w] += 1
    assert (owned == 1).all()


def test_band_geometry_of_the_main_path():
    """4096² at k = 8: 37 bands of 112 output columns, 64 segments of 64
    rows; the 2048² tile: 19 x 32; K2's one step on it: 17 x 128 segments
    of 16 rows.  Shapes with few blocks: the 512² dev grid halves its
    segments to 8 rows; K3's 8-row and 8-column bands of a 2048² tile
    narrow to one-warp bands and 8-row segments."""
    assert tcs.band_geometry(4096, 4096, 8) == (128, 64, 37, 64)
    assert tcs.band_geometry(2048, 2048, 8) == (128, 64, 19, 32)
    assert tcs.band_geometry(2048, 2048, 1) == (128, 16, 17, 128)
    assert tcs.band_geometry(512, 512, 8) == (128, 8, 5, 64)
    assert tcs.band_geometry(8, 2048, 8) == (32, 8, 128, 1)
    assert tcs.band_geometry(2048, 8, 8) == (32, 8, 1, 256)
    assert tcs.band_geometry(64, 64, 32) == (96, 8, 2, 8)
    with pytest.raises(ValueError, match="band geometry"):
        tcs.band_geometry(64, 64, 33)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("bc_class", ["one_sided_y", "one_sided_x", "both_axes", "compat"])
@pytest.mark.parametrize("shape", [(40, 300), (300, 40)])
def test_streamed_pass_matches_plain_f64(shape, bc_class, k):
    """K1's band/segment decomposition on awkward shapes (one band
    narrower than the grid's width, several bands with a ragged last one,
    ragged last segments) equals the plain pass."""
    nx, ny = shape
    _, tcfg = make_cfgs(nx, ny, bc_class, vx=-0.3, vy=0.6)
    u = torch.from_numpy(edge_parked(ny, nx, seed=k))
    fixes = [tcs._fix_code(b, tcfg.strict_reference_compat)
             for b in (tcfg.bc.left, tcfg.bc.right, tcfg.bc.bottom, tcfg.bc.top)]
    weights = tcs._stencil_weights(0.1, tcfg.D, tcfg.vx, tcfg.vy, tcfg.dx, tcfg.dy)
    got = stream_pass_emulated(*wrap_source(u, fixes), ny, nx, k, weights, fixes)
    want = tcs.multistep_pass_plain(u, tcfg, 0.1, k)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape, k", [((128, 64), 8), ((20, 70), 16), ((20, 70), 32),
                                      ((241, 19), 8)])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_streamed_pass_matches_plain_f64_every_bc(shape, k, bc_class):
    """128x64 at k = 8, bands wider than the grid at k = 16 and 32 (the
    window wraps onto itself), and nx one more than a band's output width,
    under every BC class."""
    nx, ny = shape
    _, tcfg = make_cfgs(nx, ny, bc_class)
    u = torch.from_numpy(edge_parked(ny, nx, seed=nx))
    fixes = [tcs._fix_code(b, tcfg.strict_reference_compat)
             for b in (tcfg.bc.left, tcfg.bc.right, tcfg.bc.bottom, tcfg.bc.top)]
    weights = tcs._stencil_weights(0.1, tcfg.D, tcfg.vx, tcfg.vy, tcfg.dx, tcfg.dy)
    got = stream_pass_emulated(*wrap_source(u, fixes), ny, nx, k, weights, fixes)
    want = tcs.multistep_pass_plain(u, tcfg, 0.1, k)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape, k", [((120, 96), 8), ((20, 300), 8), ((241, 333), 8),
                                      ((300, 40), 3), ((120, 96), 16), ((120, 96), 32)])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_cuda_kernel_matches_plain_on_card(cuda_device, bc_class, shape, k):
    """The streaming core's edges: a grid narrower than one band, nx one
    more than a band's output width with a ragged last segment, several
    bands, and k = 16 and 32."""
    nx, ny = shape
    _, tcfg = make_cfgs(nx, ny, bc_class)
    u = torch.from_numpy(edge_parked(ny, nx).astype(np.float32)).to(cuda_device)
    before = tcs.multistep_kernel_step.launches
    got = tcs.multistep_kernel_step(u, tcfg, 0.1, k)
    torch.cuda.synchronize(cuda_device)
    assert tcs.multistep_kernel_step.launches == before + 1
    want = tcs.multistep_pass_plain(u, tcfg, 0.1, k)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-5)
