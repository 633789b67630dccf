"""K1 of the PyTorch port against the JAX package's K1, on the CPU.

On a CPU tensor the port's ``multistep_kernel_step`` takes K1's plain
version (``multistep_pass_plain``); the JAX kernel runs as its own tests run
it, in Pallas interpret mode.  Inputs are made with numpy from a seed, with
mass parked against every edge.  Tolerances follow tests/test_pallas.py: f32
``atol 2e-5`` per pass (5e-5 over a chunk of passes), f64 ``atol 1e-13``,
bf16 storage within ``8e-3`` of the f32 oracle.  The CUDA kernel itself is
compared with the plain version on the card (``chip_smoke.py``, and the
``gpu``-marked test below).

The kernels' band geometry (``band_geometry``, and K1's
``k1_geometry``) and their streaming decomposition are held here too:
:func:`stream_pass_emulated` runs, in torch on the CPU, what each block of
the CUDA core does (one band segment, its window read through the
kernel's source, the k levels one row apart with the vertical operands
kept per level, xm/xp from the level's previous row, the edge bits as a
per-row history and per-column bits), :func:`stream_pass_wide_emulated`
what K1's wide body does (several columns a thread, the shuffles and the
warps' exchange rows, the edge selects chosen per warp), and the tests
hold both to the plain versions in f64.
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


# Classes with one fixed y side, for the wide body's select span.
Y_SIDES = {
    "bottom_only": ((P, P, D, P), False),
    "top_only": ((P, P, P, N), False),
}


def make_cfgs(nx, ny, bc_class, *, D_=0.05, vx=0.5, vy=-0.25, **kw):
    bcs, compat = {**BC_CLASSES, **Y_SIDES}[bc_class]
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


def stream_pass_wide_emulated(load, row_bits, col_bits, ny, nx, k, weights, fixes, geo,
                              bc_value=0.0, spans=None):
    """One pass of the core's wide body (``stream_band_wide``) emulated in
    f64, as :func:`stream_pass_emulated` does the one-column body, with
    ``geo`` (a :class:`K1Geometry`, ``cpt`` > 1) for the cut: ``cpt``
    window columns a thread; all KB levels run (the least of 1, 2, 4, 8
    that covers k) and the output is level k's row.  A thread's inner
    columns take their x neighbours from its own registers, its outer
    ones from the lane beside it (the shuffles), and lane 0 and lane 31
    from the exchange rows: per parity and level, each warp's first and
    last column at the core's indices (a warp's entries at 2(w+1) and
    2(w+1)+1; lane 0 reads 2w+1, lane 31 2(w+2); the pads stay zero),
    written one row earlier.  A fixed x side at a thread's first (last)
    column replaces that column's xm (xp) in every warp; the other edge
    selects run on every row in the warps whose inner columns hold a fixed
    side, and in the other warps on the rows of the block's select span
    (``tcs.select_span`` of its first and last window rows with edge
    bits): elsewhere the select-free arithmetic runs.  Asserts that every
    output cell is written by exactly one block, and returns the (ny, nx)
    output; ``spans``, if given, receives each block's (lo, hi)."""
    wc, wxm, wxp, wym, wyp = weights
    fl, fr, fb, ft = fixes
    w, cpt = geo.width, geo.cpt
    assert cpt > 1 and w % (32 * cpt) == 0 and 2 * k < w
    nw = w // (32 * cpt)
    kb = next(b for b in (1, 2, 4, 8) if b >= k)
    out = torch.zeros((ny, nx), dtype=torch.float64)
    writes = torch.zeros((ny, nx), dtype=torch.int64)
    col = torch.arange(w)
    warp_of = torch.arange(nw)
    # The exchange entries lane 0 / lane 31 of each warp write and read.
    lo_w, hi_w = 2 * (warp_of + 1), 2 * (warp_of + 1) + 1
    lo_r, hi_r = 2 * warp_of + 1, 2 * (warp_of + 2)

    def ghost(fix, a):
        if fix == _FIX_NEUMANN:
            return a
        return torch.full_like(a, bc_value if fix == _FIX_DIRICHLET else 0.0)

    by_rows = {}
    for by in range(geo.segments):
        for bx in range(geo.bands):
            y0 = by * geo.rows
            by_rows.setdefault(min(geo.rows, ny - y0) + 2 * k, []).append(
                (bx * (w - 2 * k), y0))
    for rows, corners in by_rows.items():
        nb = len(corners)
        x0 = torch.tensor([c[0] for c in corners])
        y0 = torch.tensor([c[1] for c in corners])
        tc = x0[:, None] - k + col[None, :]
        cb = col_bits(tc)
        x_lo, x_hi = (cb & 1).bool(), (cb & 2).bool()
        # The rows' bits give the block its span of select rows, the
        # columns' each warp its choice: a fixed side at a thread's first
        # (xm) or last (xp) column is taken in every warp; one at an inner
        # column makes the warp select on every row.  The rows before a
        # span hold no edge bits, so one history serves every warp.
        bit_rows = torch.stack([row_bits(y0 - k + i) for i in range(rows)]).ne(0)
        span = torch.tensor([tcs.select_span(int(r[0]), int(r[-1]), rows, kb) if len(r)
                             else tcs.select_span(rows, -1, rows, kb)
                             for r in (bit_rows[:, b].nonzero()[:, 0] for b in range(nb))])
        if spans is not None:
            spans.extend(tuple(int(v) for v in lh) for lh in span)
        j = col % cpt
        inner = (x_lo & (j != 0)[None, :]) | (x_hi & (j != cpt - 1)[None, :])
        inner_warp = inner.view(nb, nw, 32 * cpt).any(2)
        xch = torch.zeros((nb, 2, kb, 2 * (nw + 2)), dtype=torch.float64)
        q = [[torch.zeros((nb, w), dtype=torch.float64) for _ in range(3)] for _ in range(kb)]
        h_lo = h_hi = torch.zeros(nb, dtype=torch.int64)
        keep = (col >= k) & (col < w - k) & (tc < nx)

        def put_ends(par, level, r):
            lanes = r.view(nb, nw, 32, cpt)
            xch[:, par, level, lo_w] = lanes[:, :, 0, 0]
            xch[:, par, level, hi_w] = lanes[:, :, 31, cpt - 1]

        for i in range(rows):
            par, now, one, two = i & 1, i % 3, (i + 2) % 3, (i + 1) % 3
            in_span = (span[:, 0] <= i) & (i < span[:, 1])
            edge_col = (inner_warp | in_span[:, None]).repeat_interleave(32 * cpt, 1)
            q[0][now] = load(y0 - k + i, tc)
            b = row_bits(y0 - k + i)
            h_lo, h_hi = (h_lo << 1) | (b & 1), (h_hi << 1) | ((b >> 1) & 1)
            put_ends(par, 0, q[0][now])
            for s in range(1, kb + 1):
                a, ym, yp = q[s - 1][one], q[s - 1][two], q[s - 1][now]
                lanes = a.view(nb, nw, 32, cpt)
                left = torch.roll(lanes[..., cpt - 1], 1, dims=2)  # __shfl_up_sync
                right = torch.roll(lanes[..., 0], -1, dims=2)      # __shfl_down_sync
                left[:, :, 0] = xch[:, par ^ 1, s - 1, lo_r]
                right[:, :, 31] = xch[:, par ^ 1, s - 1, hi_r]
                xm = torch.cat([left[..., None], lanes[..., :-1]], 3).reshape(nb, w)
                xp = torch.cat([lanes[..., 1:], right[..., None]], 3).reshape(nb, w)
                # every warp: the ghost beyond a thread's outer columns
                xm = torch.where(x_lo & (j == 0)[None, :], ghost(fl, a), xm)
                xp = torch.where(x_hi & (j == cpt - 1)[None, :], ghost(fr, a), xp)
                r_free = wc * a + wym * ym + wyp * yp + wxm * xm + wxp * xp
                ym = torch.where(((h_lo >> s) & 1).bool()[:, None], ghost(fb, a), ym)
                yp = torch.where(((h_hi >> s) & 1).bool()[:, None], ghost(ft, a), yp)
                xm = torch.where(x_lo, ghost(fl, a), xm)
                xp = torch.where(x_hi, ghost(fr, a), xp)
                r_edge = wc * a + wym * ym + wyp * yp + wxm * xm + wxp * xp
                r = torch.where(edge_col, r_edge, r_free)
                if s < kb:
                    q[s][now] = r
                    put_ends(par, s, r)
                else:
                    last = r
            if i >= 2 * k:
                v = last if k == kb else q[k][now]
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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float64])
@pytest.mark.parametrize("k", [1, 2, 3, 4, 8, 9, 16, 32])
@pytest.mark.parametrize("shape", [(4096, 4096), (2048, 2048), (2009, 2001), (300, 40),
                                   (40, 300), (8, 2048), (2048, 8), (64, 128), (1, 1),
                                   (333, 241), (5000, 3), (512, 512)])
def test_k1_geometry_covers_every_output_once(shape, k, dtype):
    """K1's cut: up to WIDE_MAX_STEPS the wide body, whole warps of
    WIDE_COLUMNS[dtype] columns a thread, at most WIDE_THREADS threads,
    no band wider than one that holds the whole width with its halo,
    segments of at least WIDE_MIN_ROWS rows (or the whole height) and no
    more blocks than one wave of WIDE_WARPS_PER_SM warps an SM holds;
    deeper passes fall back to band_geometry's one-column cut.  The bands'
    outputs and the segments tile the field exactly once."""
    ny, nx = shape
    g = tcs.k1_geometry(ny, nx, k, dtype)
    if k > tcs.WIDE_MAX_STEPS:
        assert g == (*tcs.band_geometry(ny, nx, k), 1)
    else:
        cpt = tcs.WIDE_COLUMNS[dtype]
        assert g.cpt == cpt and g.width % (32 * cpt) == 0
        assert 2 * k < g.width <= tcs.WIDE_THREADS * cpt
        assert g.width - 32 * cpt < max(nx + 2 * k, 2 * k + 1)  # no wider than needed
        assert g.rows == ny or g.rows >= tcs.WIDE_MIN_ROWS
        # one wave of WIDE_WARPS_PER_SM warps an SM at most
        per_sm = tcs.WIDE_WARPS_PER_SM // (g.width // cpt // 32)
        assert g.bands * g.segments <= tcs.SMS * per_sm or g.segments == 1
    out_w = g.width - 2 * k
    assert g.bands == -(-nx // out_w) and g.segments == -(-ny // g.rows)
    owned = np.zeros((ny, nx), np.int64)
    for by in range(g.segments):
        for bx in range(g.bands):
            owned[by * g.rows:(by + 1) * g.rows, bx * out_w:(bx + 1) * out_w] += 1
    assert (owned == 1).all()


def test_band_geometry_of_the_main_path():
    """K1 at 4096² f32, k = 8: 18 bands of 240 output columns (64 threads
    of 4 columns), 44 segments of 94 rows, one wave of 6 blocks an SM; the
    2048² tile (K4/K5): 19 x 32; K2's one step on it: 17 x 128 segments
    of 16 rows.  Shapes with few blocks: the 512² dev grid halves its
    segments to 8 rows; K3's 8-row and 8-column bands of a 2048² tile
    narrow to one-warp bands and 8-row segments."""
    assert tcs.k1_geometry(4096, 4096, 8, torch.float32) == (256, 94, 18, 44, 4)
    assert tcs.band_geometry(2048, 2048, 8) == (128, 64, 19, 32)
    assert tcs.band_geometry(2048, 2048, 1) == (128, 16, 17, 128)
    assert tcs.band_geometry(512, 512, 8) == (128, 8, 5, 64)
    assert tcs.band_geometry(8, 2048, 8) == (32, 8, 128, 1)
    assert tcs.band_geometry(2048, 8, 8) == (32, 8, 1, 256)
    assert tcs.band_geometry(64, 64, 32) == (96, 8, 2, 8)
    with pytest.raises(ValueError, match="band geometry"):
        tcs.band_geometry(64, 64, 33)


@pytest.mark.parametrize("k, dtype, want", [
    (8, torch.float32, (256, 94, 18, 44, 4)), (4, torch.float32, (384, 86, 11, 48, 4)),
    (8, torch.bfloat16, (256, 94, 18, 44, 4)), (8, torch.float64, (192, 187, 24, 22, 2))])
def test_k1_geometry_of_the_bench_grid(k, dtype, want):
    """4096², the passes of bench_4096 (k = 8, and 4 for the remainder):
    one wave of WIDE_WARPS_PER_SM warps on each SM, the halo's share
    (1 + 2k/(width - 2k)) x (1 + 2k/rows) at most 1.33, under the
    one-column cut's 1.45 at k = 8; a block's threads in whole warps."""
    g = tcs.k1_geometry(4096, 4096, k, dtype)
    assert g == want
    threads = g.width // g.cpt
    assert threads % 32 == 0
    assert g.segments == tcs.SMS * (tcs.WIDE_WARPS_PER_SM // (threads // 32)) // g.bands
    halo = g.bands * g.width * g.segments * (g.rows + 2 * k) / 4096**2
    assert halo <= 1.33
    old = tcs.band_geometry(4096, 4096, k)
    assert halo < old.bands * old.width * old.segments * (old.rows + 2 * k) / 4096**2


@pytest.mark.parametrize("n, dtype, want", [
    (2048, torch.float32, (256, 24, 9, 86, 4)), (1024, torch.float32, (384, 12, 3, 86, 4)),
    (512, torch.float32, (128, 5, 5, 103, 4)), (256, torch.float64, (64, 4, 6, 64, 2))])
def test_k1_geometry_of_small_grids(n, dtype, want):
    """Grids too small to fill the SMs' warps at k = 8 (dev.yaml's 512²,
    parity_f64's 256²): the latency of each row's chain sets the pace, so
    the cut keeps segments short rather than SMs full.  The chosen cut
    costs least among every block size and every wave of whole blocks an
    SM, the narrower and fewer blocks winning a tie."""
    g = tcs.k1_geometry(n, n, 8, dtype)
    assert g == want
    cpt = tcs.WIDE_COLUMNS[dtype]
    every = [tcs.wide_geometry(n, n, 8, cpt, t, m)
             for t in range(32, tcs.WIDE_THREADS + 1, 32)
             for m in range(1, tcs.WIDE_WARPS_PER_SM // (t // 32) + 1)]
    assert tcs.wide_cost(g, 8) == min(tcs.wide_cost(c, 8) for c in every)
    warps = -(-g.bands * g.segments // tcs.SMS) * (g.width // cpt // 32)
    assert warps <= tcs.WIDE_WARPS_PER_SM


def test_wide_cost_weighs_warps_against_the_chain():
    """A row costs the busiest SM its warps plus WIDE_WARPS_PER_SM a wave
    (the levels' chain): halving the segments of a grid with few warps an
    SM costs less than its taller rows save, and on a full SM the taller
    segment wins over two waves of shorter ones."""
    few = tcs.K1Geometry(128, 8, 5, 64, 4)      # 320 one-warp blocks: 3 an SM
    fewer = tcs.K1Geometry(128, 16, 5, 32, 4)   # 160: 2 an SM
    assert tcs.wide_cost(few, 8) == 24 * (3 + tcs.WIDE_WARPS_PER_SM)
    assert tcs.wide_cost(few, 8) < tcs.wide_cost(fewer, 8)
    full = tcs.K1Geometry(256, 94, 18, 44, 4)   # 792 two-warp blocks: 12 warps an SM
    half = tcs.K1Geometry(256, 47, 18, 88, 4)   # 24 warps an SM
    assert tcs.wide_cost(full, 8) == 110 * 24 < tcs.wide_cost(half, 8) == 63 * (24 + 24)


def test_wide_numbers_come_from_the_core():
    """The wrapper's numbers for the wide body are the core's own
    ``constexpr int`` lines (csrc/stencil_core.cuh), read at import."""
    from climate_sim_tpu_torch.ops._build import core_constants

    core = core_constants()
    assert tcs.WIDE_COLUMNS == {torch.float32: core["WIDE_COLS"],
                                torch.bfloat16: core["WIDE_COLS"],
                                torch.float64: core["WIDE_COLS_F64"]}
    assert tcs.WIDE_THREADS == core["WIDE_THREADS"] and tcs.MAX_BAND == core["MAX_BAND"]
    assert tcs.WIDE_WARPS_PER_SM == core["WIDE_MIN_BLOCKS"] * core["WIDE_THREADS"] // 32
    assert tcs.WIDE_MAX_STEPS == core["FAST_MAX"]
    assert core["MAX_STEPS"] == tcs.MAX_STEPS_PER_PASS


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


# Cuts that put the wide body's select span at a limit: a last segment of
# 1, 2 and 3 output rows, the tallest field of one segment (its window
# wraps onto itself where the field is shorter than 2k), and windows whose
# first and last rows are a fixed side's rows.
SPAN_LIMITS = ("last1", "last2", "last3", "one_segment", "window_ends")


def span_limit_shape(limit, k, dtype, nx=300):
    """(nx, ny) with the least ny whose K1 cut at k (k1_geometry's for
    ``dtype``) puts the select span at ``limit`` (SPAN_LIMITS)."""
    for ny in range(3, 4096):
        g = tcs.k1_geometry(ny, nx, k, dtype)
        if limit.startswith("last"):
            ok = g.segments > 1 and ny - (g.segments - 1) * g.rows == int(limit[4:])
        elif limit == "one_segment":
            ok = g.segments == 1 and tcs.k1_geometry(ny + 1, nx, k, dtype).segments > 1
        else:
            ends = [[(y0 - k + j) % ny in (0, ny - 1)
                     for j in (0, min(g.rows, ny - y0) + 2 * k - 1)]
                    for y0 in range(0, ny, g.rows)]
            ok = any(e[0] for e in ends) and any(e[1] for e in ends)
        if ok:
            return nx, ny
    raise AssertionError(f"no shape puts the select span at {limit} for k={k} {dtype}")


def wide_case(nx, ny, bc_class, k, geometry, seed):
    """(emulated wide pass, plain pass) of an edge-parked f64 field:
    ``geometry`` is "f32" / "f64" (k1_geometry's cut for that dtype:
    4 / 2 columns a thread) or "3 warps" (wide_geometry's 96-thread
    blocks, 4 columns a thread, so the warps' ends meet inside a band)."""
    _, tcfg = make_cfgs(nx, ny, bc_class)
    u = torch.from_numpy(edge_parked(ny, nx, seed=seed))
    fixes = [tcs._fix_code(b, tcfg.strict_reference_compat)
             for b in (tcfg.bc.left, tcfg.bc.right, tcfg.bc.bottom, tcfg.bc.top)]
    weights = tcs._stencil_weights(0.1, tcfg.D, tcfg.vx, tcfg.vy, tcfg.dx, tcfg.dy)
    if geometry == "3 warps":
        geo = tcs.wide_geometry(ny, nx, k, 4, 96)
    else:
        geo = tcs.k1_geometry(ny, nx, k, getattr(torch, {"f32": "float32",
                                                         "f64": "float64"}[geometry]))
    assert geo.cpt > 1
    got = stream_pass_wide_emulated(*wrap_source(u, fixes), ny, nx, k, weights, fixes, geo)
    return got, tcs.multistep_pass_plain(u, tcfg, 0.1, k)


@pytest.mark.parametrize("geometry", ["f32", "f64", "3 warps"])
@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("bc_class", ["one_sided_y", "one_sided_x", "both_axes", "compat"])
@pytest.mark.parametrize("shape", [(40, 300), (300, 40)])
def test_wide_streamed_pass_matches_plain_f64(shape, bc_class, k, geometry):
    """The wide body's cut on the awkward shapes of the one-column tests:
    bands wider than the grid, ragged last bands and segments."""
    got, want = wide_case(*shape, bc_class, k, geometry, seed=k)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("geometry", ["f32", "f64", "3 warps"])
@pytest.mark.parametrize("shape, k", [((128, 64), 8), ((241, 19), 8), ((333, 70), 4),
                                      ((7, 20), 8), ((509, 45), 2), ((248, 20), 8)])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_wide_streamed_pass_matches_plain_f64_every_bc(shape, k, bc_class, geometry):
    """Every BC class on nx not a multiple of 4 (241, 333, 509, 7), bands
    wider than the grid (the window wraps onto itself) and k = 2 / 4 / 8;
    at 248 wide the right side's column is the last of a warp whose other
    columns hold no fixed side (3 warps)."""
    got, want = wide_case(*shape, bc_class, k, geometry, seed=shape[0])
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("k", [1, 3, 5, 8])
@pytest.mark.parametrize("limit", SPAN_LIMITS)
@pytest.mark.parametrize("bc_class", ["D4", "MIX2", "bottom_only", "top_only"])
def test_wide_pass_at_the_select_span_limits(bc_class, limit, k, dtype):
    """The wide body's cut (k1_geometry's for ``dtype``) where the select
    span meets a limit, under fixed bottom and top sides, one of them, and
    a live x wrap: the emulated pass equals the plain one, and its blocks'
    spans add up to what ``k1_select_rows`` counts a launch."""
    nx, ny = span_limit_shape(limit, k, dtype)
    _, tcfg = make_cfgs(nx, ny, bc_class)
    u = torch.from_numpy(edge_parked(ny, nx, seed=ny))
    fixes = [tcs._fix_code(b, tcfg.strict_reference_compat)
             for b in (tcfg.bc.left, tcfg.bc.right, tcfg.bc.bottom, tcfg.bc.top)]
    weights = tcs._stencil_weights(0.1, tcfg.D, tcfg.vx, tcfg.vy, tcfg.dx, tcfg.dy)
    geo = tcs.k1_geometry(ny, nx, k, dtype)
    spans = []
    got = stream_pass_wide_emulated(*wrap_source(u, fixes), ny, nx, k, weights, fixes, geo,
                                    spans=spans)
    torch.testing.assert_close(got, tcs.multistep_pass_plain(u, tcfg, 0.1, k), rtol=0,
                               atol=1e-12)
    assert sum(hi - lo for lo, hi in spans) == tcs.k1_select_rows(
        ny, nx, k, dtype, fixes[2], fixes[3]) > 0


@pytest.mark.parametrize("short", ["one row early", "no span"])
def test_wide_emulation_needs_the_whole_select_span(monkeypatch, short):
    """The span reaches just far enough: ended one row before KB rows past
    the last bit row (and not rounded up), or left out, the emulated pass
    no longer matches the plain one under fixed y sides."""
    _, tcfg = make_cfgs(300, 40, "D4")
    u = torch.from_numpy(edge_parked(40, 300, seed=3))
    fixes = [tcs._fix_code(b, False)
             for b in (tcfg.bc.left, tcfg.bc.right, tcfg.bc.bottom, tcfg.bc.top)]
    weights = tcs._stencil_weights(0.1, tcfg.D, tcfg.vx, tcfg.vy, tcfg.dx, tcfg.dy)
    geo = tcs.k1_geometry(40, 300, 8, torch.float64)
    want = tcs.multistep_pass_plain(u, tcfg, 0.1, 8)
    got = stream_pass_wide_emulated(*wrap_source(u, fixes), 40, 300, 8, weights, fixes, geo)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    if short == "one row early":
        rule = lambda first, last, rows, levels: (  # noqa: E731
            (first, min(rows, last + levels)) if last >= 0 else (rows, rows))
    else:
        rule = lambda first, last, rows, levels: (rows, rows)  # noqa: E731
    monkeypatch.setattr(tcs, "select_span", rule)
    cut = stream_pass_wide_emulated(*wrap_source(u, fixes), 40, 300, 8, weights, fixes, geo)
    assert float((cut - want).abs().max()) > 1e-3


def test_wide_emulation_needs_the_column_bits():
    """The x sides' selects matter to the emulation: with the column bits
    hidden from it (every warp select-free in x), a Dirichlet / Neumann
    pair of x sides no longer matches the plain pass."""
    _, tcfg = make_cfgs(300, 40, "MIX1")
    u = torch.from_numpy(edge_parked(40, 300, seed=1))
    fixes = [tcs._fix_code(b, False)
             for b in (tcfg.bc.left, tcfg.bc.right, tcfg.bc.bottom, tcfg.bc.top)]
    weights = tcs._stencil_weights(0.1, tcfg.D, tcfg.vx, tcfg.vy, tcfg.dx, tcfg.dy)
    load, row_bits, col_bits = wrap_source(u, fixes)
    geo = tcs.wide_geometry(40, 300, 8, 4, 96)
    want = tcs.multistep_pass_plain(u, tcfg, 0.1, 8)
    got = stream_pass_wide_emulated(load, row_bits, col_bits, 40, 300, 8, weights, fixes, geo)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    blind = stream_pass_wide_emulated(load, row_bits, lambda tc: torch.zeros_like(tc), 40,
                                      300, 8, weights, fixes, geo)
    assert float((blind - want).abs().max()) > 1e-3


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K1's CUDA kernel has no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64, torch.bfloat16],
                         ids=["f32", "f64", "bf16"])
@pytest.mark.parametrize("shape, k", [
    ((120, 96), 8), ((20, 300), 8), ((241, 333), 8), ((300, 40), 3), ((120, 96), 16),
    ((120, 96), 32), *((limit, k) for limit in SPAN_LIMITS for k in (1, 3, 5, 8))])
@pytest.mark.parametrize("bc_class", [*BC_CLASSES, *Y_SIDES])
def test_cuda_kernel_matches_plain_on_card(cuda_device, bc_class, shape, k, dtype):
    """The streaming core's edges: a grid narrower than one band, nx one
    more than a band's output width with a ragged last segment, several
    bands, k = 16 and 32, and the cuts that put the wide body's select span
    at a limit (SPAN_LIMITS).  f32 and f64 agree to round-off; bf16 rounds
    the kernel's and the plain version's f32 results once each, so they
    agree to one bf16 ulp of the value."""
    nx, ny = span_limit_shape(shape, k, dtype) if isinstance(shape, str) else shape
    _, tcfg = make_cfgs(nx, ny, bc_class)
    u = torch.from_numpy(edge_parked(ny, nx)).to(cuda_device, dtype)
    before = tcs.multistep_kernel_step.launches
    got = tcs.multistep_kernel_step(u, tcfg, 0.1, k)
    torch.cuda.synchronize(cuda_device)
    assert tcs.multistep_kernel_step.launches == before + 1
    want = tcs.multistep_pass_plain(u, tcfg, 0.1, k)
    assert got.dtype == dtype
    if dtype == torch.bfloat16:
        g64, w64 = got.double(), want.double()
        assert bool(((g64 - w64).abs() <= w64.abs() * 2.0**-7).all())
    else:
        atol = 1e-5 if dtype == torch.float32 else 1e-12
        torch.testing.assert_close(got, want, rtol=0, atol=atol)
