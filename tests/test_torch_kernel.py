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
warps' exchange rows, or none in one-warp blocks, the edge selects chosen
per warp, each block's
rows of the fixed y sides' selects by the kernel's rule,
:func:`select_span`, summed over a launch by :func:`k1_select_rows`),
and the tests hold both to the plain versions in f64.
"""

import sys

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


def read_window(load, row_bits, y0, tc, k, rows):
    """Window rows ``y0 - k + i``, i < ``rows``, of each block of a group
    (``y0`` its first output rows, ``tc`` its window columns), read through
    the source in one call: (rows, blocks, width) values and (rows,
    blocks) edge bits, what ``load`` and ``row_bits`` give row by row."""
    tr = (y0[None, :] - k + torch.arange(rows)[:, None]).reshape(-1)
    return (load(tr, tc.repeat(rows, 1)).reshape(rows, *tc.shape),
            row_bits(tr).reshape(rows, len(y0)))


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
        window, bits = read_window(load, row_bits, y0, tc, k, rows)
        for i in range(rows):
            v, b = window[i], bits[i]
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


def select_span(first: int, last: int, rows: int, levels: int) -> tuple:
    """The window rows ``[lo, hi)`` on which a block of K1's wide body runs
    the selects of the fixed bottom and top sides, as the kernel sets them
    (``stencil_core.cuh::band_kernel``): ``first`` and ``last`` are the
    first and last of the block's ``rows`` window rows with edge bits
    (``last`` < 0: none, and no row selects), ``levels`` the kernel's level
    count.  A bit row e reaches level s at iteration e + s, so the span runs
    from ``first`` rounded down to the loop's three-row rotation to
    ``levels`` rows past ``last``, rounded up, at most to ``rows``."""
    if last < 0:
        return rows, rows
    return first // 3 * 3, min(rows, (last + levels + 3) // 3 * 3)


def k1_select_rows(ny: int, nx: int, k: int, dtype: torch.dtype, fix_bottom: int,
                   fix_top: int) -> int:
    """The window rows that one K1 launch's blocks run on the copy of the
    loop with the selects because a bottom or top side is fixed (side codes
    ``fix_bottom``, ``fix_top``; 0 is live periodic), summed over the
    blocks: :func:`select_span` on each block of ``k1_geometry``'s cut,
    and on the one-column body (k > WIDE_MAX_STEPS) every window row of a
    block whose window holds a fixed side's row.  Rows that a warp runs
    with selects because of a fixed x side are not counted."""
    if not (fix_bottom or fix_top):
        return 0
    g = tcs.k1_geometry(ny, nx, k, dtype)
    levels = 1 << (k - 1).bit_length()
    total = 0
    for y0 in range(0, ny, g.rows):
        rows = min(g.rows, ny - y0) + 2 * k
        bit_rows = [j for j in range(rows) if (fix_bottom and (y0 - k + j) % ny == 0)
                    or (fix_top and (y0 - k + j) % ny == ny - 1)]
        if not bit_rows:
            continue
        if g.cpt == 1:
            total += rows
        else:
            lo, hi = select_span(bit_rows[0], bit_rows[-1], rows, levels)
            total += hi - lo
    return total * g.bands


def stream_pass_wide_emulated(load, row_bits, col_bits, ny, nx, k, weights, fixes, geo,
                              bc_value=0.0, spans=None, outer=None):
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
    written one row earlier.  A cut of one-warp blocks (``geo.one_warp``)
    has no exchange rows: lane 0 and lane 31 take what the shuffles give
    them, their own outer column's value, or ``outer`` where given (a
    band's outer operands reach only the columns it discards).  A fixed x
    side at a thread's first (last)
    column replaces that column's xm (xp) in every warp; the other edge
    selects run on every row in the warps whose inner columns hold a fixed
    side, and in the other warps on the rows of the block's select span
    (:func:`select_span` of its first and last window rows with edge
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
        window, bits = read_window(load, row_bits, y0, tc, k, rows)
        bit_rows = bits.ne(0)
        span = torch.tensor([select_span(int(r[0]), int(r[-1]), rows, kb) if len(r)
                             else select_span(rows, -1, rows, kb)
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
            q[0][now], b = window[i], bits[i]
            h_lo, h_hi = (h_lo << 1) | (b & 1), (h_hi << 1) | ((b >> 1) & 1)
            put_ends(par, 0, q[0][now])
            for s in range(1, kb + 1):
                a, ym, yp = q[s - 1][one], q[s - 1][two], q[s - 1][now]
                lanes = a.view(nb, nw, 32, cpt)
                left = torch.roll(lanes[..., cpt - 1], 1, dims=2)  # __shfl_up_sync
                right = torch.roll(lanes[..., 0], -1, dims=2)      # __shfl_down_sync
                if not geo.one_warp:
                    left[:, :, 0] = xch[:, par ^ 1, s - 1, lo_r]
                    right[:, :, 31] = xch[:, par ^ 1, s - 1, hi_r]
                elif outer is not None:
                    left[:, :, 0] = right[:, :, 31] = outer
                else:  # a lane's own value, as the shuffles give lanes 0 and 31
                    left[:, :, 0], right[:, :, 31] = lanes[:, :, 0, cpt - 1], lanes[:, :, 31, 0]
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
    """The side codes carry the JAX package's one-sided predicates (an axis
    with exactly one live periodic side, FIX_NONE), and the weights are the
    JAX package's, bit for bit."""
    jcfg, tcfg = make_cfgs(64, 64, bc_class)
    fl, fr, fb, ft = tcs.stencil_constants(tcfg, 0.1).fixes
    x = (fl == tcs.FIX_NONE) != (fr == tcs.FIX_NONE)
    y = (fb == tcs.FIX_NONE) != (ft == tcs.FIX_NONE)
    assert (x, y, x or y) == (jps.one_sided_periodic_x(jcfg), jps.one_sided_periodic_y(jcfg),
                              jps.one_sided_periodic(jcfg))
    tcfg.dy = 0.5
    for vx, vy in ((0.5, -0.25), (0.0, 0.0), (-1.0, 0.5)):
        tcfg.vx, tcfg.vy = vx, vy
        assert tcs.stencil_constants(tcfg, 0.1).weights == jps._stencil_weights(
            0.1, 0.05, vx, vy, 1.0, 0.5)


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
    """K1 at 4096² f32, k = 8: 37 bands of 112 output columns (one warp of
    4 columns a thread), 42 segments of 98 rows, one wave of 12 blocks an
    SM; the 2048² tile (K4/K5): 19 x 32; K2's one step on it: 17 x 128
    segments of 16 rows.  Shapes with few blocks: the 512² dev grid halves
    its segments to 8 rows; K3's 8-row and 8-column bands of a 2048² tile
    narrow to one-warp bands and 8-row segments."""
    assert tcs.k1_geometry(4096, 4096, 8, torch.float32) == (128, 98, 37, 42, 4)
    assert tcs.band_geometry(2048, 2048, 8) == (128, 64, 19, 32)
    assert tcs.band_geometry(2048, 2048, 1) == (128, 16, 17, 128)
    assert tcs.band_geometry(512, 512, 8) == (128, 8, 5, 64)
    assert tcs.band_geometry(8, 2048, 8) == (32, 8, 128, 1)
    assert tcs.band_geometry(2048, 8, 8) == (32, 8, 1, 256)
    assert tcs.band_geometry(64, 64, 32) == (96, 8, 2, 8)
    with pytest.raises(ValueError, match="band geometry"):
        tcs.band_geometry(64, 64, 33)


@pytest.mark.parametrize("k, dtype, want", [
    (8, torch.float32, ((128, 98, 37, 42, 4), 1.3516)),
    (4, torch.float32, ((384, 86, 11, 48, 4), 1.1360)),
    (8, torch.bfloat16, ((128, 98, 37, 42, 4), 1.3516)),
    (8, torch.float64, ((64, 228, 86, 18, 2), 1.4409)),
    (4, torch.float64, ((256, 179, 17, 23, 2), 1.1157))])
def test_k1_geometry_of_the_bench_grid(k, dtype, want):
    """4096², the passes of bench_4096 (k = 8, and 4 for the remainder) and
    of the parity run, as (cut, halo share): at k = 8 one-warp bands (their
    row costs a wider block's ONE_WARP_ISSUE / ONE_WARP_CHAIN tenths), at
    k = 4 wider blocks (below ONE_WARP_MIN_STEPS a one-warp row costs a
    block's, and the wider band's smaller halo wins); each in one wave of
    WIDE_WARPS_PER_SM warps on each SM, its halo's share (1 + 2k/(width -
    2k)) x (1 + 2k/rows) pinned and under the one-column cut's; the least
    cost among the cuts tried."""
    cut, share = want
    g = tcs.k1_geometry(4096, 4096, k, dtype)
    assert g == cut and g.one_warp == (k >= tcs.ONE_WARP_MIN_STEPS)
    threads = g.width // g.cpt
    assert threads % 32 == 0
    assert g.segments == tcs.SMS * (tcs.WIDE_WARPS_PER_SM // (threads // 32)) // g.bands
    assert tcs.wide_cost(g, k) == min(tcs.wide_cost(c, k)
                                      for c in tcs.wide_cuts(4096, 4096, k, dtype))
    halo = g.bands * g.width * g.segments * (g.rows + 2 * k) / 4096**2
    assert halo == pytest.approx(share, abs=5e-5)
    old = tcs.band_geometry(4096, 4096, k)
    assert halo < old.bands * old.width * old.segments * (old.rows + 2 * k) / 4096**2


@pytest.mark.parametrize("n, dtype, want", [
    (2048, torch.float32, (128, 25, 19, 82, 4)), (1024, torch.float32, (128, 10, 10, 103, 4)),
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
    (the levels' chain), in tenths of a block warp's issue, a one-warp
    block's warp and chain ONE_WARP_ISSUE and ONE_WARP_CHAIN tenths:
    halving the segments of a grid with few warps an SM costs less than its
    taller rows save; on a full SM the taller segment wins over two waves of
    shorter ones; and at 4096² the one-warp cut, its halo 1.35 against 1.33,
    costs less than two-warp blocks; at k = 4, below ONE_WARP_MIN_STEPS,
    a one-warp row costs a block's, and the 4096² cut of three-warp blocks
    (halo 1.14) costs less than the one-warp one (1.20)."""
    w = tcs.WIDE_WARPS_PER_SM
    few = tcs.K1Geometry(128, 8, 5, 64, 4)      # 320 one-warp blocks: 3 an SM
    fewer = tcs.K1Geometry(128, 16, 5, 32, 4)   # 160: 2 an SM
    assert few.one_warp and tcs.wide_cost(few, 8) == 24 * (3 * tcs.ONE_WARP_ISSUE
                                                           + w * tcs.ONE_WARP_CHAIN)
    assert tcs.wide_cost(few, 8) < tcs.wide_cost(fewer, 8)
    full = tcs.K1Geometry(256, 94, 18, 44, 4)   # 792 two-warp blocks: 12 warps an SM
    half = tcs.K1Geometry(256, 47, 18, 88, 4)   # 24 warps an SM
    assert not full.one_warp
    assert tcs.wide_cost(full, 8) == 110 * 240 < tcs.wide_cost(half, 8) == 63 * (240 + 240)
    one = tcs.K1Geometry(128, 98, 37, 42, 4)    # 1554 one-warp blocks: 12 an SM
    assert tcs.wide_cost(one, 8) == 114 * (12 * tcs.ONE_WARP_ISSUE + w * tcs.ONE_WARP_CHAIN)
    assert tcs.wide_cost(one, 8) < tcs.wide_cost(full, 8)
    assert tcs.ONE_WARP_MIN_STEPS == 5
    one4 = tcs.K1Geometry(128, 92, 35, 45, 4)   # 1575 one-warp blocks: 12 an SM
    three = tcs.K1Geometry(384, 86, 11, 48, 4)  # 528 three-warp blocks: 12 warps an SM
    assert tcs.wide_cost(one4, 4) == 100 * 240 > tcs.wide_cost(three, 4) == 94 * 240


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
    weights, fixes = tcs.stencil_constants(tcfg, 0.1)
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
    weights, fixes = tcs.stencil_constants(tcfg, 0.1)
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
    weights, fixes = tcs.stencil_constants(tcfg, 0.1)
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
    spans add up to what :func:`k1_select_rows` counts a launch."""
    nx, ny = span_limit_shape(limit, k, dtype)
    _, tcfg = make_cfgs(nx, ny, bc_class)
    u = torch.from_numpy(edge_parked(ny, nx, seed=ny))
    weights, fixes = tcs.stencil_constants(tcfg, 0.1)
    geo = tcs.k1_geometry(ny, nx, k, dtype)
    spans = []
    got = stream_pass_wide_emulated(*wrap_source(u, fixes), ny, nx, k, weights, fixes, geo,
                                    spans=spans)
    torch.testing.assert_close(got, tcs.multistep_pass_plain(u, tcfg, 0.1, k), rtol=0,
                               atol=1e-12)
    assert sum(hi - lo for lo, hi in spans) == k1_select_rows(
        ny, nx, k, dtype, fixes[2], fixes[3]) > 0


@pytest.mark.parametrize("short", ["one row early", "no span"])
def test_wide_emulation_needs_the_whole_select_span(monkeypatch, short):
    """The span reaches just far enough: ended one row before KB rows past
    the last bit row (and not rounded up), or left out, the emulated pass
    no longer matches the plain one under fixed y sides."""
    _, tcfg = make_cfgs(300, 40, "D4")
    u = torch.from_numpy(edge_parked(40, 300, seed=3))
    weights, fixes = tcs.stencil_constants(tcfg, 0.1)
    geo = tcs.k1_geometry(40, 300, 8, torch.float64)
    want = tcs.multistep_pass_plain(u, tcfg, 0.1, 8)
    got = stream_pass_wide_emulated(*wrap_source(u, fixes), 40, 300, 8, weights, fixes, geo)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    if short == "one row early":
        rule = lambda first, last, rows, levels: (  # noqa: E731
            (first, min(rows, last + levels)) if last >= 0 else (rows, rows))
    else:
        rule = lambda first, last, rows, levels: (rows, rows)  # noqa: E731
    monkeypatch.setattr(sys.modules[__name__], "select_span", rule)
    cut = stream_pass_wide_emulated(*wrap_source(u, fixes), 40, 300, 8, weights, fixes, geo)
    assert float((cut - want).abs().max()) > 1e-3


def test_wide_emulation_needs_the_column_bits():
    """The x sides' selects matter to the emulation: with the column bits
    hidden from it (every warp select-free in x), a Dirichlet / Neumann
    pair of x sides no longer matches the plain pass."""
    _, tcfg = make_cfgs(300, 40, "MIX1")
    u = torch.from_numpy(edge_parked(40, 300, seed=1))
    weights, fixes = tcs.stencil_constants(tcfg, 0.1)
    load, row_bits, col_bits = wrap_source(u, fixes)
    geo = tcs.wide_geometry(40, 300, 8, 4, 96)
    want = tcs.multistep_pass_plain(u, tcfg, 0.1, 8)
    got = stream_pass_wide_emulated(load, row_bits, col_bits, 40, 300, 8, weights, fixes, geo)
    torch.testing.assert_close(got, want, rtol=0, atol=1e-12)
    blind = stream_pass_wide_emulated(load, row_bits, lambda tc: torch.zeros_like(tc), 40,
                                      300, 8, weights, fixes, geo)
    assert float((blind - want).abs().max()) > 1e-3


# The output columns of a one-warp band (32 threads, 4 columns a thread in
# f32 and bf16, 2 in f64) at k = 8 and 4, by (columns a thread, k).
ONE_WARP_OUT = {(4, 8): 112, (4, 4): 120, (2, 8): 48, (2, 4): 56}


@pytest.mark.parametrize("sign", [-1, 1], ids=["minus1", "plus1"])
@pytest.mark.parametrize("m", [1, 2, 3])
@pytest.mark.parametrize("cpt, k", list(ONE_WARP_OUT),
                         ids=["c4-k8", "c4-k4", "c2-k8", "c2-k4"])
@pytest.mark.parametrize("bc_class", ["MIX1", "P4", "D4"])
def test_one_warp_pass_on_ragged_widths(bc_class, cpt, k, m, sign):
    """The one-warp cut (wide_geometry's 32-thread blocks) on widths one
    off a whole number of its bands' outputs, 112 m +- 1 at k = 8 and
    120 m +- 1 at k = 4 with 4 columns a thread (48 m +- 1 and 56 m +- 1
    with 2): a last band of one output column, or one short; the fixed x
    sides at a thread's first, last or an inner column."""
    nx, ny = ONE_WARP_OUT[(cpt, k)] * m + sign, 37
    _, tcfg = make_cfgs(nx, ny, bc_class)
    u = torch.from_numpy(edge_parked(ny, nx, seed=nx))
    weights, fixes = tcs.stencil_constants(tcfg, 0.1)
    geo = tcs.wide_geometry(ny, nx, k, cpt, 32)
    assert geo.one_warp and geo.bands == m + (sign > 0)
    got = stream_pass_wide_emulated(*wrap_source(u, fixes), ny, nx, k, weights, fixes, geo)
    torch.testing.assert_close(got, tcs.multistep_pass_plain(u, tcfg, 0.1, k), rtol=0,
                               atol=1e-12)


@pytest.mark.parametrize("outer", [0.0, 1e6, float("nan")], ids=["zero", "large", "nan"])
@pytest.mark.parametrize("bc_class", ["MIX1", "D4", "P4"])
def test_one_warp_band_discards_its_outer_operands(bc_class, outer):
    """Whatever lane 0's xm and lane 31's xp are beyond a one-warp band (the
    kernel's shuffles give each its own outer column; here zero, a large
    value or NaN), they reach only the k columns at each side that the band
    does not write: the emulated pass equals the plain one."""
    nx, ny = 300, 40
    _, tcfg = make_cfgs(nx, ny, bc_class)
    u = torch.from_numpy(edge_parked(ny, nx, seed=5))
    weights, fixes = tcs.stencil_constants(tcfg, 0.1)
    geo = tcs.wide_geometry(ny, nx, 8, 4, 32)
    assert geo.one_warp and geo.bands > 1
    got = stream_pass_wide_emulated(*wrap_source(u, fixes), ny, nx, 8, weights, fixes, geo,
                                    outer=outer)
    torch.testing.assert_close(got, tcs.multistep_pass_plain(u, tcfg, 0.1, 8), rtol=0,
                               atol=1e-12)


DTYPES = [torch.float32, torch.float64, torch.bfloat16]
# (bottom, top) side codes of a fixed bottom, top, and both y sides.
Y_CODES = {"bottom": (1, 0), "top": (0, 2), "both": (3, 1)}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("x_sides", [(D, N), (P, P), (N, D)])
def test_k1_select_rows_zero_with_y_periodic(dtype, x_sides):
    """No fixed bottom or top side, no row selects, whatever the x sides,
    the cut and the body."""
    for shape in ((4096, 4096), (40, 100), (7, 300), (333, 241)):
        for k in (1, 3, 4, 8, 9, 16, 32):
            assert k1_select_rows(*shape, k, dtype, 0, 0) == 0


@pytest.mark.parametrize("dtype, k, bottom, top, both", [
    (torch.float64, 8, 1720, 1978, 1978), (torch.float64, 4, 170, 221, 221),
    (torch.float32, 8, 814, 814, 814), (torch.float32, 4, 121, 121, 121),
    (torch.bfloat16, 8, 814, 814, 814)])
def test_k1_select_rows_of_the_parity_grid(dtype, k, bottom, top, both):
    """4096²: f64 at k = 8 (2 columns a thread, one warp, 86 bands, 18
    segments of 228 rows) runs 86 bands x (12 + 11) rows with both y sides
    fixed: the first segment's rows 6-17 (row ny - 1 wraps to window row 7,
    row 0 is window row 8), the last's rows 225-235 of 236 (row ny - 1 at
    227, row 0 at 228); the block-wide rule would have run 86 x (244 + 236)
    = 41280.  A bottom side alone ends the first span at 8 + 8 + 1 rounded
    up as well, and starts the last at 228: 86 x (12 + 8).  f32 and bf16
    share their cut."""
    assert k1_select_rows(4096, 4096, k, dtype, 1, 0) == bottom
    assert k1_select_rows(4096, 4096, k, dtype, 0, 2) == top
    assert k1_select_rows(4096, 4096, k, dtype, 1, 1) == both


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("fixed", list(Y_CODES))
def test_k1_select_rows_follow_the_rule(dtype, fixed):
    """The rule on each block of the cut: from the first window row of a
    fixed side, rounded down to a multiple of 3, to KB + 1 rows past the
    last, rounded up, at most the window; the one-column body (k > 8)
    counts every window row of a block that holds a fixed side's row."""
    fb, ft = Y_CODES[fixed]
    for ny, nx in ((40, 100), (333, 241), (7, 300), (4096, 4096)):
        for k in (1, 2, 3, 5, 8, 9, 16):
            g = tcs.k1_geometry(ny, nx, k, dtype)
            kb = next(b for b in (1, 2, 4, 8, 16, 32) if b >= k)
            want = 0
            for y0 in range(0, ny, g.rows):
                rows = min(g.rows, ny - y0) + 2 * k
                bits = [j for j in range(rows) if (fb and (y0 - k + j) % ny == 0)
                        or (ft and (y0 - k + j) % ny == ny - 1)]
                if bits and g.cpt == 1:
                    want += rows
                elif bits:
                    want += min(rows, -(-(bits[-1] + kb + 1) // 3) * 3) - bits[0] // 3 * 3
            assert k1_select_rows(ny, nx, k, dtype, fb, ft) == want * g.bands > 0


@pytest.mark.parametrize("dtype, cuts", [
    (torch.float32, {8: (128, 4, 1, 10, 4), 4: (128, 4, 1, 10, 4), 16: (64, 8, 4, 5, 1)}),
    (torch.float64, {8: (64, 4, 3, 10, 2), 4: (64, 4, 2, 10, 2), 16: (64, 8, 4, 5, 1)}),
    (torch.bfloat16, {8: (128, 4, 1, 10, 4), 4: (128, 4, 1, 10, 4), 16: (64, 8, 4, 5, 1)})],
    ids=["f32", "f64", "bf16"])
def test_k1_geometry_pins_the_cut_of_a_small_grid(dtype, cuts):
    """40x100 at k = 8, 4 and 16, as (width, rows, bands, segments, cpt):
    the wide body (WIDE_COLUMNS[dtype] columns a thread) up to
    WIDE_MAX_STEPS, the one-column body beyond; f32 and bf16 share their
    cut."""
    for k, want in cuts.items():
        g = tcs.k1_geometry(40, 100, k, dtype)
        assert g == want and (g.cpt > 1) == (k <= tcs.WIDE_MAX_STEPS)


def test_k1_geometry_of_the_parity_grid():
    """4096² f64, as the parity cell runs it: two columns a thread, at
    k = 8 in one-warp blocks, 86 bands and 18 segments of 228 rows, at
    k = 4 in blocks of 128 threads, 17 bands and 23 segments of 179 rows."""
    assert tcs.k1_geometry(4096, 4096, 8, torch.float64) == (64, 228, 86, 18, 2)
    assert tcs.k1_geometry(4096, 4096, 4, torch.float64) == (256, 179, 17, 23, 2)


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


# Where the fixed x sides' columns lie in a one-warp cut: each where the
# kernel replaces a thread's outer neighbour (the left side at a thread's
# first column, the right at its last: the copy with the x sides' code), one
# elsewhere (the copy with every select), one in lane 0 or lane 31 (whose
# outer operands lie beyond the band), or a last band of one output column.
PLACEMENTS = ("outer", "inner", "lane_ends", "ragged")


def fixed_columns(nx, k, cpt):
    """(lane, column of the thread, side) of each fixed x side's column in
    the windows of the one-warp cut of an nx-wide field (side 0: x = 0,
    the left; 1: x = nx - 1, the right), over every band."""
    width = 32 * cpt
    out = set()
    for b in range(-(-nx // (width - 2 * k))):
        for side, x in ((0, 0), (1, nx - 1)):
            # the window columns c with (first + c) % nx == x
            for c in range((x - (b * (width - 2 * k) - k)) % nx, width, nx):
                out.add((c // cpt, c % cpt, side))
    return out


def one_warp_shape(place, k, cpt, ny=45):
    """(nx, ny) with the least nx wider than one band whose one-warp cut at
    k, cpt columns a thread, puts the fixed x sides' columns at ``place``
    (PLACEMENTS); None where no width does."""
    width = 32 * cpt
    for nx in range(width + 1, 4 * width):
        cols = fixed_columns(nx, k, cpt)
        outer = [(j, side) in ((0, 0), (cpt - 1, 1)) for _, j, side in cols]
        if {"outer": all(outer), "inner": not all(outer),
                "lane_ends": any(lane in (0, 31) for lane, _, _ in cols),
                "ragged": nx % (width - 2 * k) == 1}[place]:
            return nx, ny
    return None


ONE_WARP_CARD_CASES = [
    (place, k, dtype) for place in PLACEMENTS for k in (1, 2, 4, 8)
    for dtype in (torch.float32, torch.float64, torch.bfloat16)
    if one_warp_shape(place, k, tcs.WIDE_COLUMNS[dtype]) is not None]


def k1_launch_at(u, cfg, k, geo):
    """K1's C entry on ``u`` with the cut ``geo`` (not k1_geometry's)."""
    from climate_sim_tpu_torch.ops import _build

    args = tcs.k1_arguments(cfg.ny, cfg.nx, k, u.dtype, tcs.stencil_constants(cfg, 0.1), geo)
    out = torch.empty_like(u)
    err = _build.load_library().lib.climate_multistep_stencil(
        u.data_ptr(), out.data_ptr(), *args, torch.cuda.current_stream(u.device).cuda_stream)
    assert err == 0, f"K1 at {geo}: CUDA error {err}"
    return out


@pytest.mark.gpu
@pytest.mark.parametrize("place, k, dtype", ONE_WARP_CARD_CASES)
@pytest.mark.parametrize("bc_class", ["MIX1", "MIX2", "D4"])
def test_one_warp_body_matches_the_block_body_on_card(cuda_device, bc_class, place, k, dtype):
    """The wide body's one-warp instantiation (32-thread blocks) against its
    block instantiation (64-thread blocks) on the same input: bit for bit,
    with the fixed x sides' columns where the one-warp block replaces an
    outer neighbour, elsewhere in a thread, in lane 0 or 31 (MIX1, D4), x
    periodic (MIX2), and a last band of one output column; and the one-warp
    pass against the plain version, as the core's tests hold it."""
    cpt = tcs.WIDE_COLUMNS[dtype]
    nx, ny = one_warp_shape(place, k, cpt)
    _, tcfg = make_cfgs(nx, ny, bc_class)
    u = torch.from_numpy(edge_parked(ny, nx, seed=nx)).to(cuda_device, dtype)
    warp = tcs.wide_geometry(ny, nx, k, cpt, 32)
    block = tcs.wide_geometry(ny, nx, k, cpt, 64)
    assert warp.one_warp and not block.one_warp
    got, want = k1_launch_at(u, tcfg, k, warp), k1_launch_at(u, tcfg, k, block)
    torch.cuda.synchronize(cuda_device)
    assert torch.equal(got, want)
    plain = tcs.multistep_pass_plain(u, tcfg, 0.1, k)
    if dtype == torch.bfloat16:
        assert bool(((got.double() - plain.double()).abs() <= plain.double().abs() * 2.0**-7)
                    .all())
    else:
        torch.testing.assert_close(got, plain, rtol=0,
                                   atol=1e-5 if dtype == torch.float32 else 1e-12)


@pytest.mark.gpu
def test_k1_warp_bands_count_the_one_warp_launches_on_card(cuda_device):
    """A 4096² f32 job of bench_4096's physics (100 steps: twelve 8-step
    passes and one of 4) under tracing: ``k1.warp_bands`` counts the twelve
    8-step launches, which run in one-warp blocks, and not the 4-step one,
    which runs in blocks of three warps."""
    from climate_sim_tpu_torch.runtime import tracing

    cfg = make_cfgs(4096, 4096, "MIX1")[1]
    u = torch.from_numpy(edge_parked(512, 512)).to(cuda_device, torch.float32)
    u = u.repeat(8, 8).contiguous()
    schedule = tcs.pass_schedule(cfg, 100)
    assert schedule == [8] * 12 + [4]
    before = tcs.multistep_kernel_step.launches
    with tracing.collect() as rec:
        for kk in schedule:
            u = tcs.multistep_kernel_step(u, cfg, 0.1, kk)
    torch.cuda.synchronize(cuda_device)
    assert tcs.multistep_kernel_step.launches == before + len(schedule)
    assert rec.counters.get("k1.warp_bands", 0) == 12
