"""K2, K3 and K4 of the PyTorch port against the JAX package's kernels, on
the CPU.

On a CPU tensor each port wrapper takes its kernel's plain version; the JAX
kernels run in Pallas interpret mode, as the JAX package's own tests run
them.  Inputs are made with numpy from a seed.  Tolerances follow
tests/test_torch_kernel.py: f64 ``atol 1e-13``, f32 ``atol 2e-5`` per pass,
bf16 storage within ``8e-3`` of the f32 oracle and within one bf16 ulp of
the JAX kernel.  Edge flags cover the tiles of 1x1, 2x2, 1x4 and 4x1
meshes.  The JAX kernels take a halo depth rounded to their sublane tile
(8, or 16 in bf16); the port takes the same inputs.  The CUDA kernels
themselves are compared with the plain versions on the card
(``chip_smoke.py`` and the ``gpu``-marked tests below).

The tile sources of the streaming core (a padded region by row stride,
the tile and its two halo slabs) are emulated after the CUDA source and
run through ``test_torch_kernel.stream_pass_emulated``, held to the plain
versions in f64.
"""

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from climate_sim_tpu.ops import pallas_stencil as jps
from climate_sim_tpu.ops.step import reference_step as jreference_step

from climate_sim_tpu_torch.ops import cuda_sharded as tsh
from climate_sim_tpu_torch.ops.step import make_interior_step
from climate_sim_tpu_torch.parallel.mesh import make_mesh

from climate_sim_tpu_torch.ops.cuda_stencil import stencil_constants

from test_torch_kernel import BC_CLASSES, make_cfgs, read_window, stream_pass_emulated


def mesh_flag_sets():
    """The edge flags of every tile of 1x1, 2x2, 1x4 and 4x1 meshes."""
    out = []
    for px, py in ((1, 1), (2, 2), (1, 4), (4, 1)):
        mesh = make_mesh(px, py, ["cpu"] * (px * py))
        for y in range(py):
            for x in range(px):
                f = mesh.edge_flags(y, x)
                if f not in out:
                    out.append(f)
    return out


FLAG_SETS = mesh_flag_sets()
# (ny_r, nx_r) per pass size: ragged widths and heights for K3.
REGION_SHAPES = {1: (64, 128), 3: (40, 120), 8: (96, 64)}


def window(ny, nx, kh, dtype, seed):
    """A random padded window (ny+2kh, nx+2kh), mass parked on its edges."""
    rng = np.random.default_rng(seed)
    w = 0.2 * rng.random((ny + 2 * kh, nx + 2 * kh))
    w[:, : 2 * kh] += rng.random((ny + 2 * kh, 2 * kh))
    w[-2 * kh:, :] += rng.random((2 * kh, nx + 2 * kh))
    return w.astype(dtype)


def jax_slabs(w, kh):
    """The same ghost strips in the JAX slab layout: xhalo (my, 256) with
    the left block right-aligned at column 128, the right block after it;
    yhalo (2kh, mx+256), the x-extended rows at column 128-kh."""
    my, mx = w.shape[0] - 2 * kh, w.shape[1] - 2 * kh
    xh = np.zeros((my, 256), w.dtype)
    xh[:, 128 - kh:128] = w[kh:-kh, :kh]
    xh[:, 128:128 + kh] = w[kh:-kh, -kh:]
    yh = np.zeros((2 * kh, mx + 256), w.dtype)
    yh[:kh, 128 - kh:128 + mx + kh] = w[:kh]
    yh[kh:, 128 - kh:128 + mx + kh] = w[-kh:]
    return w[kh:-kh, kh:-kh], xh, yh


def port_slabs(w, kh):
    """The port's compact layout: tile, xhalo (my, 2kh), yhalo
    (2kh, mx+2kh)."""
    t = torch.from_numpy(w)
    tile = t[kh:-kh, kh:-kh].contiguous()
    xh = torch.cat([t[kh:-kh, :kh], t[kh:-kh, -kh:]], dim=1).contiguous()
    yh = torch.cat([t[:kh], t[-kh:]], dim=0).contiguous()
    return tile, xh, yh


def k3_both(w, jcfg, tcfg, k, ny, nx, flags, flagged, kh):
    want = np.asarray(jps.tile_region_multistep(
        jnp.asarray(w), jnp.asarray(flags, jnp.int32), jcfg, 0.1, k, ny, nx,
        flagged, interpret=True, khalo=kh,
    ))
    got = tsh.tile_region_multistep(
        torch.from_numpy(w), flags, tcfg, 0.1, k, ny, nx, flagged, khalo=kh,
    )
    return got, want


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_k3_plain_matches_jax_kernel_f64(bc_class, k):
    """K3 flagged under every mesh tile's edge flags, and unflagged."""
    ny, nx = REGION_SHAPES[k]
    jcfg, tcfg = make_cfgs(nx, ny, bc_class, vx=-0.3 if k == 3 else 0.5)
    w = window(ny, nx, 8, np.float64, seed=k)
    for flags in FLAG_SETS:
        got, want = k3_both(w, jcfg, tcfg, k, ny, nx, flags, True, 8)
        assert got.dtype == torch.float64 and got.shape == (ny, nx)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13,
                                   err_msg=f"flags {flags}")
    got, want = k3_both(w, jcfg, tcfg, k, ny, nx, (1, 1, 1, 1), False, 8)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13)


@pytest.mark.parametrize("bc_class", ["D4", "MIX1", "one_sided_y", "one_sided_x", "compat"])
def test_k3_plain_matches_jax_kernel_f32(bc_class):
    for k in (1, 3, 8):
        ny, nx = REGION_SHAPES[k]
        jcfg, tcfg = make_cfgs(nx, ny, bc_class)
        w = window(ny, nx, 8, np.float32, seed=10 + k)
        for flags in FLAG_SETS[:5]:
            got, want = k3_both(w, jcfg, tcfg, k, ny, nx, flags, True, 8)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("k", [1, 3, 8])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_k4_plain_matches_jax_kernel_f64(bc_class, k):
    """The same random ghost strips, packed into the JAX slab layout and
    into the port's, under every mesh tile's edge flags."""
    my, mx = (64, 128) if k != 3 else (32, 256)
    jcfg, tcfg = make_cfgs(mx, my, bc_class, vy=0.4 if k == 8 else -0.25)
    w = window(my, mx, 8, np.float64, seed=20 + k)
    jt, jx, jy = (jnp.asarray(a) for a in jax_slabs(w, 8))
    tt, tx, ty = port_slabs(w, 8)
    for flags in FLAG_SETS:
        want = np.asarray(jps.sharded_tile_slab_multistep(
            jt, jx, jy, jnp.asarray(flags, jnp.int32), jcfg, 0.1, k,
            interpret=True, khalo=8,
        ))
        got = tsh.sharded_tile_slab_multistep(tt, tx, ty, flags, tcfg, 0.1, k, khalo=8)
        assert got.shape == (my, mx)
        np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-13,
                                   err_msg=f"flags {flags}")


@pytest.mark.parametrize("bc_class", ["MIX1", "one_sided_y", "both_axes"])
def test_k4_plain_matches_jax_kernel_f32(bc_class):
    jcfg, tcfg = make_cfgs(128, 64, bc_class)
    w = window(64, 128, 8, np.float32, seed=30)
    jt, jx, jy = (jnp.asarray(a) for a in jax_slabs(w, 8))
    tt, tx, ty = port_slabs(w, 8)
    for k in (1, 3, 8):
        for flags in FLAG_SETS:
            want = np.asarray(jps.sharded_tile_slab_multistep(
                jt, jx, jy, jnp.asarray(flags, jnp.int32), jcfg, 0.1, k,
                interpret=True, khalo=8,
            ))
            got = tsh.sharded_tile_slab_multistep(tt, tx, ty, flags, tcfg, 0.1, k, khalo=8)
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


@pytest.mark.parametrize("dtype, atol", [(np.float64, 1e-13), (np.float32, 2e-5)])
@pytest.mark.parametrize("shape", [(64, 128), (30, 50)])
@pytest.mark.parametrize("velocity", [(0.5, -0.25), (-0.3, 0.6)])
def test_k2_plain_matches_jax_kernel(shape, dtype, atol, velocity):
    my, mx = shape
    jcfg, tcfg = make_cfgs(mx, my, "MIX1", vx=velocity[0], vy=velocity[1])
    up = window(my, mx, 1, dtype, seed=my)
    want = np.asarray(jps.prepadded_kernel_step(jnp.asarray(up), jcfg, 0.1, interpret=True))
    got = tsh.prepadded_kernel_step(torch.from_numpy(up), tcfg, 0.1)
    assert got.dtype == torch.from_numpy(up).dtype and got.shape == (my, mx)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=atol)


@pytest.mark.parametrize("bc_class", ["MIX1", "one_sided_y"])
def test_bf16_storage_within_bound(bc_class):
    """bf16 storage: K3 and K4 compute in f32 and round once per pass, so
    they stay within 8e-3 of the f32 oracle (8 steps of the JAX
    reference_step on the assembled window's interior, which equals the
    edge rule on a 1x1 mesh's periodic-wrapped window) and within one bf16
    ulp of the JAX kernels."""
    jcfg, tcfg = make_cfgs(128, 64, bc_class)
    kh, k = 16, 8
    u32 = np.random.default_rng(5).random((64, 128)).astype(np.float32)
    # The 1x1 tile's window: the field padded with its own wrap, as the
    # exchange delivers it on a size-1 wrapping axis.
    w32 = np.pad(u32, kh, mode="wrap")
    wb = torch.from_numpy(w32).to(torch.bfloat16)
    ref = jnp.asarray(wb[kh:-kh, kh:-kh].to(torch.float32).numpy())
    for _ in range(k):
        ref = jreference_step(ref, jcfg, 0.1)
    flags = (1, 1, 1, 1)
    jw = jnp.asarray(wb.to(torch.float32).numpy()).astype(jnp.bfloat16)
    want3 = jps.tile_region_multistep(jw, jnp.asarray(flags, jnp.int32), jcfg, 0.1,
                                      k, 64, 128, True, interpret=True, khalo=kh)
    got3 = tsh.tile_region_multistep(wb, flags, tcfg, 0.1, k, 64, 128, khalo=kh)
    jt, jx, jy = (jnp.asarray(a).astype(jnp.bfloat16)
                  for a in jax_slabs(wb.to(torch.float32).numpy(), kh))
    want4 = jps.sharded_tile_slab_multistep(jt, jx, jy, jnp.asarray(flags, jnp.int32),
                                            jcfg, 0.1, k, interpret=True, khalo=kh)
    tt, tx, ty = (t.to(torch.bfloat16) for t in port_slabs(w32, kh))
    got4 = tsh.sharded_tile_slab_multistep(tt, tx, ty, flags, tcfg, 0.1, k, khalo=kh)
    for got, want in ((got3, want3), (got4, want4)):
        assert got.dtype == torch.bfloat16
        g = got.to(torch.float32).numpy()
        assert np.abs(g - np.asarray(ref)).max() < 8e-3
        w = np.asarray(want.astype(jnp.float32))
        assert np.all(np.abs(g - w) <= np.abs(w) * 2.0**-7 + 1e-30)


def test_whole_tile_k3_and_k4_are_one_function():
    """sharded_tile_multistep on the assembled (my+2k, mx+2k) tile equals
    K4 on the same data as slabs, and the JAX sharded_tile_multistep."""
    jcfg, tcfg = make_cfgs(96, 48, "both_axes")
    k = 8  # the JAX kernel takes one-sided mixes at k > 1 on 8-row windows
    w = window(48, 96, k, np.float64, seed=3)
    for flags in FLAG_SETS:
        a = tsh.sharded_tile_multistep(torch.from_numpy(w), flags, tcfg, 0.1, k, 96)
        b = tsh.sharded_tile_slab_multistep(*port_slabs(w, k), flags, tcfg, 0.1, k)
        torch.testing.assert_close(a, b, rtol=0, atol=0)
        want = np.asarray(jps.sharded_tile_multistep(
            jnp.asarray(w), jnp.asarray(flags, jnp.int32), jcfg, 0.1, k, 96,
            interpret=True,
        ))
        np.testing.assert_allclose(a.numpy(), want, rtol=0, atol=1e-13)


def test_region_writes_into_out_and_never_its_input():
    _, tcfg = make_cfgs(64, 32, "D4")
    w = torch.from_numpy(window(32, 64, 2, np.float64, seed=1))
    before = w.clone()
    big = torch.zeros(40, 80, dtype=torch.float64)
    out = big[4:36, 8:72]
    got = tsh.tile_region_multistep(w, (1, 0, 0, 1), tcfg, 0.1, 2, 32, 64, out=out)
    assert got.data_ptr() == out.data_ptr()
    torch.testing.assert_close(
        out, tsh.region_pass_plain(w, tcfg, 0.1, 2, 32, 64, (1, 0, 0, 1)), rtol=0, atol=0)
    assert torch.equal(w, before) and float(big[:4].abs().sum()) == 0.0
    with pytest.raises(ValueError, match="fresh"):
        tsh.tile_region_multistep(w, (0, 0, 0, 0), tcfg, 0.1, 2, 32, 64, out=w[2:34, 2:66])


def test_wrappers_check_their_inputs_and_count_no_cpu_launches():
    _, tcfg = make_cfgs(64, 32, "D4")
    tile, xh, yh = port_slabs(window(32, 64, 3, np.float64, seed=2), 3)
    counts = (tsh.prepadded_kernel_step.launches, tsh.tile_region_multistep.launches,
              tsh.sharded_tile_slab_multistep.launches)
    tsh.sharded_tile_slab_multistep(tile, xh, yh, (1, 1, 1, 1), tcfg, 0.1, 3)
    tsh.prepadded_kernel_step(torch.zeros(5, 6), tcfg, 0.1)
    assert counts == (tsh.prepadded_kernel_step.launches, tsh.tile_region_multistep.launches,
                      tsh.sharded_tile_slab_multistep.launches)
    with pytest.raises(ValueError, match="halo depth"):
        tsh.sharded_tile_slab_multistep(tile, xh, yh, (1, 1, 1, 1), tcfg, 0.1, 4, khalo=3)
    with pytest.raises(ValueError, match="xhalo"):
        tsh.sharded_tile_slab_multistep(tile, xh[:, :4], yh, (1, 1, 1, 1), tcfg, 0.1, 2, khalo=3)
    with pytest.raises(ValueError, match="edge flags"):
        tsh.sharded_tile_slab_multistep(tile, xh, yh, (1, 2, 0, 0), tcfg, 0.1, 3)
    with pytest.raises(TypeError, match="dtype"):
        tsh.prepadded_kernel_step(torch.zeros(5, 6, dtype=torch.int32), tcfg, 0.1)
    with pytest.raises(ValueError, match="k must be"):
        tsh.tile_region_multistep(torch.zeros(80, 80), (0,) * 4, tcfg, 0.1, 33, 8, 8)


def test_interior_step_routes_kernel_values_to_k2():
    _, tcfg = make_cfgs(64, 32, "MIX1", kernel="pallas")
    step = make_interior_step(tcfg, 0.1)
    assert step.kernel == "K2"
    up = torch.from_numpy(window(32, 64, 1, np.float64, seed=4))
    torch.testing.assert_close(step(up), tsh.prepadded_step_plain(up, tcfg, 0.1), rtol=0, atol=0)
    _, tcfg = make_cfgs(64, 32, "MIX1", kernel="jnp")
    assert getattr(make_interior_step(tcfg, 0.1), "kernel", None) is None


def _edge_bits(g, l, fix_lo, fix_hi, flag_lo, flag_hi):
    """csrc/tile_stencil.cuh's edge_bits, for a tensor of lines."""
    lo = (fix_lo != 0) & ((flag_lo == 1) & (g == 0) | (flag_hi == 1) & (g == l))
    hi = (fix_hi != 0) & ((flag_hi == 1) & (g == l - 1) | (flag_lo == 1) & (g == -1))
    return lo.long() | (hi.long() << 1)


def tile_source(read, ny, nx, kh, fixes, flags, extent=None):
    """K2-K5's row/column state and edge bits around a ``read(tr, cc)``
    that takes the clamped columns (csrc/tile_stencil.cuh TileRows)."""
    ly, lx = extent or (ny, nx)
    fl, fr, fb, ft = fixes

    def load(tr, tc):
        return read(tr, tc.clamp(-kh, nx + kh - 1))

    def row_bits(tr):
        return _edge_bits(tr, ly, fb, ft, flags[2], flags[3])

    def col_bits(tc):
        return _edge_bits(tc, lx, fl, fr, flags[0], flags[1])

    return load, row_bits, col_bits


def region_read(padded, kh):
    """RegionSource: region cell (tr, cc) at padded[tr + kh, cc + kh]."""
    return lambda tr, cc: padded[(tr + kh)[:, None], cc + kh]


def slab_read(tile, xh, yh, kh):
    """SlabSource: the y-halo above and below the tile's rows, else the
    tile or the x-halo by column."""
    ny, nx = tile.shape

    def read(tr, cc):
        t = tr[:, None].expand(cc.shape)
        above, below = t >= ny, t < 0
        y = yh[torch.where(below, kh + t, kh + t - ny).clamp(0, 2 * kh - 1), cc + kh]
        r = t.clamp(0, ny - 1)
        mid = torch.where(cc < 0, xh[r, (kh + cc).clamp(0, 2 * kh - 1)],
                          torch.where(cc >= nx, xh[r, (kh + cc - nx).clamp(0, 2 * kh - 1)],
                                      tile[r, cc.clamp(0, nx - 1)]))
        return torch.where(above | below, y, mid)

    return read


@pytest.mark.parametrize("bc_class", ["one_sided_y", "one_sided_x", "both_axes", "compat"])
@pytest.mark.parametrize("shape, k, kh", [((300, 40), 3, 8), ((40, 300), 8, 8),
                                          ((8, 100), 8, 8), ((100, 8), 8, 8),
                                          ((64, 128), 1, 1)])
def test_streamed_region_pass_matches_plain_f64(shape, k, kh, bc_class):
    """K3 through a region view of a wider tensor (row stride > nx+2kh),
    K3's k-row and k-column bands, and K2's one step (kh = 1), under every
    mesh tile's flags, flagged and not."""
    ny, nx = shape
    _, tcfg = make_cfgs(nx, ny, bc_class, vx=-0.3)
    big = torch.from_numpy(window(ny, nx + 5, kh, np.float64, seed=ny + nx))
    padded = big[:, 2:2 + nx + 2 * kh]
    weights, fixes = stencil_constants(tcfg, 0.1)
    for flags in FLAG_SETS + [tsh.NO_FLAGS]:
        got = stream_pass_emulated(
            *tile_source(region_read(padded, kh), ny, nx, kh, fixes, flags), ny, nx, k,
            weights, fixes)
        want = tsh.region_pass_plain(padded, tcfg, 0.1, k, ny, nx, flags, kh)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12, msg=f"flags {flags}")


@pytest.mark.parametrize("bc_class", ["MIX1", "one_sided_y", "one_sided_x", "compat"])
@pytest.mark.parametrize("shape, k, kh", [((40, 300), 8, 8), ((300, 40), 3, 4),
                                          ((64, 128), 8, 8), ((19, 241), 8, 8)])
def test_streamed_slab_pass_matches_plain_f64(shape, k, kh, bc_class):
    """K4 from the tile and its halo slabs, under every mesh tile's flags."""
    my, mx = shape
    _, tcfg = make_cfgs(mx, my, bc_class, vy=0.4)
    w = window(my, mx, kh, np.float64, seed=my)
    tile, xh, yh = port_slabs(w, kh)
    weights, fixes = stencil_constants(tcfg, 0.1)
    for flags in FLAG_SETS:
        got = stream_pass_emulated(
            *tile_source(slab_read(tile, xh, yh, kh), my, mx, kh, fixes, flags), my, mx, k,
            weights, fixes)
        want = tsh.slab_pass_plain(tile, xh, yh, flags, tcfg, 0.1, k, kh)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12, msg=f"flags {flags}")


@pytest.mark.parametrize("bc_class", ["D4", "one_sided_y", "one_sided_x", "compat"])
@pytest.mark.parametrize("extent", [(37, 250), (8, 8), (300, 9)])
def test_streamed_carrier_pass_matches_plain_f64(extent, bc_class):
    """K5 on a 300x260 carrier tile whose true extent (ly, lx) lies inside
    it, under the flags of the edge tiles of 2x2, 1x4 and 4x1 carriers; the
    whole tile, pad included, is compared."""
    my, mx, k, kh = 300, 260, 8, 8
    _, tcfg = make_cfgs(mx, my, bc_class)
    w = window(my, mx, kh, np.float64, seed=extent[0])
    tile, xh, yh = port_slabs(w, kh)
    weights, fixes = stencil_constants(tcfg, 0.1)
    for flags in [f for f in FLAG_SETS if f[1] or f[3]]:
        got = stream_pass_emulated(
            *tile_source(slab_read(tile, xh, yh, kh), my, mx, kh, fixes, flags, extent),
            my, mx, k, weights, fixes)
        want = tsh.carrier_pass_plain(tile, xh, yh, (*flags, *extent), tcfg, 0.1, k, kh)
        torch.testing.assert_close(got, want, rtol=0, atol=1e-12, msg=f"flags {flags}")


def test_batched_slab_read_equals_the_per_row_read():
    """The emulator reads a block group's window rows through the source in
    one call (``read_window``): the same values and edge bits as one call a
    row, on K5's carrier tile with its corner tile's flags, rows above and
    below the tile and columns both sides of it included."""
    my, mx, kh = 300, 260, 8
    tile, xh, yh = port_slabs(window(my, mx, kh, np.float64, seed=5), kh)
    load, row_bits, _ = tile_source(slab_read(tile, xh, yh, kh), my, mx, kh, (1, 2, 1, 2),
                                    (0, 1, 0, 1), (37, 250))
    y0 = torch.tensor([0, 64, 256, 0])
    tc = torch.arange(-kh, 120)[None, :] + torch.tensor([0, 112, 224, 140])[:, None]
    rows = 60
    values, bits = read_window(load, row_bits, y0, tc, kh, rows)
    assert torch.equal(values, torch.stack([load(y0 - kh + i, tc) for i in range(rows)]))
    assert torch.equal(bits, torch.stack([row_bits(y0 - kh + i) for i in range(rows)]))


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: K2-K4's CUDA kernels have no CPU mode")
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape, k", [((96, 120), 8), ((300, 20), 8), ((333, 241), 8),
                                      ((2048, 8), 8), ((8, 2048), 8), ((96, 120), 16),
                                      ((96, 120), 32)])
@pytest.mark.parametrize("bc_class", list(BC_CLASSES))
def test_cuda_kernels_match_plain_on_card(cuda_device, bc_class, shape, k):
    """K3 and K4 on tiles narrower than one band, one column wider than a
    band's output, K3's k-column and k-row band regions (K4 where the halo
    fits the tile), and k = 16 and 32; K2 on the same window."""
    my, mx = shape
    _, tcfg = make_cfgs(mx, my, bc_class)
    w = torch.from_numpy(window(my, mx, k, np.float32, seed=6)).to(cuda_device)
    tile, xh, yh = (t.to(cuda_device) for t in port_slabs(w.cpu().numpy(), k))
    for flags in FLAG_SETS:
        n3, n4 = tsh.tile_region_multistep.launches, tsh.sharded_tile_slab_multistep.launches
        got3 = tsh.tile_region_multistep(w, flags, tcfg, 0.1, k, my, mx, khalo=k)
        torch.cuda.synchronize(cuda_device)
        assert tsh.tile_region_multistep.launches == n3 + 1
        want = tsh.region_pass_plain(w, tcfg, 0.1, k, my, mx, flags, k)
        torch.testing.assert_close(got3, want, rtol=0, atol=1e-5)
        if k <= min(my, mx):
            got4 = tsh.sharded_tile_slab_multistep(tile, xh, yh, flags, tcfg, 0.1, k, khalo=k)
            torch.cuda.synchronize(cuda_device)
            assert tsh.sharded_tile_slab_multistep.launches == n4 + 1
            torch.testing.assert_close(got4, want, rtol=0, atol=1e-5)
    up = w[k - 1:-(k - 1), k - 1:-(k - 1)].contiguous()
    torch.testing.assert_close(tsh.prepadded_kernel_step(up, tcfg, 0.1),
                               tsh.prepadded_step_plain(up, tcfg, 0.1), rtol=0, atol=1e-5)
