"""The port's sharded machinery at 32 tiles: the counterpart of
tests/test_podscale.py.

The JAX package raises its device count to 32 in a subprocess; the port's
mesh may repeat a device, so an 8x4 mesh of 32 tiles over the CPU device
runs here, in-process.  It checks the mesh shape chosen for 32 devices,
the neighbour wiring of one slab exchange (the moves ``_deliver`` makes),
that the slab path engages (K4's plain version runs the pass schedule
times 32), and that ``run_simulation`` on the 8x4 mesh matches JAX's
single-device run within ``1e-11`` in f64, for an all-periodic and a
one-sided-periodic mix.
"""

import jax
import numpy as np
import pytest
import torch

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.runtime.driver import run_simulation as jrun

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.ops import cuda_sharded as tsh
from climate_sim_tpu_torch.ops import cuda_stencil as tcs
from climate_sim_tpu_torch.parallel import halo as thalo
from climate_sim_tpu_torch.parallel import mesh as tmesh
from climate_sim_tpu_torch.runtime import driver as tdriver

PX, PY = 8, 4
TILE = (32, 128)  # (my, mx): the JAX test's tiles, on which k = 1
NX, NY = TILE[1] * PX, TILE[0] * PY
STEPS = 13


def test_choose_mesh_shape_at_32():
    assert tmesh.choose_mesh_shape(32, NX, NY) == (PX, PY)
    assert tmesh.dims_create(32) == (PX, PY)


def test_exchange_wiring_at_32_tiles(monkeypatch):
    """One slab exchange on the torus: every tile takes its x faces from
    its left and right neighbours (wrapping), then its y faces from those
    below and above; the payloads that cross the wrap edge are the edge
    tiles' own."""
    mesh = tmesh.make_mesh(PX, PY, ["cpu"] * (PX * PY))
    moves = []
    real = thalo._deliver

    def spy(parts, mesh_, batch, out):
        moves.append(list(batch))
        return real(parts, mesh_, batch, out)

    monkeypatch.setattr(thalo, "_deliver", spy)
    # Each tile holds its index, so a ghost names the tile it came from.
    tiles = [[torch.full(TILE, float(y * PX + x), dtype=torch.float64) for x in range(PX)]
             for y in range(PY)]
    xhalo, yhalo = thalo.exchange_halos_slabs(tiles, mesh, 2)
    assert len(moves) == 4  # left, right, bottom, top faces: one batch each
    for batch, axis, shift in zip(moves, "xxyy", (+1, -1, +1, -1)):
        assert len(batch) == PX * PY
        for (sy, sx), (dy, dx), (ax, wrapped) in batch:
            assert ax == axis
            if axis == "x":
                assert sy == dy and sx == (dx - shift) % PX
                assert wrapped == (not 0 <= dx - shift < PX)
            else:
                assert sx == dx and sy == (dy - shift) % PY
                assert wrapped == (not 0 <= dy - shift < PY)
    assert mesh.copies[("x", True)] == 2 * PY and mesh.copies[("x", False)] == 2 * (PX - 1) * PY
    assert mesh.copies[("y", True)] == 2 * PX and mesh.copies[("y", False)] == 2 * (PY - 1) * PX
    for y in range(PY):
        for x in range(PX):
            left, right = (x - 1) % PX, (x + 1) % PX
            below, above = (y - 1) % PY, (y + 1) % PY
            assert torch.all(xhalo[y][x][:, :2] == y * PX + left)
            assert torch.all(xhalo[y][x][:, 2:] == y * PX + right)
            # The y faces carry the x-extended rows: the corners hold the
            # diagonal neighbours.
            assert yhalo[y][x].shape == (4, TILE[1] + 4)
            assert torch.all(yhalo[y][x][:2, 2:-2] == below * PX + x)
            assert torch.all(yhalo[y][x][2:, 2:-2] == above * PX + x)
            assert torch.all(yhalo[y][x][:2, :2] == below * PX + left)
            assert torch.all(yhalo[y][x][2:, -2:] == above * PX + right)


@pytest.mark.parametrize("bcs", [
    ("periodic", "periodic", "periodic", "periodic"),
    ("periodic", "periodic", "neumann", "dirichlet"),  # the JAX test's mix
    ("dirichlet", "neumann", "periodic", "dirichlet"),  # dev.yaml's one-sided y
])
@pytest.mark.parametrize("tile", [TILE, (96, 160)])  # k = 1, and k = 3
def test_slab_path_at_32_tiles_matches_jax(tmp_path, monkeypatch, bcs, tile):
    args = [f"--nx={tile[1] * PX}", f"--ny={tile[0] * PY}", "--D=0.05", "--vx=0.5", "--vy=-0.25", "--dt=0.1",
            f"--steps={STEPS}", f"--out_every={STEPS}", "--precision=f64",
            *(f"--bc.{s}={b}" for s, b in zip(("left", "right", "bottom", "top"), bcs))]
    jcfg = jconfig.merged_config(None, args + ["--kernel=jnp", f"--output.dir={tmp_path}/j"])
    jres = jrun(jcfg, devices=jax.devices()[:1])

    calls = []
    real = tsh.slab_pass_plain

    def counted(*a, **kw):
        calls.append(a[0].shape)
        return real(*a, **kw)

    monkeypatch.setattr(tsh, "slab_pass_plain", counted)
    tcfg = tconfig.merged_config(None, args + ["--kernel=pallas", f"--output.dir={tmp_path}/t"])
    tres = tdriver.run_simulation(tcfg, ["cpu"] * (PX * PY))
    assert tres.mesh_shape == (PY, PX)
    # The slab path engaged: K4 on every tile in every pass (the warm-up's
    # one-step pass included), nothing else.
    k = tcs.pick_steps_per_pass(tconfig.SimConfig(nx=tile[1], ny=tile[0]), STEPS)
    assert tres.timed_passes == -(-STEPS // k)
    passes = tres.warmup_passes + tres.timed_passes
    assert len(calls) == passes * PX * PY
    assert set(calls) == {tile}
    assert tres.snapshots_written == jres.snapshots_written
    got = tres.u.numpy()
    want = np.asarray(jres.u)
    assert got.shape == want.shape == (tile[0] * PY, tile[1] * PX)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-11)
