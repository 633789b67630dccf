"""The port's exchange schedule (``climate_sim_tpu_torch/parallel/analysis.py``)
against the JAX package's ``ppermute_critical_depth``, on the CPU.

The port walks one executed pass on ``[cpu] * n`` tiles; JAX walks the
jaxpr of one pass built over the virtual CPU devices of tests/conftest.py
with its Pallas kernels in interpret mode, as tests/test_parallel.py
builds them.  Depths are compared exactly; batch counts (the
``_deliver`` calls that move a payload, what a rank pays in rendezvous)
are pinned per path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec

from climate_sim_tpu import config as jconfig
from climate_sim_tpu.ops.init import gaussian_hotspot as jgaussian
from climate_sim_tpu.ops.step import make_interior_step as jmake_interior_step
from climate_sim_tpu.parallel import halo as jhalo
from climate_sim_tpu.parallel import mesh as jmesh
from climate_sim_tpu.parallel.analysis import ppermute_critical_depth

from climate_sim_tpu_torch import config as tconfig
from climate_sim_tpu_torch.ops.init import gaussian_hotspot
from climate_sim_tpu_torch.ops.step import make_interior_step
from climate_sim_tpu_torch.parallel import halo
from climate_sim_tpu_torch.parallel.analysis import (
    exchange_batches,
    exchange_critical_depth,
    on_each_batch,
)
from climate_sim_tpu_torch.parallel.mesh import make_mesh, shard_field

DNDN = ("dirichlet", "neumann", "dirichlet", "neumann")
P4 = ("periodic",) * 4


def cfgs(nx, ny, bcs, steps=8):
    """(JAX config, port config) of the JAX depth tests' physics."""
    out = []
    for mod in (jconfig, tconfig):
        cfg = mod.SimConfig(nx=nx, ny=ny, D=0.05, vx=0.5, vy=-0.25, dt=0.1,
                            steps=steps, out_every=steps)
        if bcs is not None:
            cfg.bc = mod.BCConfig(*(getattr(mod.BCType, b.upper()) for b in bcs))
        out.append(cfg)
    return out


def port_pass(path, cfg, px, py, steps=None):
    """(one pass of ``path`` on a CPU mesh, a function making fresh tiles of
    the Gaussian IC for it)."""
    mesh = make_mesh(px, py, ["cpu"] * (px * py))
    if path == "slab":
        adv = halo.build_sharded_multistep_advance(cfg, mesh, cfg.dt)
    elif path == "overlap":
        adv = halo.build_sharded_overlap_advance(cfg, mesh, cfg.dt)
    elif path == "perstep":
        adv = halo.build_sharded_advance(cfg, mesh, cfg.dt, make_interior_step(cfg, cfg.dt))
    elif path == "padded":
        adv = halo.build_padded_advance(cfg, mesh, cfg.dt)
    else:
        adv = halo.build_carrier_slab_advance(cfg, mesh, cfg.dt)
    assert adv is not None, path
    u = gaussian_hotspot(cfg, torch.float32, torch.device("cpu"))
    embed = adv.embed if path == "carrier" else (lambda v: shard_field(v, mesh))
    n = steps or getattr(adv, "steps_per_pass", 1)
    return adv(n), lambda: embed(u.clone())


def jax_depth(path, cfg, px, py, steps):
    """JAX's ``ppermute_critical_depth`` of ``advance(steps)`` on a (py, px)
    mesh of the virtual CPU devices."""
    mesh = jmesh.make_mesh(px, py, jax.devices()[: px * py])
    if path == "slab":
        adv = jhalo.build_sharded_multistep_advance(cfg, mesh, cfg.dt, interpret=True)
    elif path == "overlap":
        adv = jhalo.build_sharded_overlap_advance(cfg, mesh, cfg.dt, interpret=True)
    elif path == "perstep":
        adv = jhalo.build_sharded_advance(cfg, mesh, cfg.dt, jmake_interior_step(cfg, cfg.dt))
    else:
        adv = jhalo.build_carrier_slab_advance(cfg, mesh, cfg.dt, interpret=True)
    assert adv is not None, path
    u = jgaussian(cfg, jnp.float32)
    if path == "carrier":
        u = adv.embed(jax.device_put(u, NamedSharding(mesh, PartitionSpec(None, None))))
    else:
        u = jax.device_put(u, jmesh.field_sharding(mesh))
    return ppermute_critical_depth(adv(steps), u)


# (path, (nx, ny), BCs, (px, py), JAX steps).  The first eight are the
# configs of tests/test_parallel.py::test_structural_exchange_depth_per_pass
# and ::test_overlap_one_sided_slope_stays_two; the port plans the carrier
# with no alignment, so 1000x504 divides its 4x2 mesh and stages nothing,
# and the staged torus is 1001x999 on 2x2.  On 8x1 the y axis has one
# tile and moves nothing (k = 4 there, so 4 steps are one pass).
DEPTH_CASES = {
    "slab": ("slab", (1024, 512), DNDN, (4, 2), 8),
    "overlap": ("overlap", (1024, 512), DNDN, (4, 2), 8),
    "perstep": ("perstep", (1024, 512), DNDN, (4, 2), 1),
    "slab_torus": ("slab", (1024, 512), P4, (4, 2), 8),
    "carrier": ("carrier", (1000, 504), None, (4, 2), 8),
    "carrier_torus": ("carrier", (1000, 504), P4, (4, 2), 8),
    "overlap_one_sided_y": ("overlap", (1024, 512),
                            ("dirichlet", "neumann", "periodic", "dirichlet"), (4, 2), 8),
    "overlap_both_axes": ("overlap", (1024, 512),
                          ("periodic", "dirichlet", "periodic", "neumann"), (4, 2), 8),
    "carrier_torus_staged_2x2": ("carrier", (1001, 999), P4, (2, 2), 8),
    "slab_self_wrap_8x1": ("slab", (1024, 512), P4, (8, 1), 4),
}


@pytest.mark.parametrize("case", list(DEPTH_CASES))
def test_depth_equals_jax_ppermute_critical_depth(case):
    path, (nx, ny), bcs, (px, py), steps = DEPTH_CASES[case]
    jcfg, tcfg = cfgs(nx, ny, bcs)
    want = jax_depth(path, jcfg, px, py, steps)
    fn, tiles = port_pass(path, tcfg, px, py, 1 if path == "perstep" else None)
    assert exchange_critical_depth(fn, tiles()) == want
    assert want == (1 if py == 1 else 2)


# (path, (nx, ny), BCs, (px, py), steps, batches).  A batch per face shift:
# gl, gr, gb, gt on every path; the staged carrier torus adds one wrap-head
# batch per tile row (x) and per tile column (y): 4 + 2 + 2 on 2x2, 4 + 2 +
# 4 on 4x2 (one pass, depth 2, where the dataflow needs 2 rounds).
BATCH_CASES = {
    "slab": ("slab", (1024, 512), DNDN, (4, 2), None, 4),
    "overlap": ("overlap", (1024, 512), DNDN, (4, 2), None, 4),
    "perstep_one_step": ("perstep", (1024, 512), DNDN, (4, 2), 1, 4),
    "perstep_three_steps": ("perstep", (1024, 512), DNDN, (4, 2), 3, 12),
    "padded_one_step": ("padded", (1001, 503), DNDN, (4, 2), 1, 4),
    "carrier_unstaged": ("carrier", (1000, 504), P4, (4, 2), None, 4),
    "carrier_one_sided_y": ("carrier", (1001, 999),
                            ("dirichlet", "neumann", "periodic", "dirichlet"), (2, 2), None, 4),
    "carrier_torus_staged_2x2": ("carrier", (1001, 999), P4, (2, 2), None, 8),
    "carrier_torus_staged_4x2": ("carrier", (1001, 999), P4, (4, 2), None, 10),
}


@pytest.mark.parametrize("case", list(BATCH_CASES))
def test_batches_pinned_per_path(case):
    path, (nx, ny), bcs, (px, py), steps, want = BATCH_CASES[case]
    _, tcfg = cfgs(nx, ny, bcs)
    fn, tiles = port_pass(path, tcfg, px, py, steps)
    assert exchange_batches(fn, tiles()) == want
    assert exchange_critical_depth(fn, tiles()) == 2 * (steps or 1)


@pytest.mark.parametrize("path, batches", [("slab", 2), ("overlap", 2), ("perstep", 2),
                                           ("carrier", 3)])
def test_self_wrap_8x1_moves_nothing_along_y(path, batches):
    """One y tile: its shifts deliver each tile its own part, so only the x
    faces are batches (2; the staged carrier adds its one x wrap head,
    which rides round 1) and the chain is 1; ``Mesh.rounds`` counts the
    empty y calls too."""
    nx, ny = (1001, 999) if path == "carrier" else (1024, 512)
    _, tcfg = cfgs(nx, ny, P4)
    fn, tiles = port_pass(path, tcfg, 8, 1, 1 if path == "perstep" else None)
    rounds = []
    real = halo._deliver

    def spy(parts, mesh, moves, out):
        real(parts, mesh, moves, out)
        rounds.append(mesh.rounds)

    halo._deliver = spy
    try:
        assert exchange_batches(fn, tiles()) == batches
    finally:
        halo._deliver = real
    assert [r - rounds[0] for r in rounds] == list(range(batches + 2))
    assert exchange_critical_depth(fn, tiles()) == 1


def test_a_one_tile_mesh_has_no_exchange():
    _, tcfg = cfgs(256, 256, P4)
    for path in ("slab", "overlap", "perstep"):
        fn, tiles = port_pass(path, tcfg, 1, 1, 1 if path == "perstep" else None)
        assert (exchange_critical_depth(fn, tiles()), exchange_batches(fn, tiles())) == (0, 0)


def test_chains_and_concurrent_shifts():
    """Shifts of one source are one round; a shift of a shift is the next.
    A delivery on one device returns the source view itself, so a second
    shift of the ORIGINAL tiles stays at depth 1."""
    mesh = make_mesh(2, 2, ["cpu"] * 4)
    rng = np.random.default_rng(0)
    base = [[torch.tensor(rng.random((4, 4))) for _ in range(2)] for _ in range(2)]

    def concurrent(t):
        halo._pshift(t, mesh, "x", +1)
        halo._pshift(t, mesh, "x", -1)
        halo._pshift(t, mesh, "y", +1)

    def chained(t):
        for axis in ("x", "y", "x"):
            t = halo._pshift(t, mesh, axis, +1)

    def mixed(t):
        a = halo._pshift(t, mesh, "x", +1)
        b = [[a[y][x] * 2 + t[y][x] for x in range(2)] for y in range(2)]
        halo._pshift(b, mesh, "y", -1)

    assert (exchange_critical_depth(concurrent, base), exchange_batches(concurrent, base)) == (1, 3)
    assert (exchange_critical_depth(chained, base), exchange_batches(chained, base)) == (3, 3)
    assert (exchange_critical_depth(mixed, base), exchange_batches(mixed, base)) == (2, 2)


@pytest.mark.parametrize("case", ["overlap", "perstep_three_steps",
                                  "carrier_torus_staged_2x2", "padded_one_step"])
def test_a_watched_pass_is_bit_identical(case):
    """Both walks leave the pass's values as an unwatched pass leaves them
    (the staged carrier writes its input tiles in place too)."""
    path, (nx, ny), bcs, (px, py), steps, _ = BATCH_CASES[case]
    _, tcfg = cfgs(nx, ny, bcs)
    fn, tiles = port_pass(path, tcfg, px, py, steps)
    plain_in = tiles()
    want = fn(plain_in)
    for walk in (exchange_critical_depth, exchange_batches):
        got = []
        t = tiles()
        walk(lambda tt: got.append(fn(tt)), t)
        for y in range(py):
            for x in range(px):
                assert torch.equal(got[0][y][x], want[y][x])
                assert torch.equal(t[y][x], plain_in[y][x])


def test_deliver_is_restored_after_an_exception():
    _, tcfg = cfgs(256, 128, DNDN)
    fn, tiles = port_pass("slab", tcfg, 2, 2)
    real = halo._deliver

    def boom(t):
        fn(t)
        raise RuntimeError("boom")

    for walk in (exchange_critical_depth, exchange_batches):
        with pytest.raises(RuntimeError, match="boom"):
            walk(boom, tiles())
        assert halo._deliver is real
    calls = []
    with pytest.raises(RuntimeError, match="boom"):
        with on_each_batch(lambda: calls.append(1)):
            boom(tiles())
    assert halo._deliver is real and len(calls) == 4
