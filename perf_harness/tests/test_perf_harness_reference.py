"""The plain reference: hand-worked steps for each BC kind, and the
separable evaluation held to the step-by-step one."""

import itertools
import os
import sys

import pytest
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import reference as R  # noqa: E402


def row(bc_left, bc_right, **kw):
    """A one-row grid, periodic in y, so the y terms vanish exactly."""
    s = dict(nx=3, ny=1, dx=1.0, dy=1.0, D=0.0, vx=0.0, vy=0.0, dt=0.1)
    s.update(kw)
    return R.Scheme(bc=(bc_left, bc_right, "periodic", "periodic"), **s)


def col(bc_bottom, bc_top, **kw):
    s = dict(nx=1, ny=3, dx=1.0, dy=1.0, D=0.0, vx=0.0, vy=0.0, dt=0.1)
    s.update(kw)
    return R.Scheme(bc=("periodic", "periodic", bc_bottom, bc_top), **s)


def step_row(s, values):
    return R.step_plain(torch.tensor([values], dtype=torch.float64), s)[0].tolist()


def step_col(s, values):
    return R.step_plain(torch.tensor(values, dtype=torch.float64)[:, None], s)[:, 0].tolist()


@pytest.mark.parametrize("left,right,expected", [
    # diffusion, dt D / dx^2 = 0.1, from [1, 0, 0]
    ("dirichlet", "dirichlet", [0.8, 0.1, 0.0]),   # ghost 0
    ("neumann", "dirichlet", [0.9, 0.1, 0.0]),     # ghost mirrors u0 = 1
    ("periodic", "periodic", [0.8, 0.1, 0.1]),     # ghosts wrap: u2 sees u0
])
def test_diffusion_by_hand(left, right, expected):
    assert step_row(row(left, right, D=1.0), [1.0, 0.0, 0.0]) == pytest.approx(expected, abs=1e-15)


@pytest.mark.parametrize("bc,vx,values,expected", [
    # donor cell, dt vx / dx = +-0.5
    ("dirichlet", 1.0, [1.0, 0.0, 0.0], [0.5, 0.5, 0.0]),   # inflow ghost 0
    ("periodic", 1.0, [0.0, 0.0, 1.0], [0.5, 0.0, 0.5]),    # u0 takes u2 across the wrap
    ("neumann", -1.0, [0.0, 0.0, 1.0], [0.0, 0.5, 1.0]),    # outflow ghost mirrors u2
    ("dirichlet", -1.0, [0.0, 0.0, 1.0], [0.0, 0.5, 0.5]),  # ghost 0 above u2
])
def test_advection_by_hand(bc, vx, values, expected):
    assert step_row(row(bc, bc, vx=vx, dt=0.5), values) == pytest.approx(expected, abs=1e-15)


@pytest.mark.parametrize("bottom,top,vy,values,expected", [
    ("dirichlet", "neumann", 0.0, [1.0, 0.0, 0.0], [0.8, 0.1, 0.0]),
    ("periodic", "periodic", 1.0, [0.0, 0.0, 1.0], [0.5, 0.0, 0.5]),
    ("neumann", "neumann", -1.0, [0.0, 0.0, 1.0], [0.0, 0.5, 1.0]),
])
def test_y_by_hand(bottom, top, vy, values, expected):
    kw = {"D": 1.0} if vy == 0.0 else {"vy": vy, "dt": 0.5}
    assert step_col(col(bottom, top, **kw), values) == pytest.approx(expected, abs=1e-15)


@pytest.mark.parametrize("bc", list(itertools.product(R.BC_KINDS, repeat=4)))
def test_separable_equals_stepping(bc):
    for vx, vy in ((0.5, -0.25), (-0.3, 0.2)):
        s = R.Scheme(23, 17, 1.0, 1.3, 0.05, vx, vy, 0.1, bc)
        spots = [R.Hotspot(1.3, 0.2, 0.3, 0.8), R.Hotspot(0.7, 0.1, 0.9, 0.05)]
        fast = R.evolve_separable(spots, s, 150)
        part = R.evolve_separable(spots, s, 150, window=(3, 11, 5, 20))
        for h, f, p in zip(spots, fast, part):
            slow = R.evolve_plain(h.field(s), s, 150)
            assert float((slow - f).abs().max()) < 1e-12
            assert torch.equal(f[3:11, 5:20], p)


@pytest.mark.parametrize("bc", [("dirichlet", "neumann", "periodic", "periodic"),
                                ("dirichlet",) * 4, ("periodic",) * 4])
@pytest.mark.parametrize("D,vx,vy", [(0.05, 0.5, -0.25), (0.0, 0.5, 0.0), (0.0, 0.0, 0.0)])
def test_a_series_equals_stepping(bc, D, vx, vy):
    """Each count of a series, the powers taken once for all counts (a part
    with no share among the physics), against the scheme stepped to it."""
    s = R.Scheme(23, 17, 1.0, 1.3, D, vx, vy, 0.1, bc)
    spots = [R.Hotspot(1.3, 0.2, 0.3, 0.8), R.Hotspot(0.7, 0.1, 0.9, 0.05)]
    counts = [0, 40, 80, 150]
    series = R.evolve_separable_series(spots, s, counts, window=(3, 11, 5, 20))
    for i, h in enumerate(spots):
        u, done = h.field(s), 0
        for count, fields in zip(counts, series):
            u, done = R.evolve_plain(u, s, count - done), count
            assert float((u[3:11, 5:20] - fields[i]).abs().max()) < 1e-12


def test_separable_diffusion_only_and_still():
    bc = ("dirichlet", "neumann", "periodic", "periodic")
    h = R.Hotspot(1.0, 0.15, 0.4, 0.6)
    for D, vx, vy in ((0.05, 0.0, 0.0), (0.0, 0.0, 0.0), (0.0, 0.5, 0.0)):
        s = R.Scheme(19, 15, 1.0, 1.0, D, vx, vy, 0.1, bc)
        slow = R.evolve_plain(h.field(s), s, 60)
        assert float((slow - R.evolve_separable([h], s, 60)[0]).abs().max()) < 1e-12


def test_binomial_window_holds_the_mass():
    for steps, a in ((10, 0.3), (64000, 0.63), (128000, 0.5)):
        j0, w = R.binomial_window(steps, a)
        assert abs(float(w.sum()) - 1.0) < 1e-12
        assert j0 <= a * steps <= j0 + w.numel()


def test_split_refuses_an_unstable_step():
    s = R.Scheme(8, 8, 1.0, 1.0, 1.0, 0.0, 0.0, 0.5, ("periodic",) * 4)
    with pytest.raises(ValueError):
        R.split(s)


def test_max_error_reads_nan():
    ref = torch.zeros(2, 2, dtype=torch.float64)
    bad = torch.tensor([[0.0, float("nan")], [0.0, 0.0]])
    assert R.max_error(bad, ref) != R.max_error(bad, ref)
    assert R.max_error(torch.ones(2, 2), ref) == 1.0
