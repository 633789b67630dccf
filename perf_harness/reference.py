"""The plain reference of the stencil: what a cell's jobs must produce.

The program integrates ``u_t = D lap(u) - v . grad(u)`` with forward Euler,
FTCS diffusion and donor-cell upwind advection, on a ghost-padded field
whose ghosts each side sets by its own rule: Dirichlet (ghost 0), Neumann
(ghost = the adjacent interior cell) or periodic (ghost = the opposite
edge's cell).  The field is stored (y, x): dim 0 is y, bottom to top.

Two evaluations of that scheme live here, both plain torch and neither
reading anything of the program:

* :func:`step_plain` / :func:`evolve_plain`: the scheme as written, one
  step at a time on the padded field.  It is the definition, and the tests
  hold everything else to it.
* :func:`evolve_separable`: the same linear map, evaluated in a way whose
  cost does not grow with the grid times the steps.  The five-point update
  is a Kronecker sum: ``L = Ax (x) I + I (x) Ay``, where ``Ax`` acts along
  x alone (its ghosts are the row's own cells) and ``Ay`` along y alone.
  The two parts commute, so with ``a + b = 1`` and ``Px = Ax / a``,
  ``Py = Ay / b``::

      L^S = sum_j C(S, j) a^j b^(S-j)  Px^j (x) Py^(S-j)

  For a separable initial field ``u0 = A gy(y) gx(x)`` (the Gaussian
  hotspot is one) the field after S steps is
  ``A sum_j w_j (Py^(S-j) gy)(y) (Px^j gx)(x)``.  The weights ``w_j`` are a
  binomial distribution, so only j within some tens of standard
  deviations of ``a S`` count; ``a`` is chosen so that ``Px`` and ``Py``
  have no negative entry, and every term is then non-negative: the sum has
  no cancellation, and float64 evaluates it to round-off.  The cost is
  some twenty products of n x n matrices (the powers of each 1-D part by
  squaring), a few thousand steps of a 1-D stencil, and one matrix product
  per tile.

Nothing here imports the program or JAX.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import torch

BC_KINDS = ("dirichlet", "neumann", "periodic")

# Binomial weights below exp(-LOG_CUT) of the largest are dropped: their sum
# is far below float64 round-off of the result.
LOG_CUT = 60.0


@dataclass(frozen=True)
class Scheme:
    """One configuration's update, as plain numbers."""

    nx: int
    ny: int
    dx: float
    dy: float
    D: float
    vx: float
    vy: float
    dt: float
    bc: Tuple[str, str, str, str]  # left, right, bottom, top

    @classmethod
    def from_config(cls, cfg: dict) -> "Scheme":
        """From a harness configuration file's ``grid``, ``physics``,
        ``time`` and ``bc`` groups."""
        g, p, t, b = cfg["grid"], cfg["physics"], cfg["time"], cfg["bc"]
        bc = tuple(str(b[s]).lower() for s in ("left", "right", "bottom", "top"))
        for kind in bc:
            if kind not in BC_KINDS:
                raise ValueError(f"unknown boundary condition {kind!r}")
        return cls(int(g["nx"]), int(g["ny"]), float(g.get("dx", 1.0)),
                   float(g.get("dy", 1.0)), float(p.get("D", 0.0)),
                   float(p.get("vx", 0.0)), float(p.get("vy", 0.0)),
                   float(t["dt"]), bc)

    def axis_weights(self, axis: str) -> Tuple[float, float, float]:
        """(weight of the cell below, of the cell above, the axis' share of
        the centre weight) along ``axis``: its diffusion plus its donor-cell
        upwind term (the backward difference for a velocity >= 0)."""
        h, v = (self.dx, self.vx) if axis == "x" else (self.dy, self.vy)
        a = self.dt * self.D / (h * h)
        c = self.dt * v / h
        if v >= 0.0:
            return a + c, a, -2.0 * a - c
        return a, a - c, -2.0 * a + c


def _ghosts(u: torch.Tensor, dim: int, lo: str, hi: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ghost lines below and above ``u`` along ``dim``."""
    n = u.shape[dim]
    first, last = u.narrow(dim, 0, 1), u.narrow(dim, n - 1, 1)

    def ghost(kind: str, mirror: torch.Tensor, wrap: torch.Tensor) -> torch.Tensor:
        if kind == "dirichlet":
            return torch.zeros_like(mirror)
        if kind == "neumann":
            return mirror
        return wrap

    return ghost(lo, first, last), ghost(hi, last, first)


def pad(u: torch.Tensor, bc: Sequence[str]) -> torch.Tensor:
    """The (ny+2, nx+2) ghost-padded field (corners never read)."""
    left, right = _ghosts(u, 1, bc[0], bc[1])
    mid = torch.cat([left, u, right], dim=1)
    bottom, top = _ghosts(mid, 0, bc[2], bc[3])
    return torch.cat([bottom, mid, top], dim=0)


def step_plain(u: torch.Tensor, s: Scheme) -> torch.Tensor:
    """One step of the scheme as written: FTCS diffusion plus the donor-cell
    advection increment, every neighbour read from the old field."""
    up = pad(u, s.bc)
    c = up[1:-1, 1:-1]
    xm, xp = up[1:-1, :-2], up[1:-1, 2:]
    ym, yp = up[:-2, 1:-1], up[2:, 1:-1]
    lap = (xp - 2.0 * c + xm) / (s.dx * s.dx) + (yp - 2.0 * c + ym) / (s.dy * s.dy)
    dudx = (c - xm) / s.dx if s.vx >= 0.0 else (xp - c) / s.dx
    dudy = (c - ym) / s.dy if s.vy >= 0.0 else (yp - c) / s.dy
    return c + (s.dt * s.D) * lap - s.dt * (s.vx * dudx + s.vy * dudy)


def evolve_plain(u: torch.Tensor, s: Scheme, steps: int) -> torch.Tensor:
    for _ in range(steps):
        u = step_plain(u, s)
    return u


@dataclass(frozen=True)
class Hotspot:
    """A Gaussian hotspot: ``A exp(-r^2 / (2 sigma^2))`` at cell centres,
    with ``sigma = sigma_frac min(Lx, Ly)`` and the centre at
    ``(xc_frac Lx, yc_frac Ly)``."""

    A: float
    sigma_frac: float
    xc_frac: float
    yc_frac: float

    def profiles(self, s: Scheme, dtype=torch.float64, device="cpu"):
        """(gy, gx): the field is ``A * gy[:, None] * gx[None, :]``."""
        lx, ly = s.nx * s.dx, s.ny * s.dy
        sig = self.sigma_frac * min(lx, ly)
        x = (torch.arange(s.nx, dtype=dtype, device=device) + 0.5) * s.dx
        y = (torch.arange(s.ny, dtype=dtype, device=device) + 0.5) * s.dy
        gx = torch.exp(-((x - self.xc_frac * lx) ** 2) / (2.0 * sig * sig))
        gy = torch.exp(-((y - self.yc_frac * ly) ** 2) / (2.0 * sig * sig))
        return gy, gx

    def field(self, s: Scheme, dtype=torch.float64, device="cpu") -> torch.Tensor:
        gy, gx = self.profiles(s, dtype, device)
        return self.A * gy[:, None] * gx[None, :]


def split(s: Scheme) -> Tuple[float, float]:
    """(a, b), a + b = 1: the shares of the update given to the x and y
    parts, in proportion to the weight each takes from the centre, so both
    centres stay non-negative.  Raises when the scheme's own centre weight
    is negative (a step that is not monotone has no such split)."""
    cx, cy = -s.axis_weights("x")[2], -s.axis_weights("y")[2]
    if cx + cy > 1.0:
        raise ValueError(f"the centre weight {1.0 - cx - cy:g} is negative")
    if cx + cy == 0.0:
        return 0.5, 0.5
    a = cx / (cx + cy)
    return a, 1.0 - a


def _axis_step(v: torch.Tensor, lo: str, hi: str, wm: float, wp: float, w0: float) -> torch.Tensor:
    """One step of a 1-D part on column vectors ``v`` (n, J)."""
    below, above = _ghosts(v, 0, lo, hi)
    vm = torch.cat([below, v[:-1]], dim=0)
    vp = torch.cat([v[1:], above], dim=0)
    return w0 * v + wm * vm + wp * vp


def binomial_window(steps: int, a: float) -> Tuple[int, torch.Tensor]:
    """(j0, weights): the binomial weights ``C(S, j) a^j (1-a)^(S-j)`` for
    j = j0, j0 + 1, ... that lie within exp(-LOG_CUT) of the largest."""
    b = 1.0 - a
    if a <= 0.0 or b <= 0.0:
        return (steps if b <= 0.0 else 0), torch.ones(1, dtype=torch.float64)
    j = torch.arange(steps + 1, dtype=torch.float64)
    logw = (math.lgamma(steps + 1) - torch.lgamma(j + 1) - torch.lgamma(steps - j + 1)
            + j * math.log(a) + (steps - j) * math.log(b))
    keep = torch.nonzero(logw > logw.max() - LOG_CUT).flatten()
    j0, j1 = int(keep[0]), int(keep[-1])
    w = torch.exp(logw[j0:j1 + 1])
    # The weights sum to 1 less what was cut (below round-off); lgamma's
    # round-off at large S (~1e-11 in the log) is shared by them all, and
    # dividing by their sum removes it.
    return j0, w / w.sum()


def _powers(v: torch.Tensor, s: Scheme, axis: str, share: float, first: int,
            count: int) -> torch.Tensor:
    """``P^k v`` for k = first .. first + count - 1 (P the axis part over
    ``share``), stacked as (count, n, J)."""
    wm, wp, w0 = s.axis_weights(axis)
    lo, hi = (s.bc[0], s.bc[1]) if axis == "x" else (s.bc[2], s.bc[3])
    wm, wp, w0 = wm / share, wp / share, 1.0 + w0 / share

    def step(u):
        return _axis_step(u, lo, hi, wm, wp, w0)

    # P^first v by squaring P as a dense matrix (its columns are P applied
    # to the unit vectors): every entry is non-negative, so the products
    # lose nothing to cancellation.  Then one step at a time through the
    # window.
    n = v.shape[0]
    base = step(torch.eye(n, dtype=v.dtype, device=v.device))
    e = first
    while e:
        if e & 1:
            v = base @ v
        e >>= 1
        if e:
            base = base @ base
    del base
    out = torch.empty((count,) + tuple(v.shape), dtype=v.dtype, device=v.device)
    for k in range(count):
        out[k] = v
        if k + 1 < count:
            v = step(v)
    return out


def evolve_separable(spots: Sequence[Hotspot], s: Scheme, steps: int,
                     window: Optional[Tuple[int, int, int, int]] = None,
                     device="cpu") -> List[torch.Tensor]:
    """The fields of each hotspot after ``steps`` steps, float64, each cut
    to ``window`` (y0, y1, x0, x1), default the whole grid."""
    return evolve_separable_series(spots, s, [steps], window, device)[0]


def evolve_separable_series(spots: Sequence[Hotspot], s: Scheme, counts: Sequence[int],
                            window: Optional[Tuple[int, int, int, int]] = None,
                            device="cpu") -> List[List[torch.Tensor]]:
    """For each number of steps in ``counts``, the fields of each hotspot
    after that many steps, as :func:`evolve_separable` gives them.  The
    powers of each 1-D part are taken once for all the counts: by squaring
    up to the lowest power any count needs, then one step at a time up to
    the highest, so a series of snapshots costs about as much as its last."""
    y0, y1, x0, x1 = window if window is not None else (0, s.ny, 0, s.nx)
    a, b = split(s)
    weights = [binomial_window(steps, a) for steps in counts]
    prof = [h.profiles(s, torch.float64, device) for h in spots]
    gy = torch.stack([p[0] for p in prof], dim=1)  # (ny, J)
    gx = torch.stack([p[1] for p in prof], dim=1)  # (nx, J)
    # Term i of a count S takes the x part ^ (j0 + i) and the y part ^
    # (S - j0 - i).  A part with no share has no weights: only its power 0
    # appears.
    xlo = min(j0 for j0, _ in weights)
    xhi = max(j0 + w.numel() for j0, w in weights)
    ylo = min(steps - j0 - w.numel() + 1 for steps, (j0, w) in zip(counts, weights))
    yhi = max(steps - j0 + 1 for steps, (j0, _) in zip(counts, weights))
    xs = _powers(gx, s, "x", a, xlo, xhi - xlo) if a > 0.0 else gx[None]
    ys = _powers(gy, s, "y", b, ylo, yhi - ylo) if b > 0.0 else gy[None]
    out = []
    for steps, (j0, w) in zip(counts, weights):
        m = w.numel()
        w = w.to(device)
        px_all = xs[j0 - xlo:j0 - xlo + m] if a > 0.0 else xs
        py_all = ys[steps - j0 - m + 1 - ylo:steps - j0 + 1 - ylo].flip(0) if b > 0.0 else ys
        fields = []
        for i, h in enumerate(spots):
            px = px_all[:, x0:x1, i]        # (m, nx')
            py = py_all[:, y0:y1, i]        # (m, ny')
            fields.append(h.A * (py.T @ (w[:, None] * px)))
        out.append(fields)
    return out


def max_error(program: torch.Tensor, ref: torch.Tensor) -> float:
    """The largest absolute gap between a program's field and the
    reference's, in float64 (NaN when the program's field holds one)."""
    d = (program.to(torch.float64) - ref.to(program.device)).abs()
    if torch.isnan(d).any():
        return math.nan
    return float(d.max()) if d.numel() else 0.0


def tile_windows(s: Scheme, mesh: Optional[Sequence[int]], tiles) -> Dict[Tuple[int, int], Tuple[int, int, int, int]]:
    """Each local tile's global (y0, y1, x0, x1) on an even (py, px) mesh:
    ``tiles`` is a grid of tensors with None for another rank's tile."""
    py, px = mesh
    ty, tx = s.ny // py, s.nx // px
    return {(y, x): (y * ty, (y + 1) * ty, x * tx, (x + 1) * tx)
            for y, row in enumerate(tiles) for x, t in enumerate(row) if t is not None}
