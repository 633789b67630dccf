"""Core stencil operators on tensors: FTCS diffusion, donor-cell upwind
advection, and the fused unsplit forward-Euler update.

The port of ``climate_sim_tpu/ops/stencil.py``; numerics match the reference:

* diffusion (diffusion.cpp:3-16):
  ``out = u + dt*D*[ (u_{i+1}-2u+u_{i-1})/dx^2 + (u_{j+1}-2u+u_{j-1})/dy^2 ]``
* advection (advection.cpp:5-33): first-order donor-cell upwind with constant
  velocity; ``vx >= 0`` selects the backward difference, and the advective
  tendency *accumulates* onto the diffusion output, so one step is the
  unsplit Euler update reading the same old u (main.cpp:104-109).

All functions take a ghost-padded (ny+2, nx+2) tensor and return the updated
interior (ny, nx).  Velocity signs are config constants, resolved in Python.
These are the plain per-step path; the kernel path is
:mod:`climate_sim_tpu_torch.ops.cuda_stencil`.
"""

from __future__ import annotations

import torch


def _neighborhood(up: torch.Tensor):
    """Center and 4-neighbor views of a padded tensor."""
    c = up[1:-1, 1:-1]
    xm = up[1:-1, :-2]
    xp = up[1:-1, 2:]
    ym = up[:-2, 1:-1]
    yp = up[2:, 1:-1]
    return c, xm, xp, ym, yp


def laplacian(up: torch.Tensor, dx: float, dy: float) -> torch.Tensor:
    c, xm, xp, ym, yp = _neighborhood(up)
    return (xp - 2.0 * c + xm) / (dx * dx) + (yp - 2.0 * c + ym) / (dy * dy)


def diffusion_step(up: torch.Tensor, D: float, dt: float, dx: float, dy: float) -> torch.Tensor:
    """Interior FTCS update (reference: diffusion.cpp:3-16)."""
    c = up[1:-1, 1:-1]
    return c + (dt * D) * laplacian(up, dx, dy)


def upwind_gradient(up: torch.Tensor, vx: float, vy: float, dx: float, dy: float):
    """Donor-cell one-sided differences, sign-switched like advection.cpp:16-27.

    ``vx >= 0`` (including 0) uses the backward difference, matching the
    reference's ``if (vx >= 0.0)`` branch.
    """
    c, xm, xp, ym, yp = _neighborhood(up)
    if vx >= 0.0:
        dudx = (c - xm) / dx
    else:
        dudx = (xp - c) / dx
    if vy >= 0.0:
        dudy = (c - ym) / dy
    else:
        dudy = (yp - c) / dy
    return dudx, dudy


def advection_increment(
    up: torch.Tensor, vx: float, vy: float, dt: float, dx: float, dy: float
) -> torch.Tensor:
    """The advective tendency ``-dt*(vx*du/dx + vy*du/dy)`` that the reference
    accumulates onto the diffusion output (advection.cpp:29-31)."""
    dudx, dudy = upwind_gradient(up, vx, vy, dx, dy)
    return (-dt) * (vx * dudx + vy * dudy)


def advection_step(
    up: torch.Tensor, base: torch.Tensor, vx: float, vy: float, dt: float, dx: float, dy: float
) -> torch.Tensor:
    """Accumulating form: ``base + increment`` (advection.cpp:29-31)."""
    return base + advection_increment(up, vx, vy, dt, dx, dy)


def fused_step(
    up: torch.Tensor,
    D: float,
    vx: float,
    vy: float,
    dt: float,
    dx: float,
    dy: float,
) -> torch.Tensor:
    """One unsplit forward-Euler step on a padded tensor -> new interior:
    diffusion_step followed by the accumulating advection_step
    (main.cpp:106-107), all neighbor reads from the same old ``up``."""
    out = diffusion_step(up, D, dt, dx, dy)
    if vx != 0.0 or vy != 0.0:
        out = advection_step(up, out, vx, vy, dt, dx, dy)
    return out


def fused_step_storage(up, D, vx, vy, dt, dx, dy):
    """:func:`fused_step` with bf16-STORAGE semantics: bf16 inputs compute
    in f32 and round once on output, like the kernel's one rounding per
    pass.  Other dtypes pass through unchanged."""
    if up.dtype == torch.bfloat16:
        return fused_step(
            up.to(torch.float32), D, vx, vy, dt, dx, dy
        ).to(torch.bfloat16)
    return fused_step(up, D, vx, vy, dt, dx, dy)
