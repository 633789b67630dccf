"""Boundary conditions and ghost-ring construction on tensors.

The port of ``climate_sim_tpu/ops/boundary.py``.  The reference keeps a
halo-padded per-rank tile and rewrites the ghost ring in place each step
(halo.cpp:6-49, then boundary.cpp:12-54):

* Dirichlet: ghost = value (always 0.0 in the driver, main.cpp:102),
* Neumann: ghost mirrors the adjacent interior cell,
* Periodic: the reference has **no branch**, so its ghosts keep their
  initial fill(0.0) forever and its "periodic" is numerically Dirichlet(0).

Here the state is the interior (ny, nx) tensor; each step builds a
ghost-padded (ny+2, nx+2) tensor with the BC values baked in.  Periodic is a
true wrap; ``compat=True`` reproduces the reference's stale-zero ghosts.
Corner ghosts are never read by the 5-point stencils.
"""

from __future__ import annotations

import torch

from ..config import BCConfig, BCType


def _ghost_line(side_bc: BCType, mirror, wrap, value: float, compat: bool):
    """Ghost values for one face.  ``mirror`` is the adjacent interior line,
    ``wrap`` the opposite-edge interior line."""
    if side_bc == BCType.DIRICHLET:
        return torch.full_like(mirror, value)
    if side_bc == BCType.NEUMANN:
        return mirror
    # periodic
    if compat:
        # Reference behavior: ghosts on a periodic physical edge are never
        # written after the initial fill(0.0) => always zero.
        return torch.zeros_like(mirror)
    return wrap


def pad_with_ghosts(
    u: torch.Tensor,
    bc: BCConfig,
    value: float = 0.0,
    compat: bool = False,
) -> torch.Tensor:
    """Return the (ny+2, nx+2) ghost-padded field for interior ``u`` (ny, nx).

    Layout is (y, x): dim 0 is y (bottom..top), dim 1 is x (left..right),
    the reference's storage and NetCDF order (io.cpp:389-394).
    """
    left = _ghost_line(bc.left, u[:, 0], u[:, -1], value, compat)
    right = _ghost_line(bc.right, u[:, -1], u[:, 0], value, compat)
    mid = torch.cat([left[:, None], u, right[:, None]], dim=1)

    bottom = _ghost_line(bc.bottom, mid[0, :], mid[-1, :], value, compat)
    top = _ghost_line(bc.top, mid[-1, :], mid[0, :], value, compat)
    return torch.cat([bottom[None, :], mid, top[None, :]], dim=0)


def apply_boundary(
    u_padded: torch.Tensor,
    bc: BCConfig,
    value: float = 0.0,
    compat: bool = False,
) -> torch.Tensor:
    """Analogue of the reference's in-place ``apply_boundary``
    (boundary.cpp:12-54) on an already-padded (ny+2, nx+2) tensor of the
    GLOBAL field: returns a new padded tensor with the ghost ring rewritten
    per the BCs, i.e. ``pad_with_ghosts(u_padded[1:-1, 1:-1], ...)``."""
    interior = u_padded[1:-1, 1:-1]
    return pad_with_ghosts(interior, bc, value, compat)
