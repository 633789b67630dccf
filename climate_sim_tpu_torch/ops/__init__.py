from .stability import safe_dt, clamp_dt, combined_dt_limit
from .boundary import pad_with_ghosts, apply_boundary
from .stencil import (
    advection_increment,
    advection_step,
    diffusion_step,
    fused_step,
    fused_step_storage,
    laplacian,
    upwind_gradient,
)
from .init import apply_initial_condition, constant_zero, from_file, gaussian_hotspot
from .step import build_single_device_advance, make_interior_step, reference_step

__all__ = [
    "safe_dt",
    "combined_dt_limit",
    "clamp_dt",
    "pad_with_ghosts",
    "apply_boundary",
    "advection_increment",
    "advection_step",
    "diffusion_step",
    "fused_step",
    "fused_step_storage",
    "laplacian",
    "upwind_gradient",
    "apply_initial_condition",
    "constant_zero",
    "from_file",
    "gaussian_hotspot",
    "build_single_device_advance",
    "make_interior_step",
    "reference_step",
]
