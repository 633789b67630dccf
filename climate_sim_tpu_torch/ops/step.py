"""Step-function assembly: picks the interior step and the single-device
advance.

The reference's time-loop body (main.cpp:101-109) is: halo exchange ->
apply_boundary -> copy -> diffusion_step -> advection_step (accumulating) ->
swap.  Functionally that is ``u' = fused_step(pad_with_ghosts(u))``, which
the plain per-step path computes here; the kernel path computes the same
``k`` steps at a time in K1 (:mod:`.cuda_stencil`), and the per-step
sharded path one step per tile in K2 (:mod:`.cuda_sharded`).
"""

from __future__ import annotations

from typing import Callable

import torch

from ..config import SimConfig
from .boundary import pad_with_ghosts
from .stencil import fused_step, fused_step_storage

# Config values that select the hand-written kernel (the JAX package's
# names, kept so one config drives both packages).
KERNEL_VALUES = ("pallas", "pallas_multistep")


def select_kernel(cfg: SimConfig, device) -> str:
    """Resolve kernel='auto': the kernel iff the run's device is CUDA."""
    if cfg.kernel != "auto":
        return cfg.kernel
    return "pallas" if torch.device(device).type == "cuda" else "jnp"


def make_interior_step(
    cfg: SimConfig, dt: float
) -> Callable[[torch.Tensor], torch.Tensor]:
    """Return fn: ghost-padded tile (my+2, mx+2) -> updated interior (my, mx).
    With the kernel named (``pallas``/``pallas_multistep``) that is K2,
    which runs its plain version on a CPU tile; otherwise (``jnp``, and
    ``auto``, which has no device to resolve against here) torch ops."""
    if cfg.kernel in KERNEL_VALUES:
        from .cuda_sharded import make_pallas_interior_step

        return make_pallas_interior_step(cfg, dt)

    def step(up: torch.Tensor) -> torch.Tensor:
        # bf16 is a STORAGE format: f32 arithmetic, one rounding per step.
        return fused_step_storage(up, cfg.D, cfg.vx, cfg.vy, dt, cfg.dx, cfg.dy)

    return step


def build_single_device_advance(cfg: SimConfig, dt: float, device):
    """``advance(k)`` -> fn advancing the global (ny, nx) field k steps on
    one device.  With the kernel selected, chunks run as K1 passes of up to
    8 steps (:func:`.cuda_stencil.build_multistep_advance`); otherwise each
    step is pad_with_ghosts + the fused torch-ops stencil.
    ``advance.pass_count(k)`` counts the passes (bf16 rounding events)."""
    if select_kernel(cfg, device) in KERNEL_VALUES:
        from .cuda_stencil import build_multistep_advance

        return build_multistep_advance(cfg, dt)
    interior = make_interior_step(cfg, dt)
    compat = cfg.strict_reference_compat

    def advance(k: int):
        def body(u: torch.Tensor) -> torch.Tensor:
            for _ in range(k):
                u = interior(pad_with_ghosts(u, cfg.bc, 0.0, compat))
            return u

        return body

    advance.pass_count = lambda k: k
    advance.uses_kernel = False
    advance.kernel = None
    return advance


def reference_step(u: torch.Tensor, cfg: SimConfig, dt: float) -> torch.Tensor:
    """One step on the global field (testing convenience)."""
    up = pad_with_ghosts(u, cfg.bc, 0.0, cfg.strict_reference_compat)
    return fused_step(up, cfg.D, cfg.vx, cfg.vy, dt, cfg.dx, cfg.dy)
