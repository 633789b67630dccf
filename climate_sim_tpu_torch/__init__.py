"""climate_sim_tpu_torch — the PyTorch/CUDA port of climate_sim_tpu.

Explicit FTCS diffusion + first-order upwind advection of a passive scalar on
a 2D grid with per-side Dirichlet/Neumann/periodic BCs, the same config
surface, snapshots and CLI contract as the JAX package, run on one device.
The hot path is K1, a hand-written CUDA kernel that advances k steps per pass
over device memory (:mod:`.ops.cuda_stencil`, ``csrc/multistep_stencil.cu``).

Layers:

* :mod:`climate_sim_tpu_torch.config`   — config system (a copy of the JAX one)
* :mod:`climate_sim_tpu_torch.ops`      — stencil, BCs, ICs, K1 and the advance
* :mod:`climate_sim_tpu_torch.io`       — NetCDF codec + snapshots
* :mod:`climate_sim_tpu_torch.runtime`  — driver + CLI
* :mod:`climate_sim_tpu_torch.convert`  — config and field from the JAX package

The package never imports ``jax``.
"""

from .config import (
    BCConfig,
    BCType,
    ICConfig,
    SimConfig,
    bc_from_string,
    bc_to_string,
    load_yaml_file,
    merged_config,
    parse_cli_overrides,
)
from .ops.stability import safe_dt

__version__ = "0.1.0"

__all__ = [
    "BCConfig",
    "BCType",
    "ICConfig",
    "SimConfig",
    "bc_from_string",
    "bc_to_string",
    "load_yaml_file",
    "merged_config",
    "parse_cli_overrides",
    "safe_dt",
    "__version__",
]
