"""Initial conditions on tensors (reference: src/init.cpp).

The port of ``climate_sim_tpu/ops/init.py``.  Presets:

* ``gaussian_hotspot`` — ``A * exp(-r^2 / (2 sigma^2))`` evaluated at cell
  centers ``x = (gi + 0.5) dx`` with ``sigma = sigma_frac * min(Lx, Ly)``
  (init.cpp:12-33).
* ``constant_zero`` — zeros (init.cpp:39-40).
* Unknown presets raise (init.cpp:41-42).

``ic.mode == "file"`` reads the variable (default ``u``) from a NetCDF file;
a 3D ``(time, y, x)`` variable restarts from its last snapshot.

Every IC function takes the device explicitly and makes the field there.
"""

from __future__ import annotations

import torch

from ..config import SimConfig

# The config's precision names and the tensor dtypes they store the field in.
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}


def gaussian_hotspot(
    cfg: SimConfig, dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """Gaussian bump at cell centers (reference: init.cpp:12-33)."""
    nx, ny = cfg.nx, cfg.ny
    Lx = nx * cfg.dx
    Ly = ny * cfg.dy
    xc = cfg.ic.xc_frac * Lx
    yc = cfg.ic.yc_frac * Ly
    sig = cfg.ic.sigma_frac * min(Lx, Ly)

    # Coordinates are computed in at-least-f32 regardless of the storage dtype
    # so that bf16 runs still place the bump at the right cells.
    coord_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    x = (torch.arange(nx, dtype=coord_dtype, device=device) + 0.5) * cfg.dx
    y = (torch.arange(ny, dtype=coord_dtype, device=device) + 0.5) * cfg.dy
    r2 = (x[None, :] - xc) ** 2 + (y[:, None] - yc) ** 2
    u = cfg.ic.A * torch.exp(-r2 / (2.0 * sig * sig))
    return u.to(dtype)


def constant_zero(cfg: SimConfig, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.zeros((cfg.ny, cfg.nx), dtype=dtype, device=device)


def from_file(cfg: SimConfig, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Read the IC from a NetCDF file (classic CDF-1/2/5 or NETCDF4/HDF5);
    a 3D ``(time, y, x)`` variable restarts from its last record."""
    from ..io.datasets import load_field

    path = cfg.ic.path
    if not path:
        raise ValueError("ic.mode='file' requires ic.path")
    data = load_field(path, cfg.ic.var or "u")
    if data.shape != (cfg.ny, cfg.nx):
        raise ValueError(
            f"IC shape {data.shape} does not match grid (ny={cfg.ny}, nx={cfg.nx})"
        )
    return torch.as_tensor(data, dtype=dtype, device=device)


def apply_initial_condition(
    cfg: SimConfig, dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """Dispatch on ic.mode/preset (reference: init.cpp:35-47)."""
    if cfg.ic.mode == "preset":
        if cfg.ic.preset == "gaussian_hotspot":
            return gaussian_hotspot(cfg, dtype, device)
        if cfg.ic.preset == "constant_zero":
            return constant_zero(cfg, dtype, device)
        raise ValueError(f"Unknown IC preset: {cfg.ic.preset}")
    if cfg.ic.mode == "file":
        return from_file(cfg, dtype, device)
    raise ValueError(f"Unknown IC mode: {cfg.ic.mode}")
