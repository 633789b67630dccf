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
The presets take an optional global window ``(y0, y1, x0, x1)`` and build
only that block, from global coordinates, bitwise equal to the same slice
of the whole field: :func:`device_initial_condition` builds a mesh's tiles
that way, and reads a file IC by regions, so no tile's owner ever builds
or reads the (ny, nx) field.
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ..config import SimConfig

# The config's precision names and the tensor dtypes they store the field in.
DTYPES = {"f32": torch.float32, "f64": torch.float64, "bf16": torch.bfloat16}

Window = Tuple[int, int, int, int]  # (y0, y1, x0, x1), global, half-open


def _window(cfg: SimConfig, window: Optional[Window]) -> Window:
    return window if window is not None else (0, cfg.ny, 0, cfg.nx)


def gaussian_hotspot(
    cfg: SimConfig, dtype=torch.float32, device="cpu", window: Optional[Window] = None
) -> torch.Tensor:
    """Gaussian bump at cell centers (reference: init.cpp:12-33)."""
    nx, ny = cfg.nx, cfg.ny
    y0, y1, x0, x1 = _window(cfg, window)
    Lx = nx * cfg.dx
    Ly = ny * cfg.dy
    xc = cfg.ic.xc_frac * Lx
    yc = cfg.ic.yc_frac * Ly
    sig = cfg.ic.sigma_frac * min(Lx, Ly)

    # Coordinates are computed in at-least-f32 regardless of the storage dtype
    # so that bf16 runs still place the bump at the right cells.
    coord_dtype = torch.float64 if dtype == torch.float64 else torch.float32
    x = (torch.arange(x0, x1, dtype=coord_dtype, device=device) + 0.5) * cfg.dx
    y = (torch.arange(y0, y1, dtype=coord_dtype, device=device) + 0.5) * cfg.dy
    r2 = (x[None, :] - xc) ** 2 + (y[:, None] - yc) ** 2
    u = cfg.ic.A * torch.exp(-r2 / (2.0 * sig * sig))
    return u.to(dtype)


def constant_zero(
    cfg: SimConfig, dtype=torch.float32, device="cpu", window: Optional[Window] = None
) -> torch.Tensor:
    y0, y1, x0, x1 = _window(cfg, window)
    return torch.zeros((y1 - y0, x1 - x0), dtype=dtype, device=device)


def _check_file_shape(cfg: SimConfig, shape) -> None:
    if shape != (cfg.ny, cfg.nx):
        raise ValueError(
            f"IC shape {shape} does not match grid (ny={cfg.ny}, nx={cfg.nx})"
        )


def _ic_path(cfg: SimConfig) -> str:
    if not cfg.ic.path:
        raise ValueError("ic.mode='file' requires ic.path")
    return cfg.ic.path


def from_file(cfg: SimConfig, dtype=torch.float32, device="cpu") -> torch.Tensor:
    """Read the IC from a NetCDF file (classic CDF-1/2/5 or NETCDF4/HDF5);
    a 3D ``(time, y, x)`` variable restarts from its last record."""
    from ..io.datasets import load_field

    data = load_field(_ic_path(cfg), cfg.ic.var or "u")
    _check_file_shape(cfg, data.shape)
    return torch.as_tensor(data, dtype=dtype, device=device)


def _preset(cfg: SimConfig) -> Callable:
    """The preset's builder (init.cpp:35-42)."""
    if cfg.ic.preset == "gaussian_hotspot":
        return gaussian_hotspot
    if cfg.ic.preset == "constant_zero":
        return constant_zero
    raise ValueError(f"Unknown IC preset: {cfg.ic.preset}")


def apply_initial_condition(
    cfg: SimConfig, dtype=torch.float32, device="cpu"
) -> torch.Tensor:
    """Dispatch on ic.mode/preset (reference: init.cpp:35-47)."""
    if cfg.ic.mode == "preset":
        return _preset(cfg)(cfg, dtype, device)
    if cfg.ic.mode == "file":
        return from_file(cfg, dtype, device)
    raise ValueError(f"Unknown IC mode: {cfg.ic.mode}")


def device_initial_condition(cfg: SimConfig, dtype, mesh, embed_from=None):
    """The IC as this process's tiles of ``mesh`` (None for another rank's),
    each built on its device from its global window
    (:func:`..parallel.mesh.local_windows`), or, with ``embed_from`` (the
    carrier advance's), as carrier tiles whose true extents are built so.

    Presets compute each block from global cell coordinates.  A file IC is
    opened once per process (``io.datasets.open_field``) and each block is a
    positioned read of its region (``read_region``), the read-side analogue
    of the writer's per-rank hyperslabs (reference: io.cpp:402-424)."""
    from ..parallel.mesh import local_windows

    def place(block: Callable[[Window, torch.device], torch.Tensor]):
        if embed_from is not None:
            return embed_from(block, dtype)
        tiles = [[None] * mesh.shape["x"] for _ in range(mesh.shape["y"])]
        for (y, x), w in local_windows(mesh, cfg.ny, cfg.nx).items():
            tiles[y][x] = block(w, mesh.devices[y][x]).contiguous()
        return tiles

    if cfg.ic.mode == "preset":
        build = _preset(cfg)
        return place(lambda w, dev: build(cfg, dtype, dev, w))
    if cfg.ic.mode == "file":
        from ..io.datasets import open_field

        with open_field(_ic_path(cfg), cfg.ic.var or "u") as h:
            _check_file_shape(cfg, h.shape)
            return place(lambda w, dev: torch.as_tensor(
                h.read_region(w[0], w[1] - w[0], w[2], w[3] - w[2]),
                dtype=dtype, device=dev))
    raise ValueError(f"Unknown IC mode: {cfg.ic.mode}")
