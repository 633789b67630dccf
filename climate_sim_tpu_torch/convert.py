"""Carry a run's state from the JAX package into the port.

The stencil system has no weights; what a run carries is its config and its
field.  :func:`from_reference` takes the JAX package's
``climate_sim_tpu.config.config_to_dict(cfg)`` and a numpy field and returns
the port's :class:`SimConfig` and the field as a tensor on the given device,
in the config's precision; :func:`from_reference_sharded` returns the field
as the tile grid of a mesh instead (the JAX field is then ``np.asarray`` of
a sharded ``jax.Array``), and :func:`.parallel.mesh.gather_field` is its
inverse; :func:`from_reference_local` returns only the tiles that one rank
of a multi-process mesh owns.  It imports nothing from ``climate_sim_tpu``.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import numpy as np
import torch

from .config import SimConfig, load_yaml_dict
from .ops.init import DTYPES
from .parallel.mesh import Mesh, Tiles, local_windows, shard_field


def from_reference(
    cfg_dict: Dict[str, Any], u, device="cpu"
) -> Tuple[SimConfig, torch.Tensor]:
    """(port config, field tensor) from a JAX config dict and a field.

    The dict is the flat form ``config_to_dict`` emits, which the port's
    loader reads back exactly; the config is validated.  The field must
    have the config's (ny, nx) shape.
    """
    cfg = load_yaml_dict(dict(cfg_dict))
    field = np.asarray(u)
    if field.shape != (cfg.ny, cfg.nx):
        raise ValueError(
            f"field shape {field.shape} != (ny={cfg.ny}, nx={cfg.nx})"
        )
    t = torch.tensor(field).to(device=device, dtype=DTYPES[cfg.precision])
    return cfg, t.contiguous()


def from_reference_sharded(
    cfg_dict: Dict[str, Any], u, mesh: Mesh
) -> Tuple[SimConfig, Tiles]:
    """(port config, tile grid on ``mesh``) from a JAX config dict and the
    global field.  A grid the mesh does not divide gives the reference's
    remainder tiles (the per-step path's layout); the carrier path takes
    the global field of :func:`from_reference` through its advance's
    ``embed`` instead."""
    cfg, t = from_reference(cfg_dict, u, "cpu")
    return cfg, shard_field(t, mesh)


def from_reference_local(
    cfg_dict: Dict[str, Any], u, mesh: Mesh
) -> Tuple[SimConfig, Tiles]:
    """The rank-local form of :func:`from_reference_sharded`: (port
    config, this rank's tiles of ``mesh``, None for another rank's) from a
    JAX config dict and the global field as numpy, each tile cut from its
    global window (:func:`.parallel.mesh.local_windows`)."""
    cfg, t = from_reference(cfg_dict, u, "cpu")
    tiles = [[None] * mesh.shape["x"] for _ in range(mesh.shape["y"])]
    for (y, x), (y0, y1, x0, x1) in local_windows(mesh, cfg.ny, cfg.nx).items():
        tiles[y][x] = t[y0:y1, x0:x1].to(mesh.devices[y][x]).contiguous()
    return cfg, tiles
