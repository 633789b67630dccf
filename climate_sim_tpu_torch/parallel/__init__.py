"""The sharded path on grids the mesh divides: a tile mesh over a list of
torch devices (:mod:`.mesh`) and the halo exchanges and advances on it
(:mod:`.halo`), the port of ``climate_sim_tpu/parallel``."""

from .halo import (
    axis_wrap_flags,
    build_sharded_advance,
    build_sharded_multistep_advance,
    build_sharded_overlap_advance,
    exchange_and_pad,
    exchange_halos_k,
    exchange_halos_slabs,
)
from .mesh import (
    Mesh,
    choose_mesh_shape,
    dims_create,
    divisible,
    gather_field,
    make_mesh,
    shard_field,
)

__all__ = [
    "Mesh",
    "axis_wrap_flags",
    "build_sharded_advance",
    "build_sharded_multistep_advance",
    "build_sharded_overlap_advance",
    "choose_mesh_shape",
    "dims_create",
    "divisible",
    "exchange_and_pad",
    "exchange_halos_k",
    "exchange_halos_slabs",
    "gather_field",
    "make_mesh",
    "shard_field",
]
