"""The sharded paths: a tile mesh over a list of torch devices
(:mod:`.mesh`) and the halo exchanges and advances on it (:mod:`.halo`),
for grids the mesh divides and for grids it does not; the port of
``climate_sim_tpu/parallel``."""

from .halo import (
    axis_wrap_flags,
    build_carrier_slab_advance,
    build_padded_advance,
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
    split_sizes,
)

__all__ = [
    "Mesh",
    "axis_wrap_flags",
    "build_carrier_slab_advance",
    "build_padded_advance",
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
    "split_sizes",
]
