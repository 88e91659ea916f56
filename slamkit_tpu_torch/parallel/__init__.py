"""Several processes, one card each: the mesh (`mesh.py`) and the
parameter sharding over its 'data' axis (`fsdp.py`)."""
from .mesh import (KNOWN_AXES, Mesh, RowTile, Shard, all_reduce_grads, check_mesh, fsdp_spec,
                   init_distributed, local_tile, make_mesh, seq_axis_size)

__all__ = ["KNOWN_AXES", "Mesh", "RowTile", "Shard", "all_reduce_grads", "check_mesh",
           "fsdp_spec", "init_distributed", "local_tile", "make_mesh", "seq_axis_size"]
