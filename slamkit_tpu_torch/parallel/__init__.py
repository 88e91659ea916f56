"""Several processes, one card each: the mesh (`mesh.py`), the parameter
sharding over its 'data' axis (`fsdp.py`), the layers split over 'model'
(`tensor.py`) and the checks of a process group over several hosts
(`multihost.py`)."""
from .mesh import (KNOWN_AXES, Mesh, RowTile, Shard, Topology, all_reduce_grads, check_mesh,
                   fsdp_spec, init_distributed, local_tile, make_mesh, process_group,
                   seq_axis_size, topology)

__all__ = ["KNOWN_AXES", "Mesh", "RowTile", "Shard", "Topology", "all_reduce_grads",
           "check_mesh", "fsdp_spec", "init_distributed", "local_tile", "make_mesh",
           "process_group", "seq_axis_size", "topology"]
