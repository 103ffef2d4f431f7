"""Multi-device execution: the mesh and its sharding helpers."""

from .mesh import (AXIS, Mesh, batch_mapped, distributed_init,
                   last_axis_sharded, make_mesh, replicated)

__all__ = ["AXIS", "Mesh", "batch_mapped", "distributed_init",
           "last_axis_sharded", "make_mesh", "replicated"]
