"""Parallelism layer of the port: the device mesh and its logical rules
(parallel/mesh.py), the process group (parallel/distributed.py) and the
collectives over a mesh's named axes (parallel/collectives.py)."""

from ray_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,  # noqa: F401
                                         AXIS_FSDP, AXIS_PIPE, AXIS_SEQ,
                                         AXIS_TENSOR, Mesh, MeshConfig,
                                         RankMesh, current_mesh,
                                         default_logical_rules,
                                         logical_sharding, make_mesh,
                                         make_rank_mesh, use_mesh)
from ray_tpu_torch.parallel.collectives import (  # noqa: F401
    CollectiveGroup, allgather, allreduce, barrier, broadcast, reducescatter,
    send_recv)

__all__ = [
    "AXIS_DATA", "AXIS_EXPERT", "AXIS_FSDP", "AXIS_PIPE", "AXIS_SEQ",
    "AXIS_TENSOR", "Mesh", "MeshConfig", "RankMesh", "current_mesh",
    "default_logical_rules", "logical_sharding", "make_mesh",
    "make_rank_mesh", "use_mesh",
    "CollectiveGroup", "allgather", "allreduce", "barrier", "broadcast",
    "reducescatter", "send_recv",
]
