"""Parallelism layer of the port: the device mesh and its logical rules
(parallel/mesh.py). The reference's collectives (``parallel/collectives.py``)
and process groups (``parallel/distributed.py``) wait for sharded training
on ``torch.distributed`` (ROADMAP.md, Queue A)."""

from ray_tpu_torch.parallel.mesh import (AXIS_DATA, AXIS_EXPERT,  # noqa: F401
                                         AXIS_FSDP, AXIS_PIPE, AXIS_SEQ,
                                         AXIS_TENSOR, Mesh, MeshConfig,
                                         current_mesh, default_logical_rules,
                                         make_mesh, use_mesh)

__all__ = [
    "AXIS_DATA", "AXIS_EXPERT", "AXIS_FSDP", "AXIS_PIPE", "AXIS_SEQ",
    "AXIS_TENSOR", "Mesh", "MeshConfig", "current_mesh",
    "default_logical_rules", "make_mesh", "use_mesh",
]
