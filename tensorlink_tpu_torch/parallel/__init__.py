"""Parallelism: device meshes and tensors placed on them (``mesh``), the
sharding planner (``planner``) and the capacity-limited MoE dispatch on
one device (``expert``)."""

from .mesh import MeshPlan, build_mesh, local_mesh
from .planner import ShardingPlan, plan_sharding

__all__ = [
    "MeshPlan",
    "ShardingPlan",
    "build_mesh",
    "local_mesh",
    "plan_sharding",
]
