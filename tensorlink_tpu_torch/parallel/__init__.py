"""Parallelism: device meshes and tensors placed on them (``mesh``), the
sharding planner (``planner``), the capacity-limited MoE dispatch on one
device or over an expert axis (``expert``), the GPipe schedule over a
``stage`` axis (``pipeline``) and ring attention over a ``seq`` axis with
the quantized collectives (``ring``)."""

from .expert import sparse_moe_mlp
from .mesh import MeshPlan, build_mesh, local_mesh
from .planner import ShardingPlan, plan_sharding

__all__ = [
    "MeshPlan",
    "ShardingPlan",
    "build_mesh",
    "local_mesh",
    "plan_sharding",
    "sparse_moe_mlp",
]
