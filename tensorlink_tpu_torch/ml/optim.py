"""Distributed optimizer handle (port of ``tensorlink_tpu/ml/optim.py``).

Each stage's worker runs the optimizer (``engine/optimizers.py``, optax's
formulas) on its own parameters: the fan-out carries only the op and a
gradient scale, and completion is the tensor-request reply (no polling)."""

from __future__ import annotations

from typing import Any


class DistributedOptimizer:
    """Thin handle over the per-stage optimizers of one job."""

    def __init__(self, model, name: str = "adamw", **spec: Any):
        self.model = model
        self.name = name
        self.spec = spec
        model.init_optimizer(name, **spec)

    def step(self, scale: float = 1.0) -> dict:
        """Apply accumulated gradients on every stage. ``scale`` multiplies
        the accumulated cotangent sums first (DistributedModel.train_step
        passes 1/total_tokens; manual training loops usually pass 1.0)."""
        return self.model.optimizer_step(scale=scale)

    def zero_grad(self) -> None:
        self.model.zero_grad()


def create_distributed_optimizer(model, name: str = "adamw", **spec: Any):
    """The optimizer of a training job: a name and kwargs, resolved by
    ``engine/training.py::make_optimizer`` on each worker."""
    return DistributedOptimizer(model, name, **spec)
