"""Train state: the model (parameters and BatchNorm statistics), its
optimizer, the learning-rate schedule and the update count.

Port of infantposeestimation_gaussianbias_tpu/train/state.py.  The JAX
state is an immutable pytree; this one is updated in place by
``apply_gradients``.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.nn as nn

from .optim import Schedule


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    grad_clip_norm: float = 0.0  # 0 disables
    step: int = 0

    @property
    def params(self) -> list[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``, at the lr
        the schedule gives for the update count before the increment, after
        the optional clip by global norm; then ``step += 1``."""
        grads = [p.grad for p in self.params]
        if self.grad_clip_norm > 0:
            norm = optax_global_norm(grads)
            # optax.clip_by_global_norm: g if norm < max else g / norm * max
            scale = torch.where(norm < self.grad_clip_norm, 1.0,
                                self.grad_clip_norm / norm)
            torch._foreach_mul_(grads, scale)
        lr = self.schedule(self.step)
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.step()
        self.step += 1


def optax_global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares of every element, in float32 (optax's
    ``global_norm``), as the norm of the per-tensor norms."""
    norms = torch._foreach_norm([t.float() for t in tensors])
    return torch.linalg.vector_norm(torch.stack(norms))
