"""Train state: the model (parameters and BatchNorm statistics), its
optimizer, the learning-rate schedule and the update count.

Port of infantposeestimation_gaussianbias_tpu/train/state.py.  The JAX
state is an immutable pytree; this one is updated in place by
``apply_gradients``.

Under tensor parallelism (parallel/tensor.py) some parameters are a model
rank's block of rows, so the global norm (the clip's and the step's
``grad_norm``) sums the squares of the blocks over the model group and
counts the replicated tensors once: every element once.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict

import torch
import torch.distributed as dist
import torch.nn as nn

from ..parallel.tensor import Shard, sharded_parameters
from .optim import Schedule


@dataclass
class TrainState:
    model: nn.Module
    optimizer: torch.optim.Optimizer
    schedule: Schedule
    grad_clip_norm: float = 0.0  # 0 disables
    step: int = 0
    grid: Any = None  # the ProcessGrid the model was built over
    # {id(parameter): its Shard} of the cut parameters, mapped once: the
    # model is cut before its state is made (create_train_state)
    shards: Dict[int, Shard] = field(init=False, repr=False)

    def __post_init__(self):
        self.shards = sharded_parameters(self.model)

    @property
    def params(self) -> list[torch.nn.Parameter]:
        return [p for g in self.optimizer.param_groups for p in g["params"]]

    def global_norm(self, tensors) -> torch.Tensor:
        """The global norm of ``tensors``, laid out as ``params``."""
        if not self.shards:
            return optax_global_norm(tensors)
        return sharded_global_norm(
            tensors, [id(p) in self.shards for p in self.params],
            next(iter(self.shards.values())).group)

    @torch.no_grad()
    def apply_gradients(self) -> None:
        """One optimizer update from the parameters' ``.grad``, at the lr
        the schedule gives for the update count before the increment, after
        the optional clip by global norm; then ``step += 1``."""
        grads = [p.grad for p in self.params]
        if self.grad_clip_norm > 0:
            norm = self.global_norm(grads)
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


def sharded_global_norm(tensors, sharded, group) -> torch.Tensor:
    """The global norm of tensors of which those flagged in ``sharded`` are
    blocks spread over ``group``: sqrt(sum of the replicated tensors'
    squares + the group's sum of the blocks' squares), in float32."""
    sq = torch.stack(torch._foreach_norm([t.float() for t in tensors])) ** 2
    mask = torch.tensor(sharded, device=sq.device)
    blocks = sq[mask].sum()
    dist.all_reduce(blocks, group=group)
    return torch.sqrt(sq[~mask].sum() + blocks)
