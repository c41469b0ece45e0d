"""Tensor parallelism over the model axis of a process grid.

Port of the tensor-parallel half of infantposeestimation_gaussianbias_tpu/
parallel/mesh.py (``param_sharding_rules``, ``shard_params``,
``sharding_table``).  The JAX package places a kernel with
``P(..., 'model')`` and lets GSPMD partition its matmul; the port, one
process per rank, keeps model rank j's block of output features of each
such weight and writes the collectives out: a column-parallel Linear or
Conv2d (models/layers.py) computes its block locally and assembles the
full width over the model group.

The rule is JAX's, restated on the port's parameter names (the reference
checkpoint's naming, which holds the same tokens as the flax paths): the
weight of a Linear or Conv2d (a flax ``kernel`` of two or more axes)
whose name contains ``shared``, ``qkv``, ``proj``, ``mlp`` or ``fc`` is
cut on its output-feature axis (dim 0 of a torch weight, the last axis of
a flax kernel) when the model axis divides that width; everything else
(biases, norms, RPE tables, weights that do not divide, int8 buffers,
which are no ``kernel`` in the JAX tree either) stays replicated.  Model
rank j holds rows [j k, (j + 1) k), k = out / model, as device j of the
'model' axis holds block j of a ``P(..., 'model')`` array.

The column-parallel product (``column_parallel``) is two autograd
Functions around the local product:

* forward: the local block y_j = f(x, W_j), written into a zero-filled
  full-width tensor that one ``all_reduce`` over the model group
  assembles (adding zeros is exact; gloo's CUDA path has all_reduce and
  broadcast only, so no all_gather), then the replicated bias;
* backward: the rank's block of dy, the local weight gradient dW_j, and
  dx = sum_j dy_j W_j, all-reduced over the model group.

The bias is added to the assembled tensor, as JAX keeps it replicated, so
its gradient is the same on every model rank.  The layers never draw from
a generator: a model is built whole (seeded, or loaded) and then
``shard_params`` slices it, so its weights are the one-process model's.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Callable, Dict, Mapping, Optional

import torch
import torch.distributed as dist
import torch.nn as nn

TP_TOKENS = ("shared", "qkv", "proj", "mlp", "fc")


@dataclass(frozen=True)
class Shard:
    """Where a column-parallel layer's rows sit: block ``index`` of
    ``parts`` over ``group`` (the grid's model group)."""

    group: Any
    index: int
    parts: int


class _ToModelGroup(torch.autograd.Function):
    """Identity forward; the backward sums the input's gradient over the
    model group (each rank's block of outputs gives only its part of
    dx)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _AssembleColumns(torch.autograd.Function):
    """This rank's block of the last axis -> the full width, by one
    all-reduce of a zero-filled tensor; the backward keeps the rank's
    block of the gradient."""

    @staticmethod
    def forward(ctx, y: torch.Tensor, shard: Shard) -> torch.Tensor:
        k = y.shape[-1]
        ctx.cols = slice(shard.index * k, (shard.index + 1) * k)
        full = y.new_zeros(*y.shape[:-1], k * shard.parts)
        full[..., ctx.cols] = y
        dist.all_reduce(full, group=shard.group)
        return full

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad[..., ctx.cols].contiguous(), None


def column_parallel(x: torch.Tensor, weight: torch.Tensor,
                    bias: Optional[torch.Tensor], shard: Shard,
                    product: Callable[[torch.Tensor, torch.Tensor],
                                      torch.Tensor]) -> torch.Tensor:
    """``product(x, weight)`` with ``weight`` this rank's block of output
    rows, assembled over the model group on the last axis, plus the
    replicated ``bias``."""
    y = product(_ToModelGroup.apply(x, shard.group), weight)
    y = _AssembleColumns.apply(y, shard)
    return y if bias is None else y + bias


def assemble_rows(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """A row-sharded tensor (a weight, its gradient, an optimizer moment)
    -> the whole tensor on every model rank (no autograd)."""
    k = t.shape[0]
    full = t.new_zeros(k * shard.parts, *t.shape[1:])
    full[shard.index * k:(shard.index + 1) * k] = t
    dist.all_reduce(full, group=shard.group)
    return full


def local_rows(t: torch.Tensor, shard: Shard) -> torch.Tensor:
    """This rank's block of rows of a whole tensor."""
    k = t.shape[0] // shard.parts
    return t[shard.index * k:(shard.index + 1) * k]


def _parallel_types() -> tuple:
    from ..models.layers import Conv2d, Linear

    return Linear, Conv2d


def param_sharding_rules(name: str, value: torch.Tensor, owner: nn.Module,
                         model_axis: int,
                         tensor_parallel: bool = False) -> Optional[int]:
    """The axis of parameter ``name`` (``value``, held by module ``owner``)
    that the model axis cuts, or None for a replicated one: JAX's
    ``param_sharding_rules`` (see the module doc).  A model axis of one
    rank cuts nothing."""
    if not tensor_parallel or model_axis <= 1:
        return None
    if not (isinstance(owner, _parallel_types()) and name.endswith(".weight")
            and value.ndim >= 2):
        return None
    if any(t in name for t in TP_TOKENS) and value.shape[0] % model_axis == 0:
        return 0
    return None


def shard_params(model: nn.Module, grid, tensor_parallel: bool = False
                 ) -> nn.Module:
    """Apply ``param_sharding_rules`` across ``model`` in place: each
    weight the rule cuts is replaced by this rank's block of its rows and
    its layer becomes column-parallel over ``grid.model_group``.  Shard
    after loading whole weights and before building an optimizer.  A
    no-op without a grid, without ``tensor_parallel`` or on a model axis
    of one rank.  Returns the model."""
    if grid is None or not tensor_parallel or grid.model == 1:
        return model
    shard = Shard(grid.model_group, grid.model_index, grid.model)
    for mname, m in model.named_modules():
        weight = getattr(m, "weight", None)
        if weight is None or getattr(m, "tp", None) is not None:
            continue
        name = f"{mname}.weight" if mname else "weight"
        if param_sharding_rules(name, weight, m, grid.model,
                                tensor_parallel) is None:
            continue
        m.weight = nn.Parameter(local_rows(weight.detach(), shard).clone(),
                                requires_grad=weight.requires_grad)
        m.tp = shard
    return model


def _sharded_modules(model: nn.Module) -> Dict[str, nn.Module]:
    return {(f"{n}.weight" if n else "weight"): m
            for n, m in model.named_modules()
            if getattr(m, "tp", None) is not None}


def sharding_table(model: nn.Module) -> Dict[str, int]:
    """{parameter name: the axis cut over the model group} for every
    sharded tensor of ``model`` (empty for a replicated one): the JAX
    ``sharding_table``, in the port's names and torch's axes."""
    return {name: 0 for name in _sharded_modules(model)}


def sharded_parameters(model: nn.Module) -> Dict[int, Shard]:
    """{id(parameter): its Shard} for every sharded parameter."""
    return {id(m.weight): m.tp for m in _sharded_modules(model).values()}


def full_state_dict(model: nn.Module) -> Dict[str, torch.Tensor]:
    """``model.state_dict()`` with every sharded tensor assembled: the
    one-process model's state dict, for checkpoints and comparisons.
    Every model rank must call it (one all-reduce per sharded tensor, in
    state-dict order)."""
    sd = model.state_dict()
    for name, m in _sharded_modules(model).items():
        sd[name] = assemble_rows(sd[name], m.tp)
    return sd


def shard_state_dict(state_dict: Mapping[str, torch.Tensor],
                     model: nn.Module) -> Dict[str, torch.Tensor]:
    """A whole state dict cut to ``model``'s shards: what
    ``model.load_state_dict`` takes on this rank."""
    sd = dict(state_dict)
    for name, m in _sharded_modules(model).items():
        sd[name] = local_rows(sd[name], m.tp)
    return sd
