"""Shared building blocks: compute-dtype Linear and Conv2d, BatchNorm and
GroupNorm (``make_norm``), ConvNorm, BasicBlock, Bottleneck, bilinear
resize, DropPath, and the transition and all-pairs fuse layers of the
multi-resolution backbones.

Port of infantposeestimation_gaussianbias_tpu/models/layers.py.  Feature
maps are NHWC, as in the JAX package: a convolution hands PyTorch the
NCHW view of its NHWC input (``permute``, no copy), so the convolution
sees a ``channels_last`` tensor and returns one whose NHWC view is
contiguous again.

Precision is set by explicit casts, not autocast: parameters stay
float32, and each Linear and Conv2d casts its input, weight and bias to
the module's ``compute_dtype`` before the product, as a flax
``nn.Dense(dtype=...)`` does.  BatchNorm folds its statistics in float32
and applies the affine in the activation dtype.

Under a process grid (parallel/mesh.py) a train-mode BatchNorm whose
``grid`` is set takes its statistics over the global batch: the float32
sum, sum of squares and count are all-reduced over the grid's data group
(``_GlobalSums``), as GSPMD's statistics over a 'data'-sharded batch are
global in the JAX package.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

# True while a checkpointed forward is recomputed in the backward: the
# recomputation must not update the running statistics a second time.
_STATS_FROZEN = contextvars.ContextVar("ipe_bn_stats_frozen", default=False)


@contextlib.contextmanager
def frozen_batch_stats() -> Iterator[None]:
    """Within this context train-mode BatchNorm normalises with batch
    statistics but leaves its running statistics as they are."""
    token = _STATS_FROZEN.set(True)
    try:
        yield
    finally:
        _STATS_FROZEN.reset(token)


class Linear(nn.Linear):
    """nn.Linear that computes in ``compute_dtype`` (float32 parameters)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """NHWC-in, NHWC-out nn.Conv2d computing in ``compute_dtype``, with the
    symmetric ``kernel_size // 2`` padding of the JAX ConvNorm."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=bias)
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        y = F.conv2d(x.to(dt).permute(0, 3, 1, 2), self.weight.to(dt), b,
                     self.stride, self.padding)
        return y.permute(0, 2, 3, 1)


class _GlobalSums(torch.autograd.Function):
    """Sum a tensor of per-rank partial sums over a process group.  Every
    rank's loss reads the global sums, so the gradient of each rank's
    partial sums is the sum over the group of the gradients of the global
    ones: the backward all-reduces too."""

    @staticmethod
    def forward(ctx, sums: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = sums.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d over the last (channel) axis of an NHWC map, with the
    JAX package's arithmetic (models/layers.py:124-165 there); eps 1e-5.

    Inference folds (weight, bias, running_mean, running_var) into one
    per-channel (a, b) in float32 and applies ``x * a + b`` in the
    activation dtype.  Training takes the batch mean and the biased
    variance E[x^2] - E[x]^2 in float32, moves the running statistics to
    ``0.9 * running + 0.1 * batch`` with that biased variance (torch's own
    BatchNorm2d would use the unbiased one), and returns
    ``(x.float() * a + b)`` cast back to x's dtype.  With ``grid`` set (a
    ProcessGrid of more than one data rank) the batch is the global one:
    its sums are all-reduced over the data group, so every rank normalises
    with the same statistics and moves its running statistics alike.
    """

    MOMENTUM = 0.9  # flax's convention: the weight of the running value
    grid = None     # set by models.build_model under a process grid

    def _batch_stats(self, xf: torch.Tensor) -> tuple:
        dims = (0, 1, 2)
        grid = self.grid
        if grid is None or grid.data == 1:
            mean = xf.mean(dim=dims)
            return mean, (xf * xf).mean(dim=dims) - mean * mean
        C = xf.shape[-1]
        count = xf.new_full((1,), xf.numel() // C)
        sums = _GlobalSums.apply(
            torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]),
            grid.data_group)
        mean = sums[:C] / sums[-1]
        return mean, sums[C:2 * C] / sums[-1] - mean * mean

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            a = self.weight * torch.rsqrt(self.running_var + self.eps)
            b = self.bias - self.running_mean * a
            return x * a.to(x.dtype) + b.to(x.dtype)
        xf = x.float()
        mean, var = self._batch_stats(xf)
        if not _STATS_FROZEN.get():
            m = self.MOMENTUM
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        return (xf * a + b).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the last (channel) axis of an NHWC map, the JAX
    package's ``Norm(kind="groupnorm")`` (models/layers.py:168-186 there):
    ``min(32, C)`` groups, lowered until they divide C; eps 1e-5;
    statistics over (H, W, group channels) in float32; the output cast
    back to the input's dtype.  flax takes the variance as E[x^2] - E[x]^2
    and torch's ``group_norm`` as E[(x - mean)^2]: the two agree to float32
    rounding of the statistics (tests/test_torch_norm.py states the
    bound).  No running statistics: train and eval are the same."""

    def __init__(self, channels: int):
        groups = min(32, channels)
        while channels % groups:
            groups -= 1
        super().__init__(groups, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


NORMS = {"batchnorm": BatchNorm, "groupnorm": GroupNorm}


def make_norm(kind: str, channels: int, fold: bool = False) -> nn.Module:
    """The norm layer ``cfg.model.norm`` names: "batchnorm" or
    "groupnorm"; any other name raises, as the JAX package's ``Norm``
    does.  ``fold``: the BN-folded serving form (models/fold.py), an
    identity in the norm's place, whose conv carries the folded affine as
    its bias."""
    if kind not in NORMS:
        raise ValueError(f"Unknown norm {kind!r}")
    return nn.Identity() if fold else NORMS[kind](channels)


def conv_norm(in_channels: int, out_channels: int, kernel_size: int = 3,
              stride: int = 1, relu: bool = True,
              compute_dtype: torch.dtype = torch.float32,
              norm: str = "batchnorm", fold: bool = False) -> nn.Sequential:
    """Conv (bias-free) -> norm (-> ReLU), named 0/1(/2) as the
    reference's ``Sequential`` blocks; with ``fold`` a biased conv and an
    identity (the JAX package's ``ConvNorm(fold=True)``)."""
    mods = [Conv2d(in_channels, out_channels, kernel_size, stride,
                   bias=fold, compute_dtype=compute_dtype),
            make_norm(norm, out_channels, fold)]
    if relu:
        mods.append(nn.ReLU())
    return nn.Sequential(*mods)


class BasicBlock(nn.Module):
    """Two 3x3 conv-BN units with an identity residual: relu(bn1(conv1(x)))
    -> bn2(conv2(.)) -> relu(. + x), named as the reference's BasicBlock.
    The float path of models/layers.py:193-222 of the JAX package;
    ``fold`` as ``conv_norm``'s."""

    def __init__(self, features: int,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm", fold: bool = False):
        super().__init__()
        kw = dict(bias=fold, compute_dtype=compute_dtype)
        self.conv1 = Conv2d(features, features, 3, **kw)
        self.bn1 = make_norm(norm, features, fold)
        self.conv2 = Conv2d(features, features, 3, **kw)
        self.bn2 = make_norm(norm, features, fold)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.bn1(self.conv1(x)))
        return F.relu(self.bn2(self.conv2(y)) + x)


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) residual block with an optional 1x1
    ``downsample`` on the skip when the channel count changes; ``fold`` as
    ``conv_norm``'s."""

    expansion = 4

    def __init__(self, in_channels: int, features: int,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm", fold: bool = False):
        super().__init__()
        out = features * self.expansion
        kw = dict(bias=fold, compute_dtype=compute_dtype)
        self.conv1 = Conv2d(in_channels, features, 1, **kw)
        self.bn1 = make_norm(norm, features, fold)
        self.conv2 = Conv2d(features, features, 3, **kw)
        self.bn2 = make_norm(norm, features, fold)
        self.conv3 = Conv2d(features, out, 1, **kw)
        self.bn3 = make_norm(norm, out, fold)
        self.downsample = (conv_norm(in_channels, out, 1, relu=False,
                                     compute_dtype=compute_dtype, norm=norm,
                                     fold=fold)
                           if in_channels != out else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x if self.downsample is None else self.downsample(x)
        y = F.relu(self.bn1(self.conv1(x)))
        y = F.relu(self.bn2(self.conv2(y)))
        y = self.bn3(self.conv3(y))
        return F.relu(y + residual)


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear NHWC resize with half-pixel centres and edge clamp, which is
    ``F.interpolate(mode="bilinear", align_corners=False)``."""
    if x.shape[1] == height and x.shape[2] == width:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor],
              rate: float) -> torch.Tensor:
    """Per-sample stochastic depth (models/layers.py:299-312 of the JAX
    package): samples whose ``keep`` flag is False are zeroed, the others
    scaled by 1 / (1 - rate).  ``keep`` is a (B,) bool tensor drawn by the
    caller (train/step.py ``draw_drop_masks``), or None for the identity."""
    if keep is None or rate == 0.0:
        return x
    mask = keep.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / (1.0 - rate), 0.0).to(x.dtype)


def make_transition(prev: Sequence[int], cur: Sequence[int],
                    compute_dtype: torch.dtype = torch.float32,
                    norm: str = "batchnorm",
                    fold: bool = False) -> nn.ModuleList:
    """Transition into a stage of ``cur`` branches from one of ``prev``: a
    3x3 ConvNorm where a branch's width changes (Identity where it does
    not), and a stride-2 3x3 ConvNorm from the lowest branch for each new
    one, wrapped in one more Sequential as in the reference."""
    kw = dict(compute_dtype=compute_dtype, norm=norm, fold=fold)
    trans = nn.ModuleList()
    for i, ch in enumerate(cur):
        if i < len(prev):
            trans.append(conv_norm(prev[i], ch, 3, **kw)
                         if prev[i] != ch else nn.Identity())
        else:
            trans.append(nn.Sequential(
                conv_norm(prev[-1], ch, 3, stride=2, **kw)))
    return trans


def apply_transition(trans: nn.ModuleList,
                     xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """A new branch takes the lowest existing one as its input."""
    return [tr(xs[i] if i < len(xs) else xs[-1])
            for i, tr in enumerate(trans)]


def make_fuse_layers(channels: Sequence[int],
                     compute_dtype: torch.dtype = torch.float32,
                     norm: str = "batchnorm",
                     fold: bool = False) -> nn.ModuleList:
    """All-pairs fuse layers of an exchange module: layer (i, j) is, for
    j > i, a 1x1 ConvNorm (upsampled in ``fuse``); for j == i the
    identity; for j < i a chain of stride-2 3x3 ConvNorms, ReLU on all but
    the last, which also changes the width."""
    kw = dict(compute_dtype=compute_dtype, norm=norm, fold=fold)
    n = len(channels)
    rows = nn.ModuleList()
    for i in range(n):
        row = nn.ModuleList()
        for j in range(n):
            if j > i:
                row.append(conv_norm(channels[j], channels[i], 1,
                                     relu=False, **kw))
            elif j == i:
                row.append(nn.Identity())
            else:
                row.append(nn.Sequential(*[
                    conv_norm(channels[j],
                              channels[i] if k == i - j - 1 else channels[j],
                              3, stride=2, relu=k != i - j - 1, **kw)
                    for k in range(i - j)]))
        rows.append(row)
    return rows


def fuse(fuse_layers: nn.ModuleList,
         ys: List[torch.Tensor]) -> List[torch.Tensor]:
    """Output i = relu(sum over j of layer (i, j) of branch j), the
    higher-indexed (lower-resolution) branches resized to branch i's map."""
    out = []
    for i, row in enumerate(fuse_layers):
        acc = None
        for j, layer in enumerate(row):
            contrib = layer(ys[j])
            if j > i:
                contrib = resize_bilinear(contrib, ys[i].shape[1],
                                          ys[i].shape[2])
            acc = contrib if acc is None else acc + contrib
        out.append(F.relu(acc))
    return out


def remat_contexts():
    """(forward context, recomputation context) for
    ``torch.utils.checkpoint``: the recomputed forward must not move the
    BatchNorm running statistics a second time (flax's remat returns them
    from the first pass only)."""
    return contextlib.nullcontext(), frozen_batch_stats()
