"""LiteHRNet backbone: HRNet's exchange topology on depthwise-separable
blocks, for the ``lightweight`` config.

Port of infantposeestimation_gaussianbias_tpu/models/litehrnet.py.  Stem
(two stride-2 3x3 ConvNorms to 32 channels) -> one DWSeparableBlock (32 ->
C) -> two exchange stages of two LiteHRModules each, channels (C, 2C) and
(C, 2C, 4C), C = 24; returns the highest-resolution branch (stride 4,
C wide).  A LiteHRModule runs two DWSeparableBlocks per branch, then the
all-pairs fuse: a 1x1 ConvNorm + bilinear upsample upward, a chain of
stride-2 DWSeparableBlocks downward (ReLU'd, unlike HRNet's last chain
link), and the ReLU of the sum.

Names follow the flax module paths, and HRNet's port where the two share
a path: ``conv1``/``bn1`` and ``conv2``/``bn2`` (flax ``stem1``,
``stem2``), ``layer1``, ``transition{t}.{i}`` (layers.make_transition),
``stage{s}.{m}.branches.{i}.{b}`` (flax ``stage{s}_module{m}/
branch{i}_block{b}``), ``stage{s}.{m}.fuse_layers.{i}.{j}`` (a 1x1
ConvNorm, flax ``fuse{i}_{j}``) and ``stage{s}.{m}.fuse_layers.{i}.{j}.{k}``
(a DWSeparableBlock, flax ``fuse{i}_{j}_{k}``); a DWSeparableBlock holds
``dw`` (the depthwise 3x3, ``groups=C``), ``dw_norm``, ``pw`` (the 1x1)
and ``pw_norm``.  Modules register in the JAX modules' call order, the
order in which ``weights.init_weights`` draws the seeded weights.

LiteHRNet neither folds nor quantizes (``validate_serving_mode``), and has
no DropPath.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import (Conv2d, apply_transition, conv_norm, fuse, make_norm,
                     make_transition)

BASE_CHANNELS = 24
STAGE_MODULES = (2, 2)
BLOCKS_PER_BRANCH = 2
STEM_CHANNELS = 32


class DWSeparableBlock(nn.Module):
    """Depthwise 3x3 (stride 1 or 2) -> norm -> ReLU -> pointwise 1x1 ->
    norm (-> + x where the stride is 1 and the width stays) -> ReLU."""

    def __init__(self, in_channels: int, features: int, stride: int = 1,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm"):
        super().__init__()
        self.dw = Conv2d(in_channels, in_channels, 3, stride,
                         compute_dtype=compute_dtype, groups=in_channels)
        self.dw_norm = make_norm(norm, in_channels)
        self.pw = Conv2d(in_channels, features, 1,
                         compute_dtype=compute_dtype)
        self.pw_norm = make_norm(norm, features)
        self.residual = stride == 1 and in_channels == features

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.relu(self.dw_norm(self.dw(x)))
        y = self.pw_norm(self.pw(y))
        if self.residual:
            y = y + x
        return F.relu(y)


class LiteHRModule(nn.Module):
    """Exchange unit: ``BLOCKS_PER_BRANCH`` DWSeparableBlocks per branch,
    then the all-pairs fuse (layers.fuse) of 1x1 ConvNorms upward and
    stride-2 DWSeparableBlock chains downward."""

    def __init__(self, channels: Sequence[int],
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm"):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype, norm=norm)
        self.branches = nn.ModuleList([
            nn.Sequential(*[DWSeparableBlock(c, c, **kw)
                            for _ in range(BLOCKS_PER_BRANCH)])
            for c in channels])
        n = len(channels)
        self.fuse_layers = nn.ModuleList()
        for i in range(n if n > 1 else 0):
            row = nn.ModuleList()
            for j in range(n):
                if j > i:
                    row.append(conv_norm(channels[j], channels[i], 1,
                                         relu=False, **kw))
                elif j == i:
                    row.append(nn.Identity())
                else:
                    row.append(nn.Sequential(*[
                        DWSeparableBlock(
                            channels[j],
                            channels[i] if k == i - j - 1 else channels[j],
                            stride=2, **kw)
                        for k in range(i - j)]))
            self.fuse_layers.append(row)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        return fuse(self.fuse_layers, ys, self) if len(ys) > 1 else ys


class LiteHRNet(nn.Module):
    """LiteHRNet on NHWC images; returns the stride-4 features
    (``channels[0]`` wide)."""

    drop_path_rate = 0.0
    num_drop_paths = 0

    def __init__(self, base_channels: int = BASE_CHANNELS,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm"):
        super().__init__()
        C = base_channels
        self.channels = (C, 2 * C, 4 * C)
        kw = dict(compute_dtype=compute_dtype, norm=norm)
        self.conv1 = Conv2d(3, STEM_CHANNELS, 3, stride=2,
                            compute_dtype=compute_dtype)
        self.bn1 = make_norm(norm, STEM_CHANNELS)
        self.conv2 = Conv2d(STEM_CHANNELS, STEM_CHANNELS, 3, stride=2,
                            compute_dtype=compute_dtype)
        self.bn2 = make_norm(norm, STEM_CHANNELS)
        self.layer1 = DWSeparableBlock(STEM_CHANNELS, C, **kw)
        prev = [C]
        for s, modules in enumerate(STAGE_MODULES):
            cur = list(self.channels[: s + 2])
            setattr(self, f"transition{s + 1}",
                    make_transition(prev, cur, **kw))
            setattr(self, f"stage{s + 2}", nn.ModuleList([
                LiteHRModule(cur, **kw) for _ in range(modules)]))
            prev = cur

    def forward(self, x: torch.Tensor,
                drop_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``drop_masks`` must be None: LiteHRNet has no DropPath."""
        if drop_masks is not None:
            raise ValueError("LiteHRNet has no DropPath; drop_masks must be "
                             "None")
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for t in range(1, len(STAGE_MODULES) + 1):
            xs = apply_transition(getattr(self, f"transition{t}"), xs)
            for module in getattr(self, f"stage{t + 1}"):
                xs = module(xs)
        return xs[0]


def litehrnet(compute_dtype: torch.dtype = torch.float32,
              norm: str = "batchnorm") -> LiteHRNet:
    return LiteHRNet(base_channels=BASE_CHANNELS, compute_dtype=compute_dtype,
                     norm=norm)
