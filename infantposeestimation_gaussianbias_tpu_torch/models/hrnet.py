"""HRNet backbone: multi-resolution CNN on NHWC feature maps.

Port of infantposeestimation_gaussianbias_tpu/models/hrnet.py.  Stem (two stride-2 3x3 ConvNorms to 64 channels) -> four
Bottlenecks (64 -> 256) -> three exchange stages of HRModules, each
running 4 BasicBlocks per branch and then the all-pairs fuse (1x1 +
bilinear upsample upward, stride-2 3x3 chains downward); returns the
highest-resolution branch (stride 4, ``base_channels`` wide).

Stage layout, as the reference's:
  stage2: 1 module,  2 branches, channels (C, 2C)
  stage3: 4 modules, 3 branches, channels (C, 2C, 4C)
  stage4: 3 modules, 4 branches, channels (C, 2C, 4C, 8C)
``stage_modules`` (``cfg.model.hrnet_stage_modules``) replaces the
(1, 4, 3) module counts.

Names follow the reference's state dict (``conv1``/``bn1``, ``layer1.{b}``,
``transition{t}.{i}``, ``stage{s}.{m}.branches.{br}.{blk}.conv1``,
``stage{s}.{m}.fuse_layers.{i}.{j}``).  HRNet has no DropPath:
``drop_path_rate`` is 0, so ``train.step.draw_drop_masks`` gives None.
``remat`` wraps each HRModule in ``torch.utils.checkpoint``, whose
recomputation leaves the BatchNorm running statistics alone.

``quant``: the int8 PTQ serving form (ops/quant.py), every ConvNorm a
QConvNorm on K9: the normalised input is requantized with
``input_scale``, activations travel between layers as int8 QTensors, and
the backbone returns one (the heads dequantize it).  Its buffers come from
``models.quantize.quantize_model``.  The float model records its
calibration points when run under ``layers.calibrating``.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.quant import requantize
from .layers import (BasicBlock, Bottleneck, Conv2d, QConvNorm,
                     apply_transition, fuse, make_fuse_layers, make_norm,
                     make_transition, remat_contexts, sow_absmax)

BLOCKS_PER_BRANCH = 4
STAGE_MODULES = (1, 4, 3)


class HRModule(nn.Module):
    """Exchange unit: 4 BasicBlocks per branch, then the all-pairs fuse
    (layers.make_fuse_layers / layers.fuse; int8: requantized with the
    ``fused{i}_scale`` buffers)."""

    def __init__(self, channels: Sequence[int],
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm", fold: bool = False,
                 quant: bool = False):
        super().__init__()
        self.branches = nn.ModuleList([
            nn.Sequential(*[BasicBlock(c, compute_dtype=compute_dtype,
                                       norm=norm, fold=fold, quant=quant)
                            for _ in range(BLOCKS_PER_BRANCH)])
            for c in channels])
        self.fuse_layers = make_fuse_layers(channels, compute_dtype, norm,
                                            fold, quant)
        if quant and len(channels) > 1:
            for i in range(len(channels)):
                self.register_buffer(f"fused{i}_scale", torch.ones(()))

    def forward(self, xs: list) -> list:
        return fuse(self.fuse_layers,
                    [branch(x) for branch, x in zip(self.branches, xs)],
                    self)


class HRNet(nn.Module):
    """HRNet backbone on NHWC images; returns the stride-4 features.
    ``fold``: the BN-folded serving form (models/fold.py); ``quant``: the
    int8 one (see the module doc)."""

    drop_path_rate = 0.0
    num_drop_paths = 0

    def __init__(self, base_channels: int = 32,
                 stage_modules: Optional[Tuple[int, ...]] = None,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, norm: str = "batchnorm",
                 fold: bool = False, quant: bool = False):
        super().__init__()
        C = base_channels
        self.channels = (C, 2 * C, 4 * C, 8 * C)
        self.remat = remat
        self.quant = quant
        stage_modules = tuple(stage_modules or STAGE_MODULES)
        kw = dict(compute_dtype=compute_dtype, norm=norm, fold=fold,
                  quant=quant)
        if quant:
            self.register_buffer("input_scale", torch.ones(()))
            self.conv1 = QConvNorm(3, 64, 3, stride=2)
            self.conv2 = QConvNorm(64, 64, 3, stride=2)
        else:
            self.conv1 = Conv2d(3, 64, 3, stride=2, bias=fold,
                                compute_dtype=compute_dtype)
            self.bn1 = make_norm(norm, 64, fold)
            self.conv2 = Conv2d(64, 64, 3, stride=2, bias=fold,
                                compute_dtype=compute_dtype)
            self.bn2 = make_norm(norm, 64, fold)
        self.layer1 = nn.Sequential(Bottleneck(64, 64, **kw),
                                    *[Bottleneck(256, 64, **kw)
                                      for _ in range(3)])
        prev = [256]
        for s, modules in enumerate(stage_modules):
            cur = list(self.channels[: s + 2])
            setattr(self, f"transition{s + 1}",
                    make_transition(prev, cur, **kw))
            setattr(self, f"stage{s + 2}", nn.ModuleList([
                HRModule(cur, **kw) for _ in range(modules)]))
            prev = cur
        self.num_stages = len(stage_modules)

    def forward(self, x: torch.Tensor,
                drop_masks: Optional[torch.Tensor] = None) -> torch.Tensor:
        """``drop_masks`` must be None: HRNet has no DropPath (the argument
        keeps the backbones' one signature)."""
        if drop_masks is not None:
            raise ValueError("HRNet has no DropPath; drop_masks must be None")
        remat = self.remat and torch.is_grad_enabled()
        if self.quant:
            x = self.conv2(self.conv1(requantize(x.float(),
                                                 self.input_scale)))
        else:
            sow_absmax(self, "input_absmax", x)
            x = F.relu(self.bn1(self.conv1(x)))
            sow_absmax(self.conv1, "out_absmax", x)
            x = F.relu(self.bn2(self.conv2(x)))
            sow_absmax(self.conv2, "out_absmax", x)
        xs = [self.layer1(x)]
        for t in range(1, self.num_stages + 1):
            xs = apply_transition(getattr(self, f"transition{t}"), xs)
            for module in getattr(self, f"stage{t + 1}"):
                if remat:
                    xs = checkpoint(module, xs, use_reentrant=False,
                                    context_fn=remat_contexts)
                else:
                    xs = module(xs)
        return xs[0]


def hrnet_w32(compute_dtype: torch.dtype = torch.float32, remat: bool = False,
              stage_modules: Optional[Tuple[int, ...]] = None,
              norm: str = "batchnorm", fold: bool = False,
              quant: bool = False) -> HRNet:
    return HRNet(base_channels=32, stage_modules=stage_modules,
                 compute_dtype=compute_dtype, remat=remat, norm=norm,
                 fold=fold, quant=quant)


def hrnet_w48(compute_dtype: torch.dtype = torch.float32, remat: bool = False,
              stage_modules: Optional[Tuple[int, ...]] = None,
              norm: str = "batchnorm", fold: bool = False,
              quant: bool = False) -> HRNet:
    return HRNet(base_channels=48, stage_modules=stage_modules,
                 compute_dtype=compute_dtype, remat=remat, norm=norm,
                 fold=fold, quant=quant)
