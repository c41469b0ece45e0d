"""HRFormer backbone: multi-resolution transformer on NHWC feature maps.

Port of infantposeestimation_gaussianbias_tpu/models/hrformer.py (the
unfused path, eval mode).  Module and parameter names follow the
reference's state dict (``conv1``/``bn1``, ``layer1.{b}``,
``transition{t}.{i}``, ``stage{s}.{m}.branches.{br}.{blk}.attn.qkv``,
``...attn.relative_position_bias_table``, ``stage{s}.{m}.fuse_layers.{i}.{j}``)
so that a reference checkpoint loads with ``load_state_dict``.

DropPath is the identity at inference and holds no parameters, so the
serving port leaves it out.

Base:  channels (78, 156, 312, 624), heads (2, 4, 8, 16), window 7,
       modules per stage (1, 4, 2), 2 blocks per branch.
Small: channels (32, 64, 128, 256), heads (1, 2, 4, 8).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..kernels.window_msa import window_attention_qkv
from ..ops import msa
from .layers import (BatchNorm, Bottleneck, Conv2d, Linear, conv_norm,
                     resize_bilinear)

BLOCKS_PER_BRANCH = 2
MLP_RATIO = 4


class WindowAttention(nn.Module):
    """W-MSA with relative position bias over (nW, N, C) windows; the
    attention core is the fused kernel (kernels/window_msa.py), which takes
    its plain version for CPU tensors."""

    def __init__(self, dim: int, window_size: int, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size
        self.relative_position_bias_table = nn.Parameter(
            torch.zeros((2 * window_size - 1) ** 2, num_heads))
        self.register_buffer("relative_position_index", torch.from_numpy(
            msa.relative_position_index(window_size).astype("int64")))
        self.qkv = Linear(dim, 3 * dim, compute_dtype=compute_dtype)
        self.proj = Linear(dim, dim, compute_dtype=compute_dtype)

    def rpe_bias(self) -> torch.Tensor:
        """(num_heads, N, N) float32 bias gathered from the table."""
        N = self.window_size ** 2
        table = self.relative_position_bias_table
        bias = table[self.relative_position_index.reshape(-1)]
        return bias.reshape(N, N, self.num_heads).permute(2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        qkv = self.qkv(x).contiguous()
        out = window_attention_qkv(qkv, self.rpe_bias(), self.num_heads)
        return self.proj(out)


class Mlp(nn.Module):
    """Linear -> exact-erf GELU -> Linear."""

    def __init__(self, dim: int, hidden: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.fc1 = Linear(dim, hidden, compute_dtype=compute_dtype)
        self.fc2 = Linear(hidden, dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x)))


class HRFormerBlock(nn.Module):
    """LN -> window MSA -> residual -> LN -> MLP -> residual on an NHWC map.

    LayerNorm statistics are float32 with eps 1e-5; the normalised map
    drops to the compute dtype before the window partition, as in the JAX
    block (hrformer.py:205-227)."""

    def __init__(self, dim: int, num_heads: int, window_size: int = 7,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.window_size = window_size
        self.compute_dtype = compute_dtype
        self.norm1 = nn.LayerNorm(dim, eps=1e-5)
        self.attn = WindowAttention(dim, window_size, num_heads, compute_dtype)
        self.norm2 = nn.LayerNorm(dim, eps=1e-5)
        self.mlp = Mlp(dim, MLP_RATIO * dim, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        ws, dt = self.window_size, self.compute_dtype
        y = self.norm1(x.float()).to(dt)
        wins, (Hp, Wp) = msa.window_partition(y, ws)
        wins = self.attn(wins)
        x = x + msa.window_reverse(wins.reshape(-1, ws, ws, C), ws, H, W,
                                   Hp, Wp)
        y = self.norm2(x.float()).to(dt)
        return x + self.mlp(y)


class HRFormerModule(nn.Module):
    """Exchange unit: transformer branches + all-pairs conv fusion.

    Fuse layer (i, j): for j > i a 1x1 ConvNorm then a bilinear upsample;
    for j < i a chain of stride-2 3x3 ConvNorms, ReLU on all but the last.
    The sum over j is followed by a ReLU."""

    def __init__(self, channels: Sequence[int], heads: Sequence[int],
                 window_size: int = 7,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        n = len(channels)
        kw = dict(compute_dtype=compute_dtype)
        self.branches = nn.ModuleList([
            nn.Sequential(*[HRFormerBlock(c, h, window_size, **kw)
                            for _ in range(BLOCKS_PER_BRANCH)])
            for c, h in zip(channels, heads)])
        self.fuse_layers = nn.ModuleList()
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
                                  channels[i] if k == i - j - 1
                                  else channels[j],
                                  3, stride=2, relu=k != i - j - 1, **kw)
                        for k in range(i - j)]))
            self.fuse_layers.append(row)

    def forward(self, xs: List[torch.Tensor]) -> List[torch.Tensor]:
        ys = [branch(x) for branch, x in zip(self.branches, xs)]
        out = []
        for i, row in enumerate(self.fuse_layers):
            acc = None
            for j, layer in enumerate(row):
                contrib = layer(ys[j])
                if j > i:
                    contrib = resize_bilinear(contrib, ys[i].shape[1],
                                              ys[i].shape[2])
                acc = contrib if acc is None else acc + contrib
            out.append(F.relu(acc))
        return out


class HRFormer(nn.Module):
    """HRFormer backbone on NHWC images; returns the stride-4 features."""

    def __init__(self, channels: Tuple[int, ...] = (78, 156, 312, 624),
                 num_heads: Tuple[int, ...] = (2, 4, 8, 16),
                 stage_modules: Tuple[int, ...] = (1, 4, 2),
                 window_size: int = 7,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.channels = tuple(channels)
        kw = dict(compute_dtype=compute_dtype)
        self.conv1 = Conv2d(3, 64, 3, stride=2, **kw)
        self.bn1 = BatchNorm(64)
        self.conv2 = Conv2d(64, 64, 3, stride=2, **kw)
        self.bn2 = BatchNorm(64)
        self.layer1 = nn.Sequential(Bottleneck(64, 64, **kw),
                                    Bottleneck(256, 64, **kw))
        prev = [256]
        for s, modules in enumerate(stage_modules):
            cur = list(channels[: s + 2])
            trans = nn.ModuleList()
            for i, ch in enumerate(cur):
                if i < len(prev):
                    trans.append(conv_norm(prev[i], ch, 3, **kw)
                                 if prev[i] != ch else nn.Identity())
                else:  # new lowest-resolution branch
                    trans.append(nn.Sequential(
                        conv_norm(prev[-1], ch, 3, stride=2, **kw)))
            setattr(self, f"transition{s + 1}", trans)
            setattr(self, f"stage{s + 2}", nn.ModuleList([
                HRFormerModule(cur, num_heads[: s + 2], window_size, **kw)
                for _ in range(modules)]))
            prev = cur
        self.num_stages = len(stage_modules)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = F.relu(self.bn1(self.conv1(x)))
        x = F.relu(self.bn2(self.conv2(x)))
        xs = [self.layer1(x)]
        for t in range(1, self.num_stages + 1):
            trans = getattr(self, f"transition{t}")
            xs = [tr(xs[i] if i < len(xs) else xs[-1])
                  for i, tr in enumerate(trans)]
            for module in getattr(self, f"stage{t + 1}"):
                xs = module(xs)
        return xs[0]


def hrformer_base(compute_dtype: torch.dtype = torch.float32,
                  window_size: int = 7) -> HRFormer:
    return HRFormer(channels=(78, 156, 312, 624), num_heads=(2, 4, 8, 16),
                    compute_dtype=compute_dtype, window_size=window_size)


def hrformer_small(compute_dtype: torch.dtype = torch.float32,
                   window_size: int = 7) -> HRFormer:
    return HRFormer(channels=(32, 64, 128, 256), num_heads=(1, 2, 4, 8),
                    compute_dtype=compute_dtype, window_size=window_size)
