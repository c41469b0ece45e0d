"""Attention add-on modules on NHWC features: CBAM and a transformer neck.

Port of infantposeestimation_gaussianbias_tpu/models/attention.py.  As
there, no model path uses them; each wraps a backbone's output features
and returns features of the same shape.  Names follow the flax module
paths: ``ca.fc1``, ``ca.fc2``, ``sa.conv`` (CBAM); ``pos_embed``,
``ln1_{i}``, ``attn_{i}.{query,key,value,out}``, ``ln2_{i}``,
``mlp1_{i}``, ``mlp2_{i}`` (TransformerNeck).

flax's defaults, kept: ``nn.LayerNorm``'s eps is 1e-6, ``nn.gelu`` is the
tanh approximation, ``MultiHeadDotProductAttention`` has a biased query,
key, value and output projection and scales the queries by 1/sqrt(head
dim), the 7x7 spatial-attention conv has a bias, and every Dense starts
from flax's lecun-normal initialiser.  ``pos_embed`` is (1, H W, C), so a
neck is built for one feature size.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, Linear

LAYERNORM_EPS = 1e-6  # flax nn.LayerNorm's default


class ChannelAttention(nn.Module):
    """Squeeze (average and max pool) -> shared MLP (fc1, ReLU, fc2) ->
    sigmoid channel gate."""

    def __init__(self, channels: int, reduction: int = 16,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        hidden = max(channels // reduction, 4)
        self.fc1 = Linear(channels, hidden, compute_dtype, init="lecun")
        self.fc2 = Linear(hidden, channels, compute_dtype, init="lecun")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        def mlp(v):
            return self.fc2(F.relu(self.fc1(v)))

        gate = torch.sigmoid(mlp(x.mean(dim=(1, 2)))
                             + mlp(x.amax(dim=(1, 2))))
        return x * gate[:, None, None, :].to(x.dtype)


class SpatialAttention(nn.Module):
    """Channel-pooled (mean and max) map -> ``kernel`` x ``kernel`` conv
    with bias -> sigmoid spatial gate."""

    def __init__(self, kernel: int = 7,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.conv = Conv2d(2, 1, kernel, bias=True,
                           compute_dtype=compute_dtype, init="kaiming")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = torch.cat([x.mean(dim=-1, keepdim=True),
                       x.amax(dim=-1, keepdim=True)], dim=-1)
        return x * torch.sigmoid(self.conv(g)).to(x.dtype)


class CBAM(nn.Module):
    """Convolutional Block Attention Module: the channel gate, then the
    spatial gate."""

    def __init__(self, channels: int, reduction: int = 16,
                 spatial_kernel: int = 7,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.ca = ChannelAttention(channels, reduction, compute_dtype)
        self.sa = SpatialAttention(spatial_kernel, compute_dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.sa(self.ca(x))


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` self-attention (no dropout,
    no mask): ``query``, ``key``, ``value`` and ``out`` projections, each
    with a bias; per head softmax(q k^T / sqrt(hd)) v."""

    def __init__(self, channels: int, num_heads: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.num_heads = num_heads
        for name in ("query", "key", "value", "out"):
            setattr(self, name, Linear(channels, channels, compute_dtype,
                                       init="lecun"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, N, C = x.shape
        h = self.num_heads

        def heads(t):
            return t.reshape(B, N, h, C // h).transpose(1, 2)

        y = F.scaled_dot_product_attention(
            heads(self.query(x)), heads(self.key(x)), heads(self.value(x)))
        return self.out(y.transpose(1, 2).reshape(B, N, C))


class TransformerNeck(nn.Module):
    """A small pre-norm transformer encoder over the flattened feature
    tokens (plus a learned position embedding), added back to the
    features: for each of ``num_layers`` layers, tokens += attention(
    LayerNorm(tokens)), then tokens += mlp2(gelu(mlp1(LayerNorm(tokens)))).
    ``feature_hw``: the (H, W) of the features the neck is built for.
    The LayerNorms run in float32, as flax's ``dtype=jnp.float32``."""

    def __init__(self, channels: int, feature_hw: Tuple[int, int],
                 num_layers: int = 2, num_heads: int = 4,
                 mlp_ratio: float = 2.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        H, W = feature_hw
        self.num_layers = num_layers
        self.pos_embed = nn.Parameter(torch.zeros(1, H * W, channels))
        hidden = int(channels * mlp_ratio)
        for i in range(num_layers):
            setattr(self, f"ln1_{i}", nn.LayerNorm(channels,
                                                   eps=LAYERNORM_EPS))
            setattr(self, f"attn_{i}", MultiHeadAttention(
                channels, num_heads, compute_dtype))
            setattr(self, f"ln2_{i}", nn.LayerNorm(channels,
                                                   eps=LAYERNORM_EPS))
            setattr(self, f"mlp1_{i}", Linear(channels, hidden,
                                              compute_dtype, init="lecun"))
            setattr(self, f"mlp2_{i}", Linear(hidden, channels,
                                              compute_dtype, init="lecun"))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, H, W, C = x.shape
        tokens = x.reshape(B, H * W, C) + self.pos_embed.to(x.dtype)
        for i in range(self.num_layers):
            ln1, ln2 = getattr(self, f"ln1_{i}"), getattr(self, f"ln2_{i}")
            y = getattr(self, f"attn_{i}")(ln1(tokens.float()))
            tokens = tokens + y.to(tokens.dtype)
            y = F.gelu(getattr(self, f"mlp1_{i}")(ln2(tokens.float())),
                       approximate="tanh")
            tokens = tokens + getattr(self, f"mlp2_{i}")(y).to(tokens.dtype)
        return x + tokens.reshape(B, H, W, C).to(x.dtype)
