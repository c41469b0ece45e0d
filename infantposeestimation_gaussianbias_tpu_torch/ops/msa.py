"""Window multi-head self-attention primitives (NHWC).

Port of infantposeestimation_gaussianbias_tpu/ops/msa.py: window
partition with zero padding to window multiples, its inverse, the static
relative-position index, and the plain attention core that is both the
CPU path and the reference for the CUDA kernel (kernels/window_msa.py).
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def relative_position_index(window_size: int) -> np.ndarray:
    """Static (ws^2, ws^2) index into the (2ws-1)^2 RPE bias table."""
    ws = window_size
    coords = np.stack(np.meshgrid(np.arange(ws), np.arange(ws),
                                  indexing="ij"))  # (2, ws, ws)
    flat = coords.reshape(2, -1)  # (2, N)
    rel = flat[:, :, None] - flat[:, None, :]  # (2, N, N)
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += ws - 1
    rel[:, :, 1] += ws - 1
    rel[:, :, 0] *= 2 * ws - 1
    return rel.sum(-1)  # (N, N)


def window_partition(x: torch.Tensor, window_size: int
                     ) -> Tuple[torch.Tensor, Tuple[int, int]]:
    """(B, H, W, C) -> (B * nH * nW, ws*ws, C), zero-padding H/W up to
    window multiples."""
    B, H, W, C = x.shape
    ws = window_size
    Hp = -(-H // ws) * ws
    Wp = -(-W // ws) * ws
    if Hp != H or Wp != W:
        x = F.pad(x, (0, 0, 0, Wp - W, 0, Hp - H))
    x = x.reshape(B, Hp // ws, ws, Wp // ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws * ws, C)
    return x, (Hp, Wp)


def window_reverse(windows: torch.Tensor, window_size: int, H: int, W: int,
                   Hp: int, Wp: int) -> torch.Tensor:
    """Inverse of window_partition, cropping the padding back off."""
    ws = window_size
    C = windows.shape[-1]
    B = windows.shape[0] // ((Hp // ws) * (Wp // ws))
    x = windows.reshape(B, Hp // ws, Wp // ws, ws, ws, C)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, C)
    return x[:, :H, :W, :]


def window_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Scaled-dot-product attention over windows, plain PyTorch.

    q, k, v: (nW, num_heads, N, head_dim); bias: optional (num_heads, N, N).
    Returns (nW, num_heads, N, head_dim) in v's dtype.  q is pre-scaled by
    head_dim^-0.5 and every step runs in float32 (float64 for float64
    inputs, which gradcheck uses).
    """
    head_dim = q.shape[-1]
    acc = torch.promote_types(q.dtype, torch.float32)
    qf = q.to(acc) * head_dim ** -0.5
    attn = qf @ k.to(acc).transpose(-2, -1)
    if bias is not None:
        attn = attn + bias.to(acc)[None]
    attn = torch.softmax(attn, dim=-1)
    return (attn @ v.to(acc)).to(v.dtype)
