"""K1: fused window multi-head self-attention on the flat qkv layout.

Port of ``window_attention_pallas_qkv``
(infantposeestimation_gaussianbias_tpu/ops/pallas/window_msa.py:221-289).
``window_attention_qkv`` runs the CUDA kernel of ``csrc/window_msa.cu``
for a tensor on the card and the plain PyTorch version
``window_attention_qkv_reference`` for a tensor on the CPU; on any other
device, or for a CUDA tensor the kernel does not take, it raises.

Contract, as ops/msa.py ``window_attention`` on the flat layout:
  qkv  (nW, N, 3C), columns [q heads | k heads | v heads], float32 or bf16;
  bias (num_heads, N, N) float32, or None;
  returns (nW, N, C) in qkv's dtype, maths in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..ops import msa
from . import build

# Kernel launches since the last reset; one per launch, nowhere else.
LAUNCHES = 0

MAX_TOKENS = 64
MAX_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def window_attention_qkv_reference(qkv: torch.Tensor,
                                   bias: Optional[torch.Tensor],
                                   num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of the kernel (the einsum path of ops/msa.py
    fed from the flat qkv tensor)."""
    nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    split = qkv.reshape(nW, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    out = msa.window_attention(split[0], split[1], split[2], bias)
    return out.permute(0, 2, 1, 3).reshape(nW, N, C)


def _check(qkv: torch.Tensor, bias: Optional[torch.Tensor],
           num_heads: int) -> tuple[int, int, int, int]:
    if qkv.dtype not in _DTYPE_CODES:
        raise TypeError(f"qkv must be float32 or bfloat16, got {qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous (nW, N, 3C) tensor, got "
                         f"shape {tuple(qkv.shape)}")
    nW, N, C3 = qkv.shape
    if C3 % 3 or (C3 // 3) % num_heads:
        raise ValueError(f"3C={C3} does not split into 3 x {num_heads} heads")
    hd = C3 // 3 // num_heads
    if N > MAX_TOKENS or hd > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes N <= {MAX_TOKENS} and head_dim <= "
                         f"{MAX_HEAD_DIM}, got N={N}, head_dim={hd}")
    if bias is not None:
        if (bias.dtype != torch.float32 or not bias.is_contiguous()
                or tuple(bias.shape) != (num_heads, N, N)
                or bias.device != qkv.device):
            raise ValueError(
                f"bias must be a contiguous float32 ({num_heads}, {N}, {N}) "
                f"tensor on {qkv.device}, got {bias.dtype} "
                f"{tuple(bias.shape)} on {bias.device}")
    return nW, N, hd, _DTYPE_CODES[qkv.dtype]


def window_attention_qkv(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                         num_heads: int) -> torch.Tensor:
    """Fused W-MSA: (nW, N, 3C) qkv -> (nW, N, C), see the module doc."""
    global LAUNCHES
    if qkv.device.type == "cpu":
        return window_attention_qkv_reference(qkv, bias, num_heads)
    if qkv.device.type != "cuda":
        raise RuntimeError(f"no W-MSA kernel for device {qkv.device}")
    nW, N, hd, code = _check(qkv, bias, num_heads)
    out = torch.empty((nW, N, num_heads * hd), dtype=qkv.dtype,
                      device=qkv.device)
    lib = build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ipe_window_msa_fwd(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), nW, N, num_heads, hd, float(hd ** -0.5), code,
            stream)
    build.check(lib, err, "window_msa_fwd launch")
    LAUNCHES += 1
    return out
