"""K7: the fused HRNet residual chain, inference.

Ports ``fused_residual_chain`` (body ``_chain_kernel``, call ``:87``) and
its packer ``pack_basic_block_params`` (``:104``) of
infantposeestimation_gaussianbias_tpu/ops/pallas/residual_block.py.
``fused_residual_chain`` runs the CUDA kernel of ``csrc/residual_block.cu``
for tensors on the card and the plain PyTorch version
``fused_residual_chain_reference`` for tensors on the CPU; on any other
device, or for a CUDA tensor the kernel does not take, it raises.

Contract, the TPU kernel's arithmetic (``residual_block.py:48-62`` there):
  x (B, H, W, C) float32 or bf16; weights (2n, 9C, C) float32 or bf16, the
  im2col layout (taps in (dy, dx, c) order); affines (2n, 2, C) float32,
  the folded BatchNorm (a, b) of each conv.  x is carried in float32 along
  the whole chain:
    y = relu(conv3x3(x in the weights' dtype) * a1 + b1)      float32
    x = relu(conv3x3(y in the weights' dtype) * a2 + b2 + x)   float32
  every product accumulating in float32 (SAME zero padding, stride 1); only
  the output is cast back to x's dtype.  The port's eval-mode BasicBlocks
  instead round to the compute dtype after every conv, BatchNorm and
  residual add, so in bf16 the chain and the model's blocks differ by a few
  bf16 roundings per block.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

# Kernel launches since the last reset: one per chain (its 2n conv
# launches count together), nowhere else.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def pack_basic_block_params(blocks: Sequence, dtype=torch.bfloat16,
                            eps: float = 1e-5
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The port's BasicBlock modules -> the kernel's (weights (2n, 9C, C)
    in ``dtype``, affines (2n, 2, C) float32): each conv weight (O, I, 3, 3)
    as ``permute(2, 3, 1, 0).reshape(9C, C)``; a = weight * rsqrt(var +
    eps), b = bias - mean * a from the BatchNorm's running statistics, in
    float32.  BatchNorm only, as the JAX package's fold (models/fold.py):
    a block with another norm raises."""
    ws, abs_ = [], []
    with torch.no_grad():
        for blk in blocks:
            for conv, bn in ((blk.conv1, blk.bn1), (blk.conv2, blk.bn2)):
                if getattr(bn, "running_var", None) is None:
                    raise ValueError(f"K7 folds BatchNorm, not "
                                     f"{type(bn).__name__}")
                C = conv.weight.shape[0]
                ws.append(conv.weight.permute(2, 3, 1, 0).reshape(9 * C, C)
                          .to(dtype))
                a = bn.weight.float() * torch.rsqrt(bn.running_var.float()
                                                    + eps)
                b = bn.bias.float() - bn.running_mean.float() * a
                abs_.append(torch.stack([a, b]))
    return torch.stack(ws).contiguous(), torch.stack(abs_).contiguous()


def _conv3x3(x: torch.Tensor, w9: torch.Tensor) -> torch.Tensor:
    """SAME 3x3 conv of the float32 NHWC map x with the (9C, C) im2col
    weight, in float32."""
    C = w9.shape[1]
    w = w9.float().reshape(3, 3, -1, C).permute(3, 2, 0, 1)
    return F.conv2d(x.permute(0, 3, 1, 2), w, padding=1).permute(0, 2, 3, 1)


def fused_residual_chain_reference(x: torch.Tensor, weights: torch.Tensor,
                                   affines: torch.Tensor,
                                   num_blocks: int) -> torch.Tensor:
    """Plain PyTorch version of K7 (see the module doc).  A bf16 operand
    enters the float32 conv as its exact float32 value, so each product is
    the TPU kernel's bf16 x bf16 -> f32 one; on the card this needs TF32
    off for float32 convolutions."""
    wdt = weights.dtype
    xf = x.float()
    for b in range(num_blocks):
        a1, b1 = affines[2 * b]
        a2, b2 = affines[2 * b + 1]
        y = torch.relu(_conv3x3(xf.to(wdt).float(), weights[2 * b]) * a1 + b1)
        z = _conv3x3(y.to(wdt).float(), weights[2 * b + 1])
        xf = torch.relu(z * a2 + b2 + xf)
    return xf.to(x.dtype)


def _check(x: torch.Tensor, weights: torch.Tensor, affines: torch.Tensor,
           num_blocks: int) -> None:
    for name, t in (("x", x), ("weights", weights)):
        if t.dtype not in _DTYPE_CODES:
            raise TypeError(f"{name} must be float32 or bfloat16, got "
                            f"{t.dtype}")
    if x.dim() != 4 or not x.is_contiguous() or x.shape[-1] % 2:
        raise ValueError(f"x must be a contiguous (B, H, W, C) tensor of even "
                         f"C (the kernel reads channel pairs), got shape "
                         f"{tuple(x.shape)}")
    C = x.shape[-1]
    n = 2 * num_blocks
    if (tuple(weights.shape) != (n, 9 * C, C) or not weights.is_contiguous()
            or weights.device != x.device):
        raise ValueError(f"weights must be a contiguous ({n}, {9 * C}, "
                         f"{C}) tensor on {x.device}, got "
                         f"{tuple(weights.shape)} on {weights.device}")
    if (affines.dtype != torch.float32 or tuple(affines.shape) != (n, 2, C)
            or not affines.is_contiguous() or affines.device != x.device):
        raise ValueError(f"affines must be a contiguous float32 ({n}, 2, "
                         f"{C}) tensor on {x.device}, got {affines.dtype} "
                         f"{tuple(affines.shape)} on {affines.device}")


def fused_residual_chain(x: torch.Tensor, weights: torch.Tensor,
                         affines: torch.Tensor,
                         num_blocks: int) -> torch.Tensor:
    """K7: ``num_blocks`` BasicBlocks with folded BatchNorm on (B, H, W, C)
    -> (B, H, W, C) in x's dtype, see the module doc."""
    global LAUNCHES
    if not build.on_card(x, "residual chain"):
        return fused_residual_chain_reference(x, weights, affines, num_blocks)
    _check(x, weights, affines, num_blocks)
    B, H, W, C = x.shape
    out = torch.empty_like(x)
    carry = torch.empty((B, H, W, C), dtype=torch.float32, device=x.device)
    y = torch.empty((B, H, W, C), dtype=weights.dtype, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.ipe_residual_chain(
            x.data_ptr(), weights.data_ptr(), affines.data_ptr(),
            out.data_ptr(), carry.data_ptr(), y.data_ptr(), B, H, W, C,
            num_blocks, _DTYPE_CODES[x.dtype], _DTYPE_CODES[weights.dtype],
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "residual_chain launch")
    LAUNCHES += 1
    return out
