"""K6: the weight gradient of a SAME stride-1 3x3 NHWC convolution.

Ports ``conv3x3_wgrad`` (body ``_wgrad_kernel``, call ``:106``) of
infantposeestimation_gaussianbias_tpu/ops/pallas/conv_wgrad.py.
``conv3x3_wgrad`` runs the CUDA kernel of ``csrc/conv_wgrad.cu`` for
tensors on the card and the plain PyTorch version
``conv3x3_wgrad_reference`` for tensors on the CPU; on any other device, or
for a CUDA tensor the kernel does not take, it raises.

Contract: x (B, H, W, Ci) and dy (B, H, W, Co) in one dtype (the compute
dtype, float32 or bf16) -> dW (3, 3, Ci, Co) float32, the JAX layout,
  dW[dh, dw, ci, co] = sum over (b, h, w) of
                       x[b, h + dh - 1, w + dw - 1, ci] * dy[b, h, w, co]
(zero outside the map), products of the inputs as they are, summed in
float32.  It is the weight gradient of the port's SAME stride-1 ``Conv2d``
(``models/layers.py``), whose (O, I, 3, 3) ``weight.grad`` is this
permuted ``(3, 2, 0, 1)``.
"""

from __future__ import annotations

import torch

from . import build

# Kernel launches since the last reset: one per call (its partial and
# fixed-order sum passes count together), nowhere else.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# dW tiles of csrc/conv_wgrad.cu, and the blocks per SM the split of the
# pixel sum aims at (a block's 256 threads, 18 KB of shared memory and
# ~64 registers a thread leave room for about four on an SM).
_TILE = 64
_BLOCKS_PER_SM = 4
_MIN_CHUNK = 512


def splits(P: int, Q: int, M: int, sm_count: int) -> int:
    """How many chunks of the M pixel rows the kernel sums separately (then
    adds in a fixed order): about ``_BLOCKS_PER_SM`` blocks per SM over
    the (P/64) x (Q/64) tiles of dW, each chunk at least ``_MIN_CHUNK``
    rows."""
    tiles = -(-P // _TILE) * -(-Q // _TILE)
    want = -(-_BLOCKS_PER_SM * sm_count // tiles)
    return max(1, min(want, -(-M // _MIN_CHUNK)))


def conv3x3_wgrad_reference(x: torch.Tensor, dy: torch.Tensor
                            ) -> torch.Tensor:
    """Plain PyTorch version of K6: the sum of the nine shifted products
    x_shift^T dy over all pixels, in float32 (bf16 inputs enter as their
    exact float32 values; on the card this needs TF32 off)."""
    B, H, W, Ci = x.shape
    Co = dy.shape[-1]
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    d = dy.float().reshape(-1, Co)
    taps = [xp[:, dh:dh + H, dw:dw + W, :].reshape(-1, Ci).t() @ d
            for dh in range(3) for dw in range(3)]
    return torch.stack(taps).reshape(3, 3, Ci, Co)


def _check(x: torch.Tensor, dy: torch.Tensor) -> int:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if (x.dim() != 4 or not x.is_contiguous() or x.shape[-1] % 2):
        raise ValueError(f"x must be a contiguous (B, H, W, Ci) tensor of "
                         f"even Ci (the kernel reads channel pairs), got "
                         f"shape {tuple(x.shape)}")
    if (dy.dtype != x.dtype or dy.dim() != 4 or dy.shape[:3] != x.shape[:3]
            or dy.shape[-1] % 2 or not dy.is_contiguous()
            or dy.device != x.device):
        raise ValueError(f"dy must be a contiguous {x.dtype} "
                         f"{tuple(x.shape[:3])} + (even Co,) tensor on "
                         f"{x.device}, got {dy.dtype} {tuple(dy.shape)} on "
                         f"{dy.device}")
    return _DTYPE_CODES[x.dtype]


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K6: (x, dy) -> dW (3, 3, Ci, Co) float32, see the module doc.  The
    sum over pixels is taken in row chunks whose partials are added in a
    fixed order: the result does not depend on how blocks are
    scheduled."""
    global LAUNCHES
    if not build.on_card(x, "3x3 weight-gradient"):
        return conv3x3_wgrad_reference(x, dy)
    code = _check(x, dy)
    B, H, W, Ci = x.shape
    Co = dy.shape[-1]
    P, M = 9 * Ci, B * H * W
    n = splits(P, Co, M, torch.cuda.get_device_properties(
        x.device).multi_processor_count)
    out = torch.empty((3, 3, Ci, Co), dtype=torch.float32, device=x.device)
    partial = torch.empty((n, P, Co), dtype=torch.float32, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.ipe_conv3x3_wgrad(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(), partial.data_ptr(),
            B, H, W, Ci, Co, n, code,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "conv3x3_wgrad launch")
    LAUNCHES += 1
    return out
