"""K9 and K10: the int8 products of int8 PTQ serving (ops/quant.py).

Neither replaces a TPU kernel: the JAX package leaves both to XLA (its
ops/quant.py ``qconv``/``qconv_affine``, an int8 ``conv_general_dilated``
with int32 accumulation, and ``qdense``, an int8 ``dot_general``).  Stock
PyTorch has no CUDA int8 convolution, and ``torch._int_mm`` wants K and N
in multiples of 8, so both are hand-written (``csrc/qgemm.cu``, one
tensor-core core).

``qconv`` (K9): int8 NHWC x (B, H, W, C) with its 0-d float32 scale,
weights (Co, kh, kw, C) int8 (``ops.quant.conv_weight_layout``),
per-output-channel eff_scale and eff_bias (float32), symmetric padding
kh // 2, stride 1 or 2, then the fused epilogue

    y = acc * (x_scale * eff_scale) + eff_bias
    y = y + residual * res_scale    (int8 residual)   or   y + residual (f32)
    y = max(y, 0)                   (relu)
    int8 clamp(round(y * (1 / out_scale)), -127, 127)  or  float32 y

``qdense`` (K10): rows x (..., K) in float32 or bf16, quantised with the
static ``in_scale`` as clamp(round(x * (1 / in_scale)), -127, 127), times
w (N, K) int8 into int32, then ``acc * (in_scale * w_scale) + bias``
written in ``out_dtype``.

Each runs its CUDA kernel for tensors on the card and its plain version
(``qconv_reference``, ``qdense_reference``) for tensors on the CPU; any
other device, or a CUDA tensor the kernel does not take, raises.  The
plain versions take the int8 products exactly, in float64 (every partial
sum of int8 products at these depths is an integer below 2^53), and the
float steps one torch op at a time, so kernel and plain version agree bit
for bit.  Rounding is half to even, as ``jnp.round``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from . import build

# Kernel launches since the last reset: one per call, nowhere else.
CONV_LAUNCHES = 0
DENSE_LAUNCHES = 0

INT8_MAX = 127.0
# csrc/qgemm.cu's A sources, residual kinds and output kinds.
_CONV_VEC, _CONV_BYTE, _DENSE_F32, _DENSE_BF16 = 0, 1, 2, 3
_RES_NONE, _RES_INT8, _RES_F32 = 0, 1, 2
_OUT_CODES = {torch.float32: 0, torch.int8: 1, torch.bfloat16: 2}


def requantize_values(y: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    """float32 -> int8 with a static scale: clamp(round(y * (1 / scale)),
    -127, 127), the reciprocal taken once in float32 (never -128);
    contiguous, as K9 reads its input."""
    inv = 1.0 / scale.float()
    q = torch.clamp(torch.round(y * inv), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8).contiguous()


def conv_out_size(H: int, W: int, k: int, stride: int) -> tuple:
    p = k // 2
    return (H + 2 * p - k) // stride + 1, (W + 2 * p - k) // stride + 1


def _epilogue(acc: torch.Tensor, scale: torch.Tensor, col_scale: torch.Tensor,
              col_bias: torch.Tensor, residual: Optional[torch.Tensor],
              res_scale: Optional[torch.Tensor], relu: bool,
              out_scale: Optional[torch.Tensor]) -> torch.Tensor:
    y = acc.float() * (scale.float() * col_scale) + col_bias
    if residual is not None:
        if residual.dtype == torch.int8:
            y = y + residual.float() * res_scale.float()
        else:
            y = y + residual
    if relu:
        y = torch.clamp_min(y, 0.0)
    return y if out_scale is None else requantize_values(y, out_scale)


def qconv_reference(x: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
                    eff_scale: torch.Tensor, eff_bias: torch.Tensor,
                    stride: int = 1, relu: bool = False,
                    out_scale: Optional[torch.Tensor] = None,
                    residual: Optional[torch.Tensor] = None,
                    res_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain PyTorch version of K9: the int8 conv as an exact float64
    convolution of the int8 values (rounded to int32), then the epilogue
    one op at a time."""
    k = w.shape[1]
    acc = F.conv2d(x.double().permute(0, 3, 1, 2),
                   w.double().permute(0, 3, 1, 2), stride=stride,
                   padding=k // 2)
    acc = torch.round(acc.permute(0, 2, 3, 1)).to(torch.int32)
    return _epilogue(acc, x_scale, eff_scale, eff_bias, residual, res_scale,
                     relu, out_scale).contiguous()


def qdense_reference(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
                     bias: torch.Tensor, in_scale: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain PyTorch version of K10: quantise x with ``in_scale``, the int8
    product exactly in float64 (rounded to int32), then the epilogue."""
    inv = 1.0 / in_scale.float()
    xq = torch.clamp(torch.round(x.float() * inv), -INT8_MAX, INT8_MAX)
    acc = torch.round(xq.double() @ w.double().t()).to(torch.int32)
    return _epilogue(acc, in_scale, w_scale, bias, None, None, False,
                     None).to(out_dtype)


def _f32_vector(t: torch.Tensor, n: int, name: str, device) -> None:
    if (t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name} must be a contiguous float32 ({n},) tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _f32_scalar(t: torch.Tensor, name: str, device) -> None:
    if t.dtype != torch.float32 or t.numel() != 1 or t.device != device:
        raise ValueError(f"{name} must be a one-element float32 tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _launch(src: int, a, w, a_scale, col_scale, col_bias, res, res_scale,
            out_scale, out, M: int, N: int, K: int, geom: tuple,
            res_kind: int, relu: bool, what: str) -> None:
    lib = build.load()
    ptr = lambda t: None if t is None else t.data_ptr()  # noqa: E731
    with torch.cuda.device(a.device):
        err = lib.ipe_qgemm(
            src, a.data_ptr(), w.data_ptr(), a_scale.data_ptr(),
            col_scale.data_ptr(), col_bias.data_ptr(), ptr(res),
            ptr(res_scale), ptr(out_scale), out.data_ptr(), M, N, K, *geom,
            res_kind, _OUT_CODES[out.dtype], int(relu),
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, what)


def qconv(x: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
          eff_scale: torch.Tensor, eff_bias: torch.Tensor, stride: int = 1,
          relu: bool = False, out_scale: Optional[torch.Tensor] = None,
          residual: Optional[torch.Tensor] = None,
          res_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K9, see the module doc: int8 (B, Ho, Wo, Co) when ``out_scale`` is
    given, else float32.  ``residual``: (B, Ho, Wo, Co) int8 (with
    ``res_scale``) or float32, added before the relu."""
    global CONV_LAUNCHES
    if not build.on_card(x, "int8 conv"):
        return qconv_reference(x, x_scale, w, eff_scale, eff_bias, stride,
                               relu, out_scale, residual, res_scale)
    if x.dtype != torch.int8 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int8 (B, H, W, C) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, H, W, C = x.shape
    if (w.dtype != torch.int8 or w.dim() != 4 or w.shape[3] != C
            or w.shape[1] != w.shape[2] or not w.is_contiguous()
            or w.device != x.device):
        raise ValueError(f"w must be a contiguous int8 (Co, k, k, {C}) tensor "
                         f"on {x.device}, got {w.dtype} {tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    Co, k = w.shape[0], w.shape[1]
    Ho, Wo = conv_out_size(H, W, k, stride)
    _f32_scalar(x_scale, "x_scale", x.device)
    _f32_vector(eff_scale, Co, "eff_scale", x.device)
    _f32_vector(eff_bias, Co, "eff_bias", x.device)
    res_kind = _RES_NONE
    if residual is not None:
        if (residual.shape != (B, Ho, Wo, Co) or not residual.is_contiguous()
                or residual.device != x.device
                or residual.dtype not in (torch.int8, torch.float32)):
            raise ValueError(f"residual must be a contiguous int8 or float32 "
                             f"{(B, Ho, Wo, Co)} tensor on {x.device}, got "
                             f"{residual.dtype} {tuple(residual.shape)}")
        res_kind = _RES_INT8 if residual.dtype == torch.int8 else _RES_F32
        if res_kind == _RES_INT8:
            _f32_scalar(res_scale, "res_scale", x.device)
    if out_scale is not None:
        _f32_scalar(out_scale, "out_scale", x.device)
    out = torch.empty((B, Ho, Wo, Co), device=x.device,
                      dtype=torch.float32 if out_scale is None else torch.int8)
    vec = C % 16 == 0 and x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    _launch(_CONV_VEC if vec else _CONV_BYTE, x, w, x_scale, eff_scale,
            eff_bias, residual, res_scale if res_kind == _RES_INT8 else None,
            out_scale, out, B * Ho * Wo, Co, k * k * C,
            (H, W, C, Ho, Wo, k, stride, k // 2), res_kind, relu,
            "int8 conv launch")
    CONV_LAUNCHES += 1
    return out


def qdense(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
           bias: torch.Tensor, in_scale: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K10, see the module doc: x (..., K) float32 or bf16 -> (..., N) in
    ``out_dtype`` (float32 or bf16)."""
    global DENSE_LAUNCHES
    if not build.on_card(x, "int8 dense"):
        return qdense_reference(x, w, w_scale, bias, in_scale, out_dtype)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    if out_dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"out_dtype must be float32 or bfloat16, got "
                        f"{out_dtype}")
    K = x.shape[-1]
    if (w.dtype != torch.int8 or w.dim() != 2 or w.shape[1] != K
            or not w.is_contiguous() or w.device != x.device):
        raise ValueError(f"w must be a contiguous int8 (N, {K}) tensor on "
                         f"{x.device}, got {w.dtype} {tuple(w.shape)}")
    N = w.shape[0]
    _f32_vector(w_scale, N, "w_scale", x.device)
    _f32_vector(bias, N, "bias", x.device)
    _f32_scalar(in_scale, "in_scale", x.device)
    rows = x.reshape(-1, K).contiguous()
    M = rows.shape[0]
    out = torch.empty((*x.shape[:-1], N), device=x.device, dtype=out_dtype)
    if M:
        _launch(_DENSE_F32 if x.dtype == torch.float32 else _DENSE_BF16,
                rows, w, in_scale, w_scale, bias, None, None, None, out, M, N,
                K, (1, 1, K, 1, 1, 1, 1, 0), _RES_NONE, False,
                "int8 dense launch")
        DENSE_LAUNCHES += 1
    return out
