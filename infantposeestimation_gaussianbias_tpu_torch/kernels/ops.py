"""The served kernels as registered operators, for ``torch.export``.

K1 (``window_attention_qkv``), K4's forward (``fused_attn_half_fwd``),
K5's forward (``fused_mlp_half_fwd``), K9 (``qconv``) and K10
(``qdense``) as ``torch.library`` custom operators in the ``ipe``
namespace.  Each operator's one implementation calls the kernel's
wrapper, which launches the kernel for CUDA tensors (and counts the
launch) and runs the plain version for CPU tensors, as always; each
``register_fake`` gives the output's shape and dtype from the inputs, so
that ``torch.export`` traces the call as one ``torch.ops.ipe.<name>`` node
without touching data.  Without them an export would trace into the
wrapper: on the CPU it inlines the plain version into the program (a
fallback that hides the kernel), and on the card ``data_ptr()`` of a fake
tensor raises.

The models call these operators only while ``torch.export`` traces
(``torch.compiler.is_exporting()``, tools/export_model.py); every eager
call keeps the direct wrapper call, since a dispatcher hop would add host
time to each of the hundreds of kernel calls of a served batch.  A loaded
exported program (tools/export_model.load_pipeline) needs this module
imported, so that its operators resolve.  QTensor arguments enter as their
``data`` and ``scale`` tensors.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from . import fused_block, quant, window_msa

NAMESPACE = "ipe"


def _operator(fn):
    """``fn`` registered as the operator ``ipe::<fn's name>`` (no argument
    mutated), or the operator already registered under that name: a copy
    of this package imported into the same process (tools/ablate_k1.py
    does so) finds the first copy's."""
    name = fn.__name__
    if hasattr(getattr(torch.ops, NAMESPACE), name):
        return getattr(getattr(torch.ops, NAMESPACE), name)
    return torch.library.custom_op(f"{NAMESPACE}::{name}",
                                   mutates_args=())(fn)


def _fake(op, fn) -> None:
    if hasattr(op, "register_fake"):  # not one found already registered
        op.register_fake(fn)


@_operator
def window_attention_qkv(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                         num_heads: int) -> torch.Tensor:
    """K1: (nW, N, 3C) qkv -> (nW, N, C), kernels/window_msa.py."""
    return window_msa.window_attention_qkv(qkv, bias, num_heads)


def _window_attention_fake(qkv, bias, num_heads):
    nW, N, C3 = qkv.shape
    return qkv.new_empty((nW, N, C3 // 3))


@_operator
def fused_attn_half_fwd(xw: torch.Tensor, gamma: torch.Tensor,
                        beta: torch.Tensor, wqkv: torch.Tensor,
                        bqkv: torch.Tensor, rpe: torch.Tensor,
                        wproj: torch.Tensor, bproj: torch.Tensor,
                        dp: torch.Tensor, num_heads: int,
                        geom: List[int]) -> torch.Tensor:
    """K4 forward: (nW, N, C) windows -> (nW, N, C),
    kernels/fused_block.py; ``geom`` the (H, W, ws) of the map."""
    return fused_block.fused_attn_half_fwd(xw, gamma, beta, wqkv, bqkv, rpe,
                                           wproj, bproj, dp, num_heads,
                                           tuple(geom))


@_operator
def fused_mlp_half_fwd(x2: torch.Tensor, gamma: torch.Tensor,
                       beta: torch.Tensor, w1: torch.Tensor, b1: torch.Tensor,
                       w2: torch.Tensor, b2: torch.Tensor, dp: torch.Tensor,
                       tps: int) -> torch.Tensor:
    """K5 forward: (M, C) rows -> (M, C), kernels/fused_block.py."""
    return fused_block.fused_mlp_half_fwd(x2, gamma, beta, w1, b1, w2, b2,
                                          dp, tps)


def _like_first_fake(x, *args):
    return torch.empty_like(x)


@_operator
def qconv(x: torch.Tensor, x_scale: torch.Tensor, w: torch.Tensor,
          eff_scale: torch.Tensor, eff_bias: torch.Tensor, stride: int,
          relu: bool, out_scale: Optional[torch.Tensor],
          residual: Optional[torch.Tensor],
          res_scale: Optional[torch.Tensor]) -> torch.Tensor:
    """K9: int8 NHWC conv and its epilogue, kernels/quant.py."""
    return quant.qconv(x, x_scale, w, eff_scale, eff_bias, stride, relu,
                       out_scale, residual, res_scale)


def _qconv_fake(x, x_scale, w, eff_scale, eff_bias, stride, relu, out_scale,
                residual, res_scale):
    B, H, W, _ = x.shape
    Ho, Wo = quant.conv_out_size(H, W, w.shape[1], stride)
    return x.new_empty((B, Ho, Wo, w.shape[0]),
                       dtype=torch.float32 if out_scale is None
                       else torch.int8)


@_operator
def qdense(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
           bias: torch.Tensor, in_scale: torch.Tensor,
           out_dtype: torch.dtype) -> torch.Tensor:
    """K10: int8 Dense (..., K) -> (..., N), kernels/quant.py."""
    return quant.qdense(x, w, w_scale, bias, in_scale, out_dtype)


def _qdense_fake(x, w, w_scale, bias, in_scale, out_dtype):
    return x.new_empty((*x.shape[:-1], w.shape[0]), dtype=out_dtype)


_fake(window_attention_qkv, _window_attention_fake)
_fake(fused_attn_half_fwd, _like_first_fake)
_fake(fused_mlp_half_fwd, _like_first_fake)
_fake(qconv, _qconv_fake)
_fake(qdense, _qdense_fake)
