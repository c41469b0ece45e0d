"""K4 and K5: the fused HRFormer half-block kernels, forward and backward.

K5 ports ``fused_mlp_half`` and K4 ports ``fused_attn_half`` of
infantposeestimation_gaussianbias_tpu/ops/pallas/fused_block.py (forward
calls ``:220`` and ``:562``, backward calls ``:260`` and ``:608``):

  fused_mlp_half:  y = x + dp * fc2(gelu_tanh(fc1(LN(x))))  on (M, C) rows
  fused_attn_half: y = x + dp * proj(W-MSA(qkv(LN(x))))    on (nW, N, C)

``fused_mlp_half_fwd``/``_bwd`` and ``fused_attn_half_fwd``/``_bwd`` run
the CUDA kernels of ``csrc/fused_mlp.cu`` and ``csrc/fused_attn.cu`` for
tensors on the card and the plain PyTorch versions ``*_reference`` for
tensors on the CPU; on any other device, or for a CUDA tensor the kernel
does not take, they raise.  ``fused_mlp_half`` and ``fused_attn_half`` join
each pair in a ``torch.autograd.Function``.

Contract, the TPU kernels' maths:
  * LayerNorm statistics in float32, eps 1e-5;
  * every matrix product rounds its ACTIVATION operand to bf16 and
    accumulates in float32, whatever the model's dtype: ``ln`` before fc1
    and qkv, ``g`` before fc2, ``o`` before proj; in the backward ``do``,
    ``dh``, ``dpo``, ``o``, ``dqkv * valid`` and ``ln``.  The weights enter
    as they are (bf16 in a bf16 model, float32 in a float32 one), so a
    float32 model through this path is not pure float32 maths;
  * the attention scores, softmax and P·V stay float32; q is scaled by
    hd^-0.5 (rounded to float32) before q·k^T, and dk takes the unscaled q
    with the scale applied after (the CUDA kernels take these products in
    split-bf16 terms on the tensor cores, csrc/wmsa_core.cuh, within the
    bounds chip_smoke.py states);
  * GELU is the tanh form;
  * window padding: a token outside the (H, W) map enters attention as the
    qkv bias row (the reference zero-pads the normalised map); dWqkv and
    dLN take ``dqkv * valid``, dbqkv sums dqkv over every token, padding
    included.  Pad-token rows of y are computed like any other and cropped
    by ``window_reverse``;
  * DropPath: ``dp`` is a (B,) float32 per-sample scale (mask / (1 - rate));
    row r of the MLP half belongs to sample r // tps, window w of the
    attention half to sample w // nwin.

Layouts: x (M, C) or (nW, N, C) float32 or bf16; gamma, beta, biases 1-D
float32; weights in the JAX layout (in, out) in x's dtype (the model passes
the transposed view of its ``nn.Linear`` weight, which is the (out, in)
layout the kernels read); rpe (heads, N, N) float32.  Gradients: dx in x's
dtype, dW in the weight's dtype, everything else float32.
"""

from __future__ import annotations

import functools
import math
from typing import Tuple

import torch
import torch.nn.functional as F

from . import build
from .window_msa import (K4_CORE_TERMS, MAX_HEAD_DIM, MAX_TOKENS,
                         attention_fwd_core_emulation, bwd_windows_per_block)

# Kernel launches since the last reset, one per wrapper call that launches
# (a backward's reduction passes count with it), nowhere else.
MLP_LAUNCHES = 0
MLP_BWD_LAUNCHES = 0
ATTN_LAUNCHES = 0
ATTN_BWD_LAUNCHES = 0

LN_EPS = 1e-5
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_GELU_C = 0.044715
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# Output tiles of the weight-gradient reduction (csrc/fused_common.cuh).
_ATB_TILE = 128
# Weight-gradient blocks per SM that the split of the row sum aims at.
_ATB_BLOCKS_PER_SM = 2
# K5's product tiles (csrc/fused_mlp.cu TileS, TileM, TileL; plan ids 0-2):
# (rows, columns) of one block's output tile.
MLP_TILES = ((64, 64), (64, 128), (128, 128))
# bf16 terms per weight element by dtype code: float32 3, bf16 1.
_TERMS = {0: 3, 1: 1}


def _bf16(t: torch.Tensor) -> torch.Tensor:
    """Round a float32 tensor to bf16 and back (round to nearest even)."""
    return t.to(torch.bfloat16).float()


def gelu_tanh(h: torch.Tensor) -> torch.Tensor:
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    return 0.5 * h * (1.0 + torch.tanh(u))


def gelu_tanh_grad(h: torch.Tensor) -> torch.Tensor:
    u = _SQRT_2_OVER_PI * (h + _GELU_C * h * h * h)
    t = torch.tanh(u)
    du = _SQRT_2_OVER_PI * (1.0 + 3.0 * _GELU_C * h * h)
    return 0.5 * (1.0 + t) + 0.5 * h * (1.0 - t * t) * du


def _layernorm(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor):
    mu = x.mean(dim=-1, keepdim=True)
    var = (x - mu).square().mean(dim=-1, keepdim=True)
    rstd = torch.rsqrt(var + LN_EPS)
    xhat = (x - mu) * rstd
    return xhat * gamma + beta, xhat, rstd


def _layernorm_bwd(dln, xhat, rstd, gamma):
    dxhat = dln * gamma
    m1 = dxhat.mean(dim=-1, keepdim=True)
    m2 = (dxhat * xhat).mean(dim=-1, keepdim=True)
    return (dxhat - m1 - xhat * m2) * rstd


def _row_scale(dp: torch.Tensor, rows: int, per: int) -> torch.Tensor:
    """(rows, 1) DropPath scale: row r takes dp[r // per]."""
    idx = torch.arange(rows, device=dp.device) // per
    return dp.float()[idx][:, None]


# -- K5, the MLP half ----------------------------------------------------------

def fused_mlp_half_reference(x2, gamma, beta, w1, b1, w2, b2, dp,
                             tps: int) -> torch.Tensor:
    """Plain PyTorch version of K5's forward (``_mlp_half_fwd_kernel``)."""
    x = x2.float()
    ln, _, _ = _layernorm(x, gamma.float(), beta.float())
    h = _bf16(ln) @ w1.float() + b1.float()
    o = _bf16(gelu_tanh(h)) @ w2.float() + b2.float()
    return (x + _row_scale(dp, x.shape[0], tps) * o).to(x2.dtype)


def fused_mlp_half_bwd_reference(x2, gamma, beta, w1, b1, w2, b2, dp, dy,
                                 tps: int):
    """Plain PyTorch version of K5's backward (``_mlp_half_bwd_kernel``):
    (dx, dgamma, dbeta, dw1, db1, dw2, db2)."""
    x = x2.float()
    g32 = gamma.float()
    ln, xhat, rstd = _layernorm(x, g32, beta.float())
    lnb = _bf16(ln)
    h = lnb @ w1.float() + b1.float()
    gb = _bf16(gelu_tanh(h))
    dyf = dy.float()
    do = _row_scale(dp, x.shape[0], tps) * dyf
    dob = _bf16(do)
    dw2 = gb.t() @ dob
    db2 = do.sum(dim=0)
    dh = (dob @ w2.float().t()) * gelu_tanh_grad(h)
    dhb = _bf16(dh)
    dw1 = lnb.t() @ dhb
    db1 = dh.sum(dim=0)
    dln = dhb @ w1.float().t()
    dgamma = (dln * xhat).sum(dim=0)
    dbeta = dln.sum(dim=0)
    dx = dyf + _layernorm_bwd(dln, xhat, rstd, g32)
    return (dx.to(x2.dtype), dgamma, dbeta, dw1.to(w1.dtype), db1,
            dw2.to(w2.dtype), db2)


# -- K4, the attention half ------------------------------------------------------

def window_geometry(geom: Tuple[int, int, int]) -> Tuple[int, int]:
    """(windows per image, windows per row) of an (H, W, ws) map."""
    H, W, ws = geom
    nww = -(-W // ws)
    return nww * -(-H // ws), nww


def valid_tokens(nW: int, N: int, geom: Tuple[int, int, int],
                 device=None) -> torch.Tensor:
    """(nW, N, 1) bool: token t of window w lies inside the (H, W) map
    (``_valid_mask`` of the TPU kernel without its token-tile padding)."""
    H, W, ws = geom
    nwin, nww = window_geometry(geom)
    w = torch.arange(nW, device=device)[:, None] % nwin
    t = torch.arange(N, device=device)[None, :]
    row = (w // nww) * ws + t // ws
    col = (w % nww) * ws + t % ws
    return ((row < H) & (col < W))[..., None]


def _attn_forward_parts(xw, gamma, beta, wqkv, bqkv, rpe, num_heads, geom):
    """Shared recompute: (lnb, xhat, rstd, qkv (masked, unscaled), probs,
    o), per-head tensors as (nW, heads, N, .)."""
    nW, N, C = xw.shape
    hd = C // num_heads
    scale = hd ** -0.5
    x = xw.float()
    ln, xhat, rstd = _layernorm(x, gamma.float(), beta.float())
    lnb = _bf16(ln)
    b = bqkv.float()
    qkv = torch.where(valid_tokens(nW, N, geom, xw.device),
                      lnb @ wqkv.float() + b, b)
    heads = qkv.reshape(nW, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = heads[0], heads[1], heads[2]
    s = (q * scale) @ k.transpose(-2, -1) + rpe.float()[None]
    p = torch.softmax(s, dim=-1)
    o = (p @ v).permute(0, 2, 1, 3).reshape(nW, N, C)
    return lnb, xhat, rstd, qkv, (q, k, v), p, o


def fused_attn_half_reference(xw, gamma, beta, wqkv, bqkv, rpe, wproj, bproj,
                              dp, num_heads: int,
                              geom: Tuple[int, int, int]) -> torch.Tensor:
    """Plain PyTorch version of K4's forward (``_attn_half_fwd_kernel``)."""
    nW = xw.shape[0]
    *_, o = _attn_forward_parts(xw, gamma, beta, wqkv, bqkv, rpe, num_heads,
                                geom)
    po = _bf16(o) @ wproj.float() + bproj.float()
    scale = _row_scale(dp, nW, window_geometry(geom)[0])[:, :, None]
    return (xw.float() + scale * po).to(xw.dtype)


def fused_attn_half_fwd_emulation(xw, gamma, beta, wqkv, bqkv, rpe, wproj,
                                  bproj, dp, num_heads: int,
                                  geom: Tuple[int, int, int]) -> torch.Tensor:
    """K4's staged forward (csrc/fused_attn.cu) in plain PyTorch, on the
    CPU: (a) the LayerNorm into bf16 rows; (b) per head, q, k, v = lnb
    Wqkv_h + bqkv (the bias row for a pad token), then the forward core's
    split-bf16 arithmetic (``attention_fwd_core_emulation``, q, k, v in
    ``K4_CORE_TERMS`` terms), rounded to bf16; (c) y = x + dp * (ob Wproj
    + bproj).  The weights enter as they are: a float32 weight's three bf16
    terms sum to it exactly and each product of terms is exact.  For the
    tests only: no model path runs it."""
    nW, N, C = xw.shape
    hd = C // num_heads
    x = xw.float()
    ln, _, _ = _layernorm(x, gamma.float(), beta.float())
    b = bqkv.float()
    qkv = torch.where(valid_tokens(nW, N, geom, xw.device),
                      _bf16(ln) @ wqkv.float() + b, b)
    q, k, v = qkv.reshape(nW, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    o = attention_fwd_core_emulation(q, k, v, rpe.float(), K4_CORE_TERMS)
    ob = _bf16(o.permute(0, 2, 1, 3).reshape(nW, N, C))
    po = ob @ wproj.float() + bproj.float()
    scale = _row_scale(dp, nW, window_geometry(geom)[0])[:, :, None]
    return (x + scale * po).to(xw.dtype)


def fused_attn_half_bwd_reference(xw, gamma, beta, wqkv, bqkv, rpe, wproj,
                                  bproj, dp, dy, num_heads: int,
                                  geom: Tuple[int, int, int]):
    """Plain PyTorch version of K4's backward (``_attn_half_bwd_kernel``):
    (dx, dgamma, dbeta, dwqkv, dbqkv, drpe, dwproj, dbproj)."""
    nW, N, C = xw.shape
    hd = C // num_heads
    scale = hd ** -0.5
    g32 = gamma.float()
    lnb, xhat, rstd, _, (q, k, v), p, o = _attn_forward_parts(
        xw, gamma, beta, wqkv, bqkv, rpe, num_heads, geom)
    dyf = dy.float()
    dpo = _row_scale(dp, nW, window_geometry(geom)[0])[:, :, None] * dyf
    dpob = _bf16(dpo)
    ob = _bf16(o)
    dwproj = ob.reshape(-1, C).t() @ dpob.reshape(-1, C)
    dbproj = dpo.sum(dim=(0, 1))
    do = (dpob @ wproj.float().t()).reshape(nW, N, num_heads, hd)
    do = do.permute(0, 2, 1, 3)
    dv = p.transpose(-2, -1) @ do
    dprob = do @ v.transpose(-2, -1)
    ds = p * (dprob - (dprob * p).sum(dim=-1, keepdim=True))
    drpe = ds.sum(dim=0)
    dq = scale * (ds @ k)
    dk = scale * (ds.transpose(-2, -1) @ q)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(
        nW, N, 3 * C)
    dbqkv = dqkv.sum(dim=(0, 1))
    dqkv_v = _bf16(dqkv * valid_tokens(nW, N, geom, xw.device))
    dwqkv = lnb.reshape(-1, C).t() @ dqkv_v.reshape(-1, 3 * C)
    dln = dqkv_v @ wqkv.float().t()
    dgamma = (dln * xhat).sum(dim=(0, 1))
    dbeta = dln.sum(dim=(0, 1))
    dx = dyf + _layernorm_bwd(dln, xhat, rstd, g32)
    return (dx.to(xw.dtype), dgamma, dbeta, dwqkv.to(wqkv.dtype), dbqkv,
            drpe, dwproj.to(wproj.dtype), dbproj)


# -- the CUDA path ----------------------------------------------------------------

def _code(x: torch.Tensor, weights) -> int:
    if x.dtype not in _DTYPE_CODES:
        raise TypeError(f"x must be float32 or bfloat16, got {x.dtype}")
    for w in weights:
        if w.dtype != x.dtype:
            raise TypeError(f"the kernels take weights in x's dtype "
                            f"{x.dtype}, got {w.dtype}")
    return _DTYPE_CODES[x.dtype]


def _check_weight(w: torch.Tensor, rows: int, cols: int, dev) -> None:
    if tuple(w.shape) != (rows, cols) or w.device != dev:
        raise ValueError(f"weight must be ({rows}, {cols}) on {dev}, got "
                         f"{tuple(w.shape)} on {w.device}")


def _out_in(w: torch.Tensor, rows: int, cols: int, dev) -> torch.Tensor:
    """A JAX-layout (in, out) = (rows, cols) weight as the contiguous
    (out, in) tensor the forward products read: no copy for the transposed
    view of an nn.Linear weight."""
    _check_weight(w, rows, cols, dev)
    return w.t().contiguous()


def _in_out(w: torch.Tensor, rows: int, cols: int, dev) -> torch.Tensor:
    """The same weight in its (in, out) layout, contiguous (a copy for the
    transposed view of an nn.Linear weight): its rows are the columns the
    backward's products read."""
    _check_weight(w, rows, cols, dev)
    return w.contiguous()


def _vec(v: torch.Tensor, n: int, dev, what: str) -> torch.Tensor:
    if v.numel() != n or v.device != dev:
        raise ValueError(f"{what} must hold {n} values on {dev}, got "
                         f"{tuple(v.shape)} on {v.device}")
    return v.reshape(n).float().contiguous()


def _scratch(dev, *nbytes: int) -> tuple:
    """One allocation holding buffers of the given sizes, each 256-byte
    aligned: (the allocation, which the caller keeps until its launches are
    queued, and each buffer's address)."""
    offsets, total = [], 0
    for n in nbytes:
        offsets.append(total)
        total += -(-n // 256) * 256
    buf = torch.empty((max(total, 1),), dtype=torch.uint8, device=dev)
    base = buf.data_ptr()
    return buf, [base + o for o in offsets]


def _check_x(x: torch.Tensor, dims: int) -> None:
    if x.dim() != dims or not x.is_contiguous() or x.shape[-1] % 2:
        raise ValueError(f"x must be a contiguous {dims}-d tensor of even "
                         f"width (the kernels read bf16 pairs), got shape "
                         f"{tuple(x.shape)}")


def _check_dp(dp: torch.Tensor, samples: int) -> None:
    if dp.numel() < samples:
        raise ValueError(f"dp holds {dp.numel()} scales for {samples} "
                         f"samples")


def _check_dy(dy: torch.Tensor, x: torch.Tensor) -> None:
    if (dy.dtype != x.dtype or dy.shape != x.shape or not dy.is_contiguous()
            or dy.device != x.device):
        raise ValueError(f"dy must be a contiguous {x.dtype} "
                         f"{tuple(x.shape)} tensor on {x.device}, got "
                         f"{dy.dtype} {tuple(dy.shape)} on {dy.device}")


def atb_splits(P: int, Q: int, M: int, sm_count: int) -> int:
    """How many row chunks the weight-gradient reduction sums separately
    (then adds in a fixed order): enough that the grid holds about
    ``_ATB_BLOCKS_PER_SM`` blocks per SM, at most one chunk per 256 rows."""
    tiles = -(-P // _ATB_TILE) * -(-Q // _ATB_TILE)
    want = -(-_ATB_BLOCKS_PER_SM * sm_count // tiles)
    return max(1, min(want, -(-M // 256)))


def _sms(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def mlp_blocks(M: int, n: int, tile: int) -> int:
    """Blocks of a K5 product stage over an (M, n) output in tile ``tile``
    of ``MLP_TILES``, one output tile per block."""
    bm, bn = MLP_TILES[tile]
    return -(-M // bm) * -(-n // bn)


def _mlp_tile(M: int, n: int, sm_count: int, largest: int = 2) -> int:
    """The largest tile, up to ``largest``, whose grid over (M, n) holds one
    wave of ``sm_count`` blocks; the smallest where none does."""
    for tile in range(largest, 0, -1):
        if mlp_blocks(M, n, tile) >= sm_count:
            return tile
    return 0


@functools.lru_cache(maxsize=256)
def mlp_plan(M: int, C: int, hidden: int, sm_count: int,
             terms: int = 1) -> dict:
    """What K5's launches take and its scratch needs (csrc/fused_mlp.cu) on
    M rows of width C, ``terms`` bf16 terms per weight (1 bf16, 3 float32).
    Cached: the wrappers call it per launch; callers do not change it.

    ``width``: C rounded up to 8, the row stride of lnb, dob and W1's
    padded rows (16-byte rows for cp.async and ldmatrix).  ``fc1``,
    ``fc2`` (forward), ``hidden`` (backward stage (b)) and ``dln`` (stage
    (c)): each product stage's tile id in ``MLP_TILES`` (``_mlp_tile``; the
    hidden stage, which holds two accumulator sets, at most the 64 x 128
    one).  ``single``: in float32 at C <= 160 (hrformer_base's b0 and b1),
    the forward's single-block form (``mlp_fwd_f32_rows_kernel``, one block
    per 64 rows, the float32 weights read from L1/L2), where the staged
    stages, three weight terms a slice at one block per SM, do not beat it.
    ``rows_per_block``: the LayerNorm stages' rows per block (8 to 64, as
    many as keep one block per SM).  ``atb_splits``: the row chunks of dW1
    and dW2.  Partial rows: ``part_rows`` [dgamma | dbeta | db2] per
    LayerNorm block, ``part_hidden`` db1 per row tile of the hidden stage.

    At every hrformer_base branch (C 78-624, hidden 4C) at b = 32 and 64,
    window 7 and 8 (M >= 2,048) and 132 SMs, every stage but one holds at
    least one wave of 132 blocks (tests/test_torch_fused_mlp_plan.py): the
    fixed-order column sums of the partial rows, ceil(width / 32) blocks
    over at most a few thousand rows, a few microseconds, where more
    blocks would only add partial rows.  Shared memory is the kernels'
    own: csrc/fused_mlp.cu asserts at compile time that every tile fits."""
    if C % 2 or C > 640 or hidden % 8:
        raise ValueError(f"K5 takes an even C <= 640 and hidden % 8 == 0, "
                         f"got C={C}, hidden={hidden}")
    if -(-M // MLP_TILES[0][0]) > 65535:
        raise ValueError(f"K5 takes at most {65535 * MLP_TILES[0][0]} rows, "
                         f"got {M}")
    rpb = max(8, min(64, M // sm_count // 8 * 8))
    plan = dict(width=-(-C // 8) * 8, rows_per_block=rpb,
                fc1=_mlp_tile(M, hidden, sm_count),
                fc2=_mlp_tile(M, C, sm_count),
                hidden=_mlp_tile(M, hidden, sm_count, largest=1),
                dln=_mlp_tile(M, C, sm_count),
                single=terms == 3 and C <= 160,
                atb_splits=(atb_splits(hidden, C, M, sm_count),
                            atb_splits(C, hidden, M, sm_count)))
    plan["part_rows"] = (-(-M // rpb), 3 * C)
    plan["part_hidden"] = (-(-M // MLP_TILES[plan["hidden"]][0]), hidden)
    return plan


def mlp_weight_rows(w: torch.Tensor, width: int) -> torch.Tensor:
    """A bf16 (R, K) weight in K5's (out, in) layout (any strides) as the
    (R, width) rows its staged products read, contiguous, columns K ..
    width zero: itself, no copy, when it is contiguous and K == width.  A
    float32 weight is split into its bf16 terms on the card instead
    (csrc/fused_common.cuh ``split_weights_kernel``)."""
    if w.dtype != torch.bfloat16:
        raise ValueError(f"mlp_weight_rows takes a bf16 weight, got {w.dtype}")
    K = w.shape[1]
    return (w if K == width else F.pad(w, (0, width - K))).contiguous()


def _mlp_weights(w1, w2, C: int, hidden: int, width: int, single: bool,
                 dev) -> tuple:
    """K5's weights as its C entries take them, from the JAX-layout (in,
    out) ones: ((W1 (hidden, C) view, its strides), (W2 (C, hidden) view,
    its strides)).  bf16: padded contiguous rows (``mlp_weight_rows``; no
    copy for the transposed view of an nn.Linear weight whose rows need no
    padding).  float32: the views as they are, which the card splits into
    terms, or, for the single-block form, contiguous."""
    _check_weight(w1, C, hidden, dev)
    _check_weight(w2, hidden, C, dev)
    w1t, w2t = w1.t(), w2.t()
    if w1.dtype == torch.bfloat16:
        w1t, w2t = mlp_weight_rows(w1t, width), mlp_weight_rows(w2t, hidden)
    elif single:
        w1t, w2t = w1t.contiguous(), w2t.contiguous()
    return (w1t, w1t.stride()), (w2t, w2t.stride())


def fused_mlp_half_fwd(x2, gamma, beta, w1, b1, w2, b2, dp,
                       tps: int) -> torch.Tensor:
    """K5 forward: (M, C) rows -> (M, C), see the module doc."""
    global MLP_LAUNCHES
    if not build.on_card(x2, "fused half-block"):
        return fused_mlp_half_reference(x2, gamma, beta, w1, b1, w2, b2, dp,
                                        tps)
    _check_x(x2, 2)
    M, C = x2.shape
    hidden = w1.shape[1]
    dev = x2.device
    code = _code(x2, (w1, w2))
    _check_dp(dp, -(-M // tps))
    plan = mlp_plan(M, C, hidden, _sms(dev), _TERMS[code])
    width, single = plan["width"], plan["single"]
    (w1t, s1), (w2t, s2) = _mlp_weights(w1, w2, C, hidden, width, single, dev)
    g, bt = _vec(gamma, C, dev, "gamma"), _vec(beta, C, dev, "beta")
    b1v, b2v = _vec(b1, hidden, dev, "b1"), _vec(b2, C, dev, "b2")
    dpv = _vec(dp, dp.numel(), dev, "dp")
    y = torch.empty_like(x2)
    # scratch of the three-stage form: bf16 lnb (M, width), g (M, hidden)
    # and, for float32 weights, their terms
    buf, ptrs = ((None, [None] * 3) if single else _scratch(
        dev, 2 * M * width, 2 * M * hidden,
        0 if code else 2 * 3 * hidden * (width + C)))
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.ipe_fused_mlp_fwd(
            x2.data_ptr(), g.data_ptr(), bt.data_ptr(), w1t.data_ptr(),
            b1v.data_ptr(), w2t.data_ptr(), b2v.data_ptr(), dpv.data_ptr(),
            y.data_ptr(), *ptrs, M, C, width, hidden, tps,
            plan["rows_per_block"], plan["fc1"], plan["fc2"], int(single),
            *s1, *s2, code, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "fused_mlp_fwd launch")
    MLP_LAUNCHES += 1
    return y


def fused_mlp_half_bwd(x2, gamma, beta, w1, b1, w2, b2, dp, dy, tps: int):
    """K5 backward: (dx, dgamma, dbeta, dw1, db1, dw2, db2), see the module
    doc.  Weight gradients are summed over row chunks and the chunks added
    in a fixed order, and so are the partial rows of the vectors: the result
    does not depend on how blocks are scheduled."""
    global MLP_BWD_LAUNCHES
    if not build.on_card(x2, "fused half-block"):
        return fused_mlp_half_bwd_reference(x2, gamma, beta, w1, b1, w2, b2,
                                            dp, dy, tps)
    _check_x(x2, 2)
    _check_dy(dy, x2)
    M, C = x2.shape
    hidden = w1.shape[1]
    dev = x2.device
    code = _code(x2, (w1, w2))
    _check_dp(dp, -(-M // tps))
    plan = mlp_plan(M, C, hidden, _sms(dev), _TERMS[code])
    width = plan["width"]
    (w1t, st1), (w2t, st2) = _mlp_weights(w1, w2, C, hidden, width, False,
                                          dev)
    g, bt = _vec(gamma, C, dev, "gamma"), _vec(beta, C, dev, "beta")
    b1v = _vec(b1, hidden, dev, "b1")
    dpv = _vec(dp, dp.numel(), dev, "dp")
    s1, s2 = plan["atb_splits"]
    # scratch: bf16 lnb, dob (M, width) and gb, dhb (M, hidden); float32 dln
    # (M, C), stats (2, M), the partial rows and the dW chunk partials; for
    # float32 weights, their bf16 terms
    buf, ptrs = _scratch(
        dev, 2 * M * width, 2 * M * width, 2 * M * hidden, 2 * M * hidden,
        4 * M * C, 8 * M, 4 * math.prod(plan["part_rows"]),
        4 * math.prod(plan["part_hidden"]), 4 * max(s1, s2) * hidden * C,
        0 if code else 2 * 3 * hidden * (width + C))
    dx = torch.empty_like(x2)
    # float32 outputs: [dgamma | dbeta | db2 | db1], dW1 (hidden, C), dW2
    # (C, hidden)
    out = torch.empty((3 * C + hidden + 2 * hidden * C,), dtype=torch.float32,
                      device=dev)
    nvec = 3 * C + hidden
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.ipe_fused_mlp_bwd(
            x2.data_ptr(), g.data_ptr(), bt.data_ptr(), w1t.data_ptr(),
            b1v.data_ptr(), w2t.data_ptr(), dpv.data_ptr(), dy.data_ptr(),
            dx.data_ptr(), out.data_ptr(), out.data_ptr() + 4 * nvec,
            out.data_ptr() + 4 * (nvec + hidden * C), *ptrs, M, C, width,
            hidden, tps, plan["rows_per_block"], plan["hidden"], plan["dln"],
            s1, s2, *st1, *st2, code, torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "fused_mlp_bwd launch")
    MLP_BWD_LAUNCHES += 1
    dgamma, dbeta, db2, db1, dw1t, dw2t = out.split(
        [C, C, C, hidden, hidden * C, hidden * C])
    return (dx, dgamma, dbeta, dw1t.view(hidden, C).t().to(w1.dtype), db1,
            dw2t.view(C, hidden).t().to(w2.dtype), db2)


def _check_attn(xw, rpe, num_heads, geom):
    _check_x(xw, 3)
    nW, N, C = xw.shape
    if C % num_heads:
        raise ValueError(f"C={C} does not split into {num_heads} heads")
    hd = C // num_heads
    if N > MAX_TOKENS or hd > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes N <= {MAX_TOKENS} and head_dim <= "
                         f"{MAX_HEAD_DIM}, got N={N}, head_dim={hd}")
    H, W, ws = geom
    nwin, _ = window_geometry(geom)
    if ws * ws != N or nW % nwin:
        raise ValueError(f"{nW} windows of {N} tokens do not tile an "
                         f"({H}, {W}) map in windows of {ws}")
    if (rpe.dtype != torch.float32 or not rpe.is_contiguous()
            or tuple(rpe.shape) != (num_heads, N, N)
            or rpe.device != xw.device):
        raise ValueError(f"rpe must be a contiguous float32 ({num_heads}, "
                         f"{N}, {N}) tensor on {xw.device}")
    return nW, N, C, hd, nwin


@functools.lru_cache(maxsize=256)
def attn_fwd_plan(nW: int, N: int, C: int, num_heads: int,
                  sm_count: int) -> dict:
    """What K4's forward launches take and its scratch needs
    (csrc/fused_attn.cu).  Cached: the wrapper calls it per launch.

    ``width``: C rounded up to 8, the row stride of the bf16 ln and o rows
    and of the weights' rows as the products read them (16-byte rows).
    ``wpb``: stage (b) runs one block per (chunk of ``wpb`` windows,
    head), chunked as the backward's stage (b) (``bwd_windows_per_block``:
    about four blocks per SM, a wave of 528 blocks on 132 SMs at every
    hrformer_base branch at b = 32 and 64).
    ``proj``: stage (c)'s tile id in ``MLP_TILES`` over the (nW N, C)
    output, K5's rule (``_mlp_tile``)."""
    if C % 2 or C > 640:
        raise ValueError(f"K4 takes an even C <= 640, got C={C}")
    M = nW * N
    if -(-M // MLP_TILES[0][0]) > 65535:
        raise ValueError(f"K4 takes at most {65535 * MLP_TILES[0][0]} rows, "
                         f"got {M}")
    wpb = bwd_windows_per_block(nW, num_heads, sm_count)
    return dict(width=-(-C // 8) * 8, wpb=wpb, proj=_mlp_tile(M, C, sm_count))


def fused_attn_half_fwd(xw, gamma, beta, wqkv, bqkv, rpe, wproj, bproj, dp,
                        num_heads: int, geom: Tuple[int, int, int]
                        ) -> torch.Tensor:
    """K4 forward: (nW, N, C) windows -> (nW, N, C), see the module doc."""
    global ATTN_LAUNCHES
    if not build.on_card(xw, "fused half-block"):
        return fused_attn_half_reference(xw, gamma, beta, wqkv, bqkv, rpe,
                                         wproj, bproj, dp, num_heads, geom)
    nW, N, C, hd, nwin = _check_attn(xw, rpe, num_heads, geom)
    dev = xw.device
    code = _code(xw, (wqkv, wproj))
    _check_dp(dp, nW // nwin)
    plan = attn_fwd_plan(nW, N, C, num_heads, _sms(dev))
    width = plan["width"]
    wq, wp = _out_in(wqkv, C, 3 * C, dev), _out_in(wproj, C, C, dev)
    g, bt = _vec(gamma, C, dev, "gamma"), _vec(beta, C, dev, "beta")
    bq, bp = _vec(bqkv, 3 * C, dev, "bqkv"), _vec(bproj, C, dev, "bproj")
    dpv = _vec(dp, dp.numel(), dev, "dp")
    y = torch.empty_like(xw)
    M = nW * N
    # scratch: bf16 ln and o rows (M, width), the weights' bf16 rows (terms)
    buf, ptrs = _scratch(dev, 2 * M * width, 2 * M * width,
                         2 * _TERMS[code] * 4 * C * width)
    H, W, ws = geom
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.ipe_fused_attn_fwd(
            xw.data_ptr(), g.data_ptr(), bt.data_ptr(), wq.data_ptr(),
            bq.data_ptr(), rpe.data_ptr(), wp.data_ptr(), bp.data_ptr(),
            dpv.data_ptr(), y.data_ptr(), *ptrs, nW, N, C, num_heads, H, W,
            ws, width, plan["wpb"], plan["proj"], float(hd ** -0.5), code,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "fused_attn_fwd launch")
    ATTN_LAUNCHES += 1
    return y


def attn_bwd_plan(nW: int, N: int, C: int, num_heads: int,
                  sm_count: int) -> dict:
    """Chunks and scratch of K4's backward (csrc/fused_attn.cu, which
    launches its own grids): stage (b) runs one block per (chunk of ``wpb``
    windows, head) as K2's (``bwd_windows_per_block``); float32 partial
    rows: ``rows_part`` per window [dgamma | dbeta |
    dbproj], ``chunk_part`` per chunk [dbqkv | drpe]; ``stats`` each row's
    LayerNorm mean and rstd."""
    wpb = bwd_windows_per_block(nW, num_heads, sm_count)
    chunks = -(-nW // wpb)
    return dict(wpb=wpb, chunks=chunks,
                rows_part=(nW, 3 * C),
                chunk_part=(chunks, 3 * C + num_heads * N * N),
                stats=(2, nW * N))


def fused_attn_half_bwd(xw, gamma, beta, wqkv, bqkv, rpe, wproj, bproj, dp,
                        dy, num_heads: int, geom: Tuple[int, int, int]):
    """K4 backward: (dx, dgamma, dbeta, dwqkv, dbqkv, drpe, dwproj, dbproj),
    see the module doc.  Every sum over windows is taken in a fixed order:
    the result does not depend on how blocks are scheduled."""
    global ATTN_BWD_LAUNCHES
    if not build.on_card(xw, "fused half-block"):
        return fused_attn_half_bwd_reference(xw, gamma, beta, wqkv, bqkv, rpe,
                                             wproj, bproj, dp, dy, num_heads,
                                             geom)
    nW, N, C, hd, nwin = _check_attn(xw, rpe, num_heads, geom)
    _check_dy(dy, xw)
    dev = xw.device
    code = _code(xw, (wqkv, wproj))
    _check_dp(dp, nW // nwin)
    wq = _out_in(wqkv, C, 3 * C, dev)
    wq_io, wp_io = _in_out(wqkv, C, 3 * C, dev), _in_out(wproj, C, C, dev)
    g, bt = _vec(gamma, C, dev, "gamma"), _vec(beta, C, dev, "beta")
    bq = _vec(bqkv, 3 * C, dev, "bqkv")
    dpv = _vec(dp, dp.numel(), dev, "dp")
    M = nW * N
    sms = _sms(dev)
    plan = attn_bwd_plan(nW, N, C, num_heads, sms)
    s1 = atb_splits(3 * C, C, M, sms)
    s2 = atb_splits(C, C, M, sms)
    bf = dict(dtype=torch.bfloat16, device=dev)
    f32 = dict(dtype=torch.float32, device=dev)
    lnb, ob, dpob = (torch.empty((M, C), **bf) for _ in range(3))
    dqkvv = torch.empty((M, 3 * C), **bf)
    dln = torch.empty((M, C), **f32)
    stats = torch.empty(plan["stats"], **f32)
    rows_part = torch.empty(plan["rows_part"], **f32)
    chunk_part = torch.empty(plan["chunk_part"], **f32)
    atb_part = torch.empty((max(s1 * 3, s2) * C * C,), **f32)
    # float32 weights as three bf16 terms each, split once per call
    wterms = torch.empty((21 * C * C if code == 0 else 0,), **bf)
    dx = torch.empty_like(xw)
    vec = torch.empty((6 * C + num_heads * N * N,), **f32)
    dwqkvt = torch.empty((3 * C, C), **f32)
    dwprojt = torch.empty((C, C), **f32)
    H, W, ws = geom
    lib = build.load()
    with torch.cuda.device(dev):
        err = lib.ipe_fused_attn_bwd(
            xw.data_ptr(), g.data_ptr(), bt.data_ptr(), wq.data_ptr(),
            wq_io.data_ptr(), bq.data_ptr(), rpe.data_ptr(), wp_io.data_ptr(),
            dpv.data_ptr(), dy.data_ptr(), dx.data_ptr(), vec.data_ptr(),
            dwqkvt.data_ptr(), dwprojt.data_ptr(), lnb.data_ptr(),
            ob.data_ptr(), dpob.data_ptr(), dqkvv.data_ptr(), dln.data_ptr(),
            stats.data_ptr(), rows_part.data_ptr(), chunk_part.data_ptr(),
            atb_part.data_ptr(), wterms.data_ptr(), nW, N, C, num_heads, H, W,
            ws, float(hd ** -0.5), plan["wpb"], s1, s2, code,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "fused_attn_bwd launch")
    ATTN_BWD_LAUNCHES += 1
    dgamma, dbeta, dbproj, dbqkv, drpe = vec.split(
        [C, C, C, 3 * C, num_heads * N * N])
    return (dx, dgamma, dbeta, dwqkvt.t().to(wqkv.dtype), dbqkv,
            drpe.reshape(num_heads, N, N), dwprojt.t().to(wproj.dtype),
            dbproj)


# -- autograd ---------------------------------------------------------------------

class _FusedMlpHalf(torch.autograd.Function):
    """K5 forward, K5 backward; the backward recomputes from the inputs."""

    @staticmethod
    def forward(ctx, x2, gamma, beta, w1, b1, w2, b2, dp, tps: int):
        ctx.save_for_backward(x2, gamma, beta, w1, b1, w2, b2, dp)
        ctx.tps = tps
        return fused_mlp_half_fwd(x2, gamma, beta, w1, b1, w2, b2, dp, tps)

    @staticmethod
    def backward(ctx, dy):
        grads = fused_mlp_half_bwd(*ctx.saved_tensors, dy.contiguous(),
                                   ctx.tps)
        return (*grads, None, None)


class _FusedAttnHalf(torch.autograd.Function):
    """K4 forward, K4 backward; the backward recomputes from the inputs."""

    @staticmethod
    def forward(ctx, xw, gamma, beta, wqkv, bqkv, rpe, wproj, bproj, dp,
                num_heads: int, geom: Tuple[int, int, int]):
        ctx.save_for_backward(xw, gamma, beta, wqkv, bqkv, rpe, wproj, bproj,
                              dp)
        ctx.num_heads, ctx.geom = num_heads, geom
        return fused_attn_half_fwd(xw, gamma, beta, wqkv, bqkv, rpe, wproj,
                                   bproj, dp, num_heads, geom)

    @staticmethod
    def backward(ctx, dy):
        grads = fused_attn_half_bwd(*ctx.saved_tensors, dy.contiguous(),
                                    ctx.num_heads, ctx.geom)
        return (*grads, None, None, None)


def fused_mlp_half(x2, gamma, beta, w1, b1, w2, b2, dp,
                   tps: int) -> torch.Tensor:
    """Differentiable K5: the port of ``fused_mlp_half``."""
    return _FusedMlpHalf.apply(x2, gamma, beta, w1, b1, w2, b2, dp, tps)


def fused_attn_half(xw, gamma, beta, wqkv, bqkv, rpe, wproj, bproj, dp,
                    num_heads: int,
                    geom: Tuple[int, int, int]) -> torch.Tensor:
    """Differentiable K4: the port of ``fused_attn_half``; ``geom`` is the
    (H, W, ws) of the map the windows were cut from."""
    return _FusedAttnHalf.apply(xw, gamma, beta, wqkv, bqkv, rpe, wproj,
                                bproj, dp, num_heads, geom)
