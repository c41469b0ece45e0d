"""K1, K1-hm and K2: fused window multi-head self-attention.

K1, the forward, ports ``window_attention_pallas_qkv``
(infantposeestimation_gaussianbias_tpu/ops/pallas/window_msa.py:221-289);
K2, the backward, ports ``_qkv_vjp_bwd`` of
``window_attention_pallas_qkv_vjp`` (:399-480).  ``window_attention_qkv``
and ``window_attention_qkv_bwd`` run the CUDA kernels of
``csrc/window_msa.cu`` and ``csrc/window_msa_bwd.cu`` for tensors on the
card and the plain PyTorch versions ``*_reference`` for tensors on the
CPU; on any other device, or for a CUDA tensor the kernel does not take,
they raise.  ``window_attention`` joins the two in a
``torch.autograd.Function``: K1 forward, K2 backward.  K1's and K2's
attention maths is the tensor-core core of ``csrc/wmsa_core.cuh``, which
K4's forward and backward share, on operands staged per (chunk of
windows, head) by ``csrc/wmsa_stage.cuh``; ``fwd_plan`` and
``bwd_windows_per_block`` size their chunks.
``attention_fwd_core_emulation`` and ``attention_bwd_core_emulation``
repeat the core's split-bf16 products in plain PyTorch, and
``window_attention_qkv_emulation`` and ``window_attention_hm_emulation``
K1's and K1-hm's walk over their grids, for the tests (no model path runs
them).

Contract, as ops/msa.py ``window_attention`` on the flat layout:
  qkv  (nW, N, 3C), columns [q heads | k heads | v heads], float32 or bf16;
  bias (num_heads, N, N) float32 (None only for the forward);
  out  (nW, N, C) in qkv's dtype; dout likewise;
  dqkv (nW, N, 3C) in qkv's dtype, dbias (num_heads, N, N) float32;
  maths in float32.

K1-hm, ``window_attention_hm``, ports ``window_attention_pallas_hm``
(window_msa.py:50-91): K1's kernel with head-major staging, q, k, v (H,
nW, N, hd) read in place, out (H, nW, N, hd) in v's dtype; bias None is
zeros.  It equals K1 bit for bit on the same q, k, v.
``window_attention_wm`` ports the window-major wrapper
``window_attention_pallas`` (:94-106): relayouts to
head-major, K1-hm, and a transpose back, as the JAX wrapper does.  The
TPU tiling knob ``block_windows`` has no counterpart.  No model path
runs K1-hm.

K3, ``window_attention_sharded``, ports ``window_attention_pallas_qkv_sharded``
(window_msa.py:483-559): W-MSA over a process grid (parallel/mesh.py), as
an autograd Function around K1 and K2.  Each rank passes its own windows,
(nW_local, N, 3C) with all heads (the qkv Linear is replicated).  When the
model axis divides the heads (``head_range``) model rank j computes heads
[j H/m, (j+1) H/m): K1 and K2 take a head range (``heads=(h0, Hl)``), read
those heads of qkv and dout in place and write their columns of
zero-filled full-width outputs, which an all-reduce over the model group
assembles; dbias, those heads' tiles of a zero-filled (H, N, N), is
all-reduced over the world group (a sum over 'data' and an assembly over
'model').  Otherwise the model axis replicates: K1 and K2 run every head
and dbias is all-reduced over the data group only.  The JAX version pads
nW to a multiple of 'data'; here each rank passes the windows of its own
batch rows, so nothing pads.  On CPU tensors the same function runs over the
plain versions and gloo; the collectives are ``all_reduce`` only (gloo's
CUDA path has all_reduce and broadcast).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from ..ops import msa
from . import build

# Kernel launches since the last reset, K1 and K2; one per launch, nowhere
# else (K2's launch counts its dbias reduction pass with it).  A launch over
# a head range (K3's head-parallel K1 and K2) counts in LAUNCHES and
# BWD_LAUNCHES and again in SHARDED_LAUNCHES and SHARDED_BWD_LAUNCHES; K3
# with a replicated model axis launches whole-head K1/K2, counted there only.
LAUNCHES = 0
BWD_LAUNCHES = 0
HM_LAUNCHES = 0
SHARDED_LAUNCHES = 0
SHARDED_BWD_LAUNCHES = 0

MAX_TOKENS = 64
MAX_HEAD_DIM = 64
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# K2 blocks per SM that the windows-per-block choice aims at: a few blocks
# in flight per SM, and a dbias scratch of that many N x N partials.
_BWD_BLOCKS_PER_SM = 4


Heads = Optional[Tuple[int, int]]  # (h0, Hl): heads [h0, h0 + Hl), or all


def _head_columns(qkv: torch.Tensor, num_heads: int, heads: Tuple[int, int]
                  ) -> list:
    """The q, k and v column slices of heads [h0, h0 + Hl) of qkv."""
    h0, hl = heads
    C = qkv.shape[-1] // 3
    hd = C // num_heads
    return [slice(t * C + h0 * hd, t * C + (h0 + hl) * hd) for t in range(3)]


def window_attention_qkv_reference(qkv: torch.Tensor,
                                   bias: Optional[torch.Tensor],
                                   num_heads: int,
                                   heads: Heads = None) -> torch.Tensor:
    """Plain PyTorch version of K1 (the einsum path of ops/msa.py fed from
    the flat qkv tensor).  ``heads=(h0, Hl)``: those heads' columns of a
    zero-filled output, as K1's head range."""
    if heads is not None:
        h0, hl = heads
        cols = _head_columns(qkv, num_heads, heads)
        hd = qkv.shape[-1] // 3 // num_heads
        out = qkv.new_zeros(qkv.shape[:2] + (qkv.shape[-1] // 3,))
        out[..., h0 * hd:(h0 + hl) * hd] = window_attention_qkv_reference(
            torch.cat([qkv[..., c] for c in cols], -1),
            None if bias is None else bias[h0:h0 + hl], hl)
        return out
    nW, N, C3 = qkv.shape
    split = qkv.reshape(nW, N, 3, num_heads, C3 // 3 // num_heads)
    split = split.permute(2, 0, 3, 1, 4)
    out = msa.window_attention(split[0], split[1], split[2], bias)
    return out.permute(0, 2, 1, 3).reshape(nW, N, C3 // 3)


def window_attention_qkv_bwd_reference(qkv: torch.Tensor, bias: torch.Tensor,
                                       dout: torch.Tensor, num_heads: int,
                                       heads: Heads = None
                                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of K2, the maths of the TPU kernel
    (``_attn_qkv_bwd_kernel``): recompute P, then dV, dP, dS, dQ, dK and
    dbias, in float32 (float64 for float64 inputs).  ``heads=(h0, Hl)``:
    those heads' columns of a zero-filled dqkv and tiles of a zero-filled
    dbias, as K2's head range."""
    if heads is not None:
        h0, hl = heads
        cols = _head_columns(qkv, num_heads, heads)
        dq, db = window_attention_qkv_bwd_reference(
            torch.cat([qkv[..., c] for c in cols], -1), bias[h0:h0 + hl],
            dout[..., cols[0]], hl)
        dqkv, dbias = torch.zeros_like(qkv), torch.zeros_like(bias)
        for c, part in zip(cols, dq.chunk(3, dim=-1)):
            dqkv[..., c] = part
        dbias[h0:h0 + hl] = db
        return dqkv, dbias
    nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    acc = torch.promote_types(qkv.dtype, torch.float32)
    scale = hd ** -0.5
    split = qkv.to(acc).reshape(nW, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    q, k, v = split[0], split[1], split[2]
    do = dout.to(acc).reshape(nW, N, num_heads, hd).permute(0, 2, 1, 3)
    s = scale * (q @ k.transpose(-2, -1)) + bias.to(acc)[None]
    p = torch.softmax(s, dim=-1)
    dv = p.transpose(-2, -1) @ do
    dp = do @ v.transpose(-2, -1)
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = scale * (ds @ k)
    dk = scale * (ds.transpose(-2, -1) @ q)
    dqkv = torch.stack([dq, dk, dv]).permute(1, 3, 0, 2, 4).reshape(nW, N, C3)
    return dqkv.to(qkv.dtype), ds.sum(dim=0).to(bias.dtype)


# -- the tensor-core attention core (csrc/wmsa_core.cuh) ----------------------

# The core's tile unit: tokens and the head dim are padded to multiples of it.
CORE_TILE = 16
# bf16 terms of the core's operands: K2's q, k, v, dO by dtype (exact in one
# term in bf16); K4's float32 q, k, v (forward and backward) and do_h; P
# and dS.
K2_CORE_TERMS = {torch.bfloat16: 1, torch.float32: 3}
K4_CORE_TERMS = 2
PS_TERMS = 2
# K1's and K1-hm's q, k, v by dtype: two terms of a float32 hold F32_ATOL
# (one does not; a third changes next to nothing, since P and v keep two:
# tests/test_torch_k1_core.py).
K1_CORE_TERMS = {torch.bfloat16: 1, torch.float32: 2}


def core_padding(N: int, hd: int) -> Tuple[int, int]:
    """(tokens, head dim) of the core's padded tiles: 49, 39 -> 64, 48."""
    pad = lambda n: -(-n // CORE_TILE) * CORE_TILE  # noqa: E731
    return pad(N), pad(hd)


def split_terms(x: torch.Tensor, n: int) -> list:
    """x as n bf16 terms (float32 tensors of bf16 values), each the bf16
    rounding of what the terms before it left: x = sum + O(2^-8n |x|)."""
    terms, rest = [], x.float()
    for _ in range(n):
        t = rest.to(torch.bfloat16).float()
        terms.append(t)
        rest = rest - t
    return terms


def split_product(a: torch.Tensor, b: torch.Tensor, na: int, nb: int,
                  pairs: int) -> torch.Tensor:
    """a @ b as the core computes it: a in na bf16 terms, b in nb, the
    products of the term pairs (i, j) with i + j < pairs, each exact in
    float32, summed in float32."""
    ta, tb = split_terms(a, na), split_terms(b, nb)
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for i in range(na):
        for j in range(nb):
            if i + j < pairs:
                out = out + ta[i] @ tb[j]
    return out


def _pad_core(t: torch.Tensor) -> torch.Tensor:
    """(..., N, hd) -> the core's zero-padded float32 tile."""
    N, hd = t.shape[-2:]
    Np, hdp = core_padding(N, hd)
    return torch.nn.functional.pad(t.float(), (0, hdp - hd, 0, Np - N))


def _core_probs(qp: torch.Tensor, kp: torch.Tensor, bias: torch.Tensor,
                N: int, hd: int, terms: int) -> torch.Tensor:
    """P of the padded tiles as the core forms it: S = scale q k^T over
    ``terms`` bf16 terms (pairs i + j < terms) + bias, the softmax with the
    padding masked out (a padded row all zero)."""
    Np = qp.shape[-2]
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    s = scale * split_product(qp, kp.transpose(-2, -1), terms, terms, terms)
    s[..., :N, :N] += bias.float()
    valid = torch.zeros(Np, Np, dtype=torch.bool)
    valid[:N, :N] = True
    p = torch.softmax(s.masked_fill(~valid, float("-inf")), dim=-1)
    return torch.nan_to_num(p, nan=0.0)  # padded rows: every entry masked


def attention_fwd_core_emulation(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, bias: torch.Tensor,
                                 terms: int) -> torch.Tensor:
    """The forward core's arithmetic (csrc/wmsa_core.cuh
    ``attention_fwd``) in plain PyTorch, on the CPU: (..., N, hd) float32
    q, k, v (per head), bias (H, N, N) float32; q, k, v in ``terms`` bf16
    terms (S keeps the pairs i + j < terms), P in ``PS_TERMS`` and O = P v
    keeping the pairs i + j < PS_TERMS, tiles padded as ``core_padding``
    pads them.  Returns O (float32, before any rounding of the caller's).
    For the tests only: no model path runs it."""
    N, hd = q.shape[-2:]
    p = _core_probs(_pad_core(q), _pad_core(k), bias, N, hd, terms)
    o = split_product(p, _pad_core(v), PS_TERMS, terms, PS_TERMS)
    return o[..., :N, :hd]


def attention_bwd_core_emulation(q: torch.Tensor, k: torch.Tensor,
                                 v: torch.Tensor, do: torch.Tensor,
                                 bias: torch.Tensor, terms: int,
                                 with_o: bool = False) -> tuple:
    """The backward core's arithmetic in plain PyTorch, on the CPU:
    (..., N, hd) float32 q, k, v, do (per head), bias (H, N, N) float32,
    q, k, v, do in ``terms`` bf16 terms (S and dP keep the term pairs i +
    j < terms), P and dS in ``PS_TERMS`` (their products keep i + j <
    PS_TERMS), tiles padded as ``core_padding`` pads them with the padding
    masked out of the softmax.  Returns (dq, dk, dv, dbias = sum of dS over
    the leading dimension, o or None; o as the forward core's).  For the
    tests only: no model path runs it."""
    N, hd = q.shape[-2:]
    qp, kp, vp, dop = (_pad_core(t) for t in (q, k, v, do))
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    p = _core_probs(qp, kp, bias, N, hd, terms)
    dp = split_product(dop, vp.transpose(-2, -1), terms, terms, terms)
    ds = p * (dp - (p * dp).sum(dim=-1, keepdim=True))
    ps = (PS_TERMS, terms, PS_TERMS)
    dv = split_product(p.transpose(-2, -1), dop, *ps)
    dq = scale * split_product(ds, kp, *ps)
    dk = scale * split_product(ds.transpose(-2, -1), qp, *ps)
    o = split_product(p, vp, *ps) if with_o else None
    crop = (lambda t: t[..., :N, :hd])  # noqa: E731
    dbias = ds.reshape(-1, *ds.shape[-3:]).sum(dim=0)[..., :N, :N]
    return (crop(dq), crop(dk), crop(dv), dbias,
            None if o is None else crop(o))


def window_attention_qkv_emulation(qkv: torch.Tensor,
                                   bias: Optional[torch.Tensor],
                                   num_heads: int, wpb: int,
                                   heads: Heads = None) -> torch.Tensor:
    """K1 as its kernel computes it, in plain PyTorch on the CPU: block
    (chunk c, head h) takes windows [c wpb, (c + 1) wpb) of head h through
    the forward core's split-bf16 arithmetic
    (``attention_fwd_core_emulation``, q, k, v in K1_CORE_TERMS[dtype]
    terms; no bias is a zero tile) and writes the head's columns, cast once
    to qkv's dtype.  ``heads=(h0, Hl)``: those heads only, into a
    zero-filled output, as K1's head range.  For the tests only: no model
    path runs it."""
    nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    h0, hl = (0, num_heads) if heads is None else heads
    terms = K1_CORE_TERMS[qkv.dtype]
    out = torch.zeros(nW, N, C, dtype=qkv.dtype)
    for c0 in range(0, nW, wpb):
        rows = qkv[c0:c0 + wpb].float()
        for h in range(h0, h0 + hl):
            q, k, v = (rows[..., t * C + h * hd:t * C + (h + 1) * hd]
                       for t in range(3))
            o = attention_fwd_core_emulation(
                q, k, v, torch.zeros(N, N) if bias is None else bias[h],
                terms)
            out[c0:c0 + wpb, :, h * hd:(h + 1) * hd] = o.to(qkv.dtype)
    return out


def window_attention_hm_emulation(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  bias: Optional[torch.Tensor],
                                  wpb: int) -> torch.Tensor:
    """K1-hm as its kernel computes it (``window_attention_qkv_emulation``
    on head-major (H, nW, N, hd) q, k, v; out likewise).  For the tests
    only: no model path runs it."""
    H, nW, N, hd = q.shape
    terms = K1_CORE_TERMS[q.dtype]
    out = torch.empty_like(v)
    for h in range(H):
        for c0 in range(0, nW, wpb):
            w = slice(c0, c0 + wpb)
            o = attention_fwd_core_emulation(
                q[h, w].float(), k[h, w].float(), v[h, w].float(),
                torch.zeros(N, N) if bias is None else bias[h], terms)
            out[h, w] = o.to(v.dtype)
    return out


def _check(qkv: torch.Tensor, bias: Optional[torch.Tensor], num_heads: int,
           heads: Heads = None) -> tuple[int, int, int, int, int, int]:
    """(nW, N, hd, dtype code, h0, Hl) of a valid K1/K2 call; raises
    otherwise."""
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
    h0, hl = (0, num_heads) if heads is None else heads
    if h0 < 0 or hl <= 0 or h0 + hl > num_heads:
        raise ValueError(f"head range {heads} is not within {num_heads} "
                         f"heads")
    return nW, N, hd, _DTYPE_CODES[qkv.dtype], h0, hl


def _fwd_wpb(nW: int, N: int, hd: int, heads: int, x: torch.Tensor) -> int:
    """K1's windows per block for ``heads`` heads on x's card."""
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    return fwd_plan(nW, N, hd, heads, x.dtype, sms)["wpb"]


def window_attention_qkv(qkv: torch.Tensor, bias: Optional[torch.Tensor],
                         num_heads: int, heads: Heads = None) -> torch.Tensor:
    """K1, fused W-MSA: (nW, N, 3C) qkv -> (nW, N, C), see the module doc.
    ``heads=(h0, Hl)``: only those heads, into their columns of a
    zero-filled output."""
    global LAUNCHES, SHARDED_LAUNCHES
    if not build.on_card(qkv, "W-MSA"):
        return window_attention_qkv_reference(qkv, bias, num_heads, heads)
    nW, N, hd, code, h0, hl = _check(qkv, bias, num_heads, heads)
    shape = (nW, N, num_heads * hd)
    out = (torch.empty(shape, dtype=qkv.dtype, device=qkv.device)
           if heads is None else
           torch.zeros(shape, dtype=qkv.dtype, device=qkv.device))
    wpb = _fwd_wpb(nW, N, hd, hl, qkv)
    lib = build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ipe_window_msa_fwd(
            qkv.data_ptr(), None if bias is None else bias.data_ptr(),
            out.data_ptr(), nW, N, num_heads, h0, hl, hd, float(hd ** -0.5),
            wpb, code, stream)
    build.check(lib, err, "window_msa_fwd launch")
    LAUNCHES += 1
    SHARDED_LAUNCHES += heads is not None
    return out


def window_attention_hm_reference(q: torch.Tensor, k: torch.Tensor,
                                  v: torch.Tensor,
                                  bias: Optional[torch.Tensor]
                                  ) -> torch.Tensor:
    """Plain PyTorch version of K1-hm, the maths of ``_attn_kernel``: q
    scaled before the product, float32 throughout (float64 for float64
    inputs), one cast to v's dtype."""
    acc = torch.promote_types(v.dtype, torch.float32)
    s = (q.to(acc) * q.shape[-1] ** -0.5) @ k.to(acc).transpose(-2, -1)
    if bias is not None:
        s = s + bias.to(acc)[:, None]
    return (torch.softmax(s, dim=-1) @ v.to(acc)).to(v.dtype)


def _check_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              bias: Optional[torch.Tensor]) -> tuple[int, int, int, int]:
    if q.dtype not in _DTYPE_CODES:
        raise TypeError(f"q, k, v must be float32 or bfloat16, got {q.dtype}")
    for name, t in (("k", k), ("v", v)):
        if (t.dtype != q.dtype or t.shape != q.shape
                or t.device != q.device):
            raise ValueError(
                f"{name} must match q ({q.dtype} {tuple(q.shape)} on "
                f"{q.device}), got {t.dtype} {tuple(t.shape)} on {t.device}")
    if q.dim() != 4 or not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError(f"q, k, v must be contiguous (H, nW, N, hd) tensors, "
                         f"got shape {tuple(q.shape)}")
    H, nW, N, hd = q.shape
    if N > MAX_TOKENS or hd > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes N <= {MAX_TOKENS} and head_dim <= "
                         f"{MAX_HEAD_DIM}, got N={N}, head_dim={hd}")
    if bias is not None and (
            bias.dtype != torch.float32 or not bias.is_contiguous()
            or tuple(bias.shape) != (H, N, N) or bias.device != q.device):
        raise ValueError(
            f"bias must be a contiguous float32 ({H}, {N}, {N}) tensor on "
            f"{q.device}, got {bias.dtype} {tuple(bias.shape)} on "
            f"{bias.device}")
    return H, nW, N, hd


def window_attention_hm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """K1-hm: head-major (H, nW, N, hd) q, k, v -> (H, nW, N, hd), see the
    module doc."""
    global HM_LAUNCHES
    if not build.on_card(q, "W-MSA"):
        return window_attention_hm_reference(q, k, v, bias)
    H, nW, N, hd = _check_hm(q, k, v, bias)
    out = torch.empty_like(v)
    wpb = _fwd_wpb(nW, N, hd, H, q)
    lib = build.load()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ipe_window_msa_hm_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            None if bias is None else bias.data_ptr(), out.data_ptr(), nW, N,
            H, hd, float(hd ** -0.5), wpb, _DTYPE_CODES[q.dtype], stream)
    build.check(lib, err, "window_msa_hm_fwd launch")
    HM_LAUNCHES += 1
    return out


def window_attention_wm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        bias: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Window-major (nW, H, N, hd) q, k, v -> (nW, H, N, hd): relayout to
    head-major, K1-hm, and a transpose back (a view), as
    ``window_attention_pallas`` does."""
    qa, ka, va = (x.transpose(0, 1).contiguous() for x in (q, k, v))
    return window_attention_hm(qa, ka, va, bias).transpose(0, 1)


# Bytes of shared memory a block may opt in to on the H100 (csrc/
# ipe_common.cuh kMaxSmem), and the bytes of one SM that its resident
# blocks share (1 KB of each block's is the system's).
MAX_SMEM = 232448
SM_SMEM = 233472
# Blocks per SM that K1's registers are bounded for, by dtype
# (``__launch_bounds__`` in csrc/window_msa.cu).
_FWD_REG_BLOCKS = {torch.bfloat16: 4, torch.float32: 3}


def fwd_smem_bytes(N: int, hd: int, dtype: torch.dtype) -> int:
    """Shared memory of one K1 (or K1-hm) block, as csrc/window_msa.cu
    reckons it: the zero row, q, k and v as K1_CORE_TERMS bf16 term tiles
    of (N, pad16(hd) + 8), the staging of q, k and v rows as the 16-byte
    units a row of hd elements can touch, and the (N, N) float32 bias
    tile."""
    terms = K1_CORE_TERMS[dtype]
    ld = core_padding(N, hd)[1] + 8
    units = 1 + ((hd - 1) * torch.finfo(dtype).bits // 8 + 15) // 16
    return 2 * (72 + 3 * terms * N * ld) + 16 * 3 * N * units + 4 * N * N


def fwd_plan(nW: int, N: int, hd: int, num_heads: int, dtype: torch.dtype,
             sm_count: int) -> dict:
    """K1's grid for ``num_heads`` heads of nW windows: ``wpb`` windows per
    block as K2's (``bwd_windows_per_block``: about four blocks per SM),
    ``chunks`` of them per head, each block's ``smem`` and the
    ``blocks_per_sm`` that registers and shared memory allow."""
    wpb = bwd_windows_per_block(nW, num_heads, sm_count)
    smem = fwd_smem_bytes(N, hd, dtype)
    return dict(wpb=wpb, chunks=-(-nW // wpb), smem=smem,
                blocks_per_sm=min(_FWD_REG_BLOCKS[dtype],
                                  SM_SMEM // (smem + 1024)))


def bwd_windows_per_block(nW: int, num_heads: int, sm_count: int) -> int:
    """K2's windows per block: enough that the grid holds about
    ``_BWD_BLOCKS_PER_SM`` blocks per SM, which also bounds the dbias
    scratch to that many (N, N) partials."""
    target = _BWD_BLOCKS_PER_SM * sm_count
    return max(1, -(-nW * num_heads // target))


def window_attention_qkv_bwd(qkv: torch.Tensor, bias: torch.Tensor,
                             dout: torch.Tensor, num_heads: int,
                             heads: Heads = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K2, the W-MSA backward: (qkv, bias, dout) -> (dqkv, dbias), see the
    module doc.  ``heads=(h0, Hl)``: only those heads, into their columns
    of a zero-filled dqkv and their tiles of a zero-filled dbias."""
    global BWD_LAUNCHES, SHARDED_BWD_LAUNCHES
    if not build.on_card(qkv, "W-MSA"):
        return window_attention_qkv_bwd_reference(qkv, bias, dout, num_heads,
                                                  heads)
    if bias is None:
        raise ValueError("the W-MSA backward kernel needs the bias")
    nW, N, hd, code, h0, hl = _check(qkv, bias, num_heads, heads)
    C = num_heads * hd
    if (dout.dtype != qkv.dtype or tuple(dout.shape) != (nW, N, C)
            or not dout.is_contiguous() or dout.device != qkv.device):
        raise ValueError(
            f"dout must be a contiguous {qkv.dtype} ({nW}, {N}, {C}) tensor "
            f"on {qkv.device}, got {dout.dtype} {tuple(dout.shape)} on "
            f"{dout.device}")
    sms = torch.cuda.get_device_properties(qkv.device).multi_processor_count
    wpb = bwd_windows_per_block(nW, hl, sms)
    chunks = -(-nW // wpb)
    fill = torch.empty_like if heads is None else torch.zeros_like
    dqkv, dbias = fill(qkv), fill(bias)
    partial = torch.empty((chunks, hl, N, N), dtype=torch.float32,
                          device=qkv.device)
    lib = build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ipe_window_msa_bwd(
            qkv.data_ptr(), bias.data_ptr(), dout.data_ptr(), dqkv.data_ptr(),
            dbias.data_ptr(), partial.data_ptr(), nW, N, num_heads, h0, hl,
            hd, float(hd ** -0.5), wpb, code, stream)
    build.check(lib, err, "window_msa_bwd launch")
    BWD_LAUNCHES += 1
    SHARDED_BWD_LAUNCHES += heads is not None
    return dqkv, dbias


class _WindowAttention(torch.autograd.Function):
    """K1 forward, K2 backward; qkv is kept for the backward, which
    recomputes the attention probabilities from it."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, bias: torch.Tensor,
                num_heads: int) -> torch.Tensor:
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads = num_heads
        return window_attention_qkv(qkv, bias, num_heads)

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, bias = ctx.saved_tensors
        dqkv, dbias = window_attention_qkv_bwd(qkv, bias, dout.contiguous(),
                                               ctx.num_heads)
        return dqkv, dbias, None


def window_attention(qkv: torch.Tensor, bias: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Differentiable fused W-MSA (K1 forward, K2 backward): the port of
    ``window_attention_pallas_qkv_vjp``.  bias is required, as there."""
    if bias is None:
        raise ValueError("window_attention needs the relative position bias")
    return _WindowAttention.apply(qkv, bias, num_heads)


def head_range(num_heads: int, grid) -> Heads:
    """This rank's heads (h0, Hl) under K3: a contiguous 1/m of them when
    the grid's model axis m > 1 divides ``num_heads`` (head-parallel, the
    JAX ``head_parallel``), else None (the model axis replicates)."""
    m = grid.model
    if m > 1 and num_heads % m == 0:
        hl = num_heads // m
        return grid.model_index * hl, hl
    return None


class _ShardedWindowAttention(torch.autograd.Function):
    """K3: K1 forward and K2 backward on this rank's windows and heads, with
    the collectives of the module doc.  The all-reduced output is the same
    on every model rank, so the cotangent arriving here is too: K2 reads
    this rank's heads of it in place, and nothing reduces it."""

    @staticmethod
    def forward(ctx, qkv: torch.Tensor, bias: torch.Tensor, num_heads: int,
                grid) -> torch.Tensor:
        heads = head_range(num_heads, grid)
        ctx.save_for_backward(qkv, bias)
        ctx.num_heads, ctx.grid, ctx.heads = num_heads, grid, heads
        out = window_attention_qkv(qkv, bias, num_heads, heads)
        if heads is not None:
            dist.all_reduce(out, group=grid.model_group)
        return out

    @staticmethod
    def backward(ctx, dout: torch.Tensor):
        qkv, bias = ctx.saved_tensors
        grid, heads = ctx.grid, ctx.heads
        dqkv, dbias = window_attention_qkv_bwd(qkv, bias, dout.contiguous(),
                                               ctx.num_heads, heads)
        if heads is not None:
            dist.all_reduce(dqkv, group=grid.model_group)
            dist.all_reduce(dbias, group=grid.world_group)
        elif grid.data > 1:
            dist.all_reduce(dbias, group=grid.data_group)
        return dqkv, dbias, None, None


def window_attention_sharded(qkv: torch.Tensor, bias: torch.Tensor,
                             num_heads: int, grid) -> torch.Tensor:
    """K3, differentiable W-MSA over the process grid ``grid``
    (parallel.ProcessGrid): this rank's (nW_local, N, 3C) qkv -> its
    (nW_local, N, C) output, see the module doc.  bias (H, N, N) is
    required and its gradient comes back already summed over the grid's
    data ranks (the caller must not reduce it again)."""
    if bias is None:
        raise ValueError("window_attention_sharded needs the relative "
                         "position bias")
    return _ShardedWindowAttention.apply(qkv, bias, num_heads, grid)
