"""K8: the phase ablation of the W-MSA forward.

Ports the kernels of the TPU probe
``infantposeestimation_gaussianbias_tpu/tools/probe_wmsa_ablate.py``
(``run_variant``'s pallas_call, :143-175).  ``window_attention_ablate``
runs one variant (``csrc/window_msa_ablate.cu``) on a bf16 (nW, N, 3C)
qkv tensor and returns (nW, N, C) bf16; on the CPU it takes the
variant's plain PyTorch version, ``ablate_reference``.  empty, gemmonly,
softonly and full are K1's own kernel (``csrc/window_msa_fwd.cuh``) with
phases compiled out, so their times split K1's.  The variants and their
maths, the probe's exactly:

  empty     out = q columns [:C] (q, k, v are staged and converted as K1
            stages them);
  gemmonly  s = (hd^-1/2 q) k^T, p = 0.01 s (no bias, no softmax), o = p v;
  softonly  s = the unscaled q[..., 0] broadcast over the N keys + bias[0]
            (the probe adds head 0's bias to every head), p = softmax(s),
            o = q * sum_j p;
  full      K1 itself (its instantiation of the same kernel): equal to
            ``window_msa.window_attention_qkv`` bit for bit;
  packslim  G = ``pack_factor(H, C, N)`` windows stacked into G*N rows:
            all (G*N)^2 scores + the packed bias, softmax, then PV, taken
            64 query rows at a time against key blocks of 64 with an online
            softmax (``packslim_emulation`` repeats that order).  It takes
            ``packed_bias(bias, G)`` (H, G*N, G*N), -1e30 off the diagonal
            blocks, which the caller builds once, as the probe's
            ``run_variant`` does.

``windows_per_block`` (1, 2, 4 or 8; packslim a multiple of G) is the
card's counterpart of the probe's ``GB``: how many windows one block
takes, staging one window (packslim: one group of G) at a time while the
one before it computes.  nW need not divide by it: the windows past nW
are zeros whose outputs are dropped, as the TPU pads nW to GB.
``packfull``, the probe's packed block-diagonal body, is K1's packed
body, which K1 computes as one kernel (the probe's ``main()`` never runs
it).
"""

from __future__ import annotations

import torch

from . import build
from .window_msa import MAX_HEAD_DIM, MAX_TOKENS, split_product

VARIANTS = ("empty", "gemmonly", "softonly", "full", "packslim")
WINDOWS_PER_BLOCK = (1, 2, 4, 8)
# Kernel launches since the last reset; one per launch, nowhere else.
ABLATE_LAUNCHES = 0

MAX_PACK = 8
# packslim's query rows a pass (4 warps x 16) and keys a block.
PACK_QUERY_ROWS = 64
PACK_KEY_BLOCK = 64


def pack_factor(num_heads: int, C: int, N: int) -> int:
    """The probe's G (``_pack_factor``, window_msa.py:193): windows per
    packed group, filling a 128-wide contraction without growing G*N past
    two 128-lane tiles."""
    hd = C // num_heads
    return max(1, min(128 // hd, 256 // N))


def packed_bias(bias: torch.Tensor, G: int) -> torch.Tensor:
    """(H, N, N) bias -> (H, G*N, G*N) float32: the bias on the G diagonal
    blocks, -1e30 elsewhere (``_packed_bias``, window_msa.py:184)."""
    H, N, _ = bias.shape
    mask = torch.block_diag(*[torch.ones(N, N, dtype=torch.bool,
                                         device=bias.device)] * G)
    tiled = bias.to(torch.float32).repeat(1, G, G)
    return torch.where(mask[None], tiled,
                       torch.tensor(-1e30, dtype=torch.float32,
                                    device=bias.device))


def fits(variant: str, N: int, hd: int, windows_per_block: int,
         pack: int = 1) -> bool:
    """Whether one block of the variant fits the current card's shared
    memory (the kernel's own reckoning, ``ipe_window_msa_ablate_fits``).
    Builds the kernels if needed."""
    return bool(build.load().ipe_window_msa_ablate_fits(
        VARIANTS.index(variant), N, hd, windows_per_block, pack))


def _split(qkv: torch.Tensor, num_heads: int):
    """float32 (nW, H, N, hd) q, k, v of the flat (nW, N, 3C) qkv."""
    nW, N, C3 = qkv.shape
    hd = C3 // 3 // num_heads
    x = qkv.float().reshape(nW, N, 3, num_heads, hd).permute(2, 0, 3, 1, 4)
    return x[0], x[1], x[2]


def _merge(o: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """(nW, H, N, hd) -> (nW, N, H*hd) in dtype."""
    nW, H, N, hd = o.shape
    return o.permute(0, 2, 1, 3).reshape(nW, N, H * hd).to(dtype)


def ablate_reference(variant: str, qkv: torch.Tensor, bias: torch.Tensor,
                     num_heads: int) -> torch.Tensor:
    """Plain PyTorch version of each variant (the probe's bodies), in
    float32, cast once to qkv's dtype; packslim's bias is the packed one."""
    nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    scale = hd ** -0.5
    if variant == "empty":
        return qkv[:, :, :C].clone()
    q, k, v = _split(qkv, num_heads)
    biasf = bias.float()
    if variant == "gemmonly":
        p = ((q * scale) @ k.transpose(-2, -1)) * 0.01
        return _merge(p @ v, qkv.dtype)
    if variant == "softonly":
        s = q[..., :1].expand(nW, num_heads, N, N) + biasf[0]
        p = torch.softmax(s, dim=-1)
        return _merge(q * p.sum(dim=-1, keepdim=True), qkv.dtype)
    if variant == "full":
        p = torch.softmax((q * scale) @ k.transpose(-2, -1) + biasf[None],
                          dim=-1)
        return _merge(p @ v, qkv.dtype)
    if variant == "packslim":
        G = pack_factor(num_heads, C, N)
        pad = -nW % G
        qs, ks, vs = (torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
                      .reshape(-1, G, num_heads, N, hd).transpose(1, 2)
                      .reshape(-1, num_heads, G * N, hd)
                      for x in (q * scale, k, v))
        p = torch.softmax(qs @ ks.transpose(-2, -1) + biasf[None], dim=-1)
        o = (p @ vs).reshape(-1, num_heads, G, N, hd).transpose(1, 2)
        return _merge(o.reshape(-1, num_heads, N, hd)[:nW], qkv.dtype)
    raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")


def packslim_emulation(qkv: torch.Tensor, pbias: torch.Tensor,
                       num_heads: int) -> torch.Tensor:
    """packslim as its kernel computes it, in plain PyTorch on the CPU: per
    (group of G windows, head), PACK_QUERY_ROWS query rows at a time
    against PACK_KEY_BLOCK keys at a time, S = scale q k^T + the packed
    bias, the online softmax (running row max m and sum l; O and l
    rescaled by exp(m_old - m_new) at each block), P v with P in two bf16
    terms, O / l cast once to bf16; windows past nW are zeros.  For the
    tests only: no model path runs it."""
    nW, N, C3 = qkv.shape
    C = C3 // 3
    hd = C // num_heads
    G = pack_factor(num_heads, C, N)
    GN = G * N
    scale = torch.tensor(hd ** -0.5, dtype=torch.float32)
    pad = -nW % G
    q, k, v = (torch.cat([x, x.new_zeros((pad,) + x.shape[1:])])
               .reshape(-1, G, num_heads, N, hd).transpose(1, 2)
               .reshape(-1, num_heads, GN, hd)
               for x in _split(qkv, num_heads))
    bias = pbias.float()
    out = torch.empty_like(q)
    for r0 in range(0, GN, PACK_QUERY_ROWS):
        rs = slice(r0, r0 + PACK_QUERY_ROWS)
        n = min(GN, r0 + PACK_QUERY_ROWS) - r0
        m = torch.full(q.shape[:2] + (n,), float("-inf"))
        l = torch.zeros_like(m)
        o = torch.zeros(q.shape[:2] + (n, hd))
        for kb in range(0, GN, PACK_KEY_BLOCK):
            ks = slice(kb, kb + PACK_KEY_BLOCK)
            s = scale * (q[:, :, rs] @ k[:, :, ks].transpose(-2, -1)) \
                + bias[:, rs, ks]
            mx = torch.maximum(m, s.amax(dim=-1))
            corr = torch.exp(m - mx)
            p = torch.exp(s - mx[..., None])
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + split_product(p, v[:, :, ks], 2, 1, 2)
            m = mx
        out[:, :, rs] = o / l[..., None]
    o = out.reshape(-1, num_heads, G, N, hd).transpose(1, 2)
    return _merge(o.reshape(-1, num_heads, N, hd)[:nW], qkv.dtype)


def _check(variant: str, qkv: torch.Tensor, bias: torch.Tensor,
           num_heads: int, windows_per_block: int) -> tuple:
    if variant not in VARIANTS:
        raise ValueError(f"unknown variant {variant!r}; known: {VARIANTS}")
    if qkv.dtype != torch.bfloat16:
        raise TypeError(f"the ablation takes bf16 qkv, got {qkv.dtype}")
    if qkv.dim() != 3 or not qkv.is_contiguous():
        raise ValueError(f"qkv must be a contiguous (nW, N, 3C) tensor, got "
                         f"shape {tuple(qkv.shape)}")
    nW, N, C3 = qkv.shape
    if C3 % 3 or (C3 // 3) % num_heads:
        raise ValueError(f"3C={C3} does not split into 3 x {num_heads} heads")
    C = C3 // 3
    hd = C // num_heads
    if N > MAX_TOKENS or hd > MAX_HEAD_DIM:
        raise ValueError(f"kernel takes N <= {MAX_TOKENS} and head_dim <= "
                         f"{MAX_HEAD_DIM}, got N={N}, head_dim={hd}")
    G = pack_factor(num_heads, C, N) if variant == "packslim" else 1
    if (bias.dtype != torch.float32 or not bias.is_contiguous()
            or tuple(bias.shape) != (num_heads, G * N, G * N)
            or bias.device != qkv.device):
        raise ValueError(
            f"{variant}'s bias must be a contiguous float32 ({num_heads}, "
            f"{G * N}, {G * N}) tensor on {qkv.device}, got {bias.dtype} "
            f"{tuple(bias.shape)} on {bias.device}")
    if variant == "packslim":
        if G > MAX_PACK or windows_per_block % G:
            raise ValueError(f"packslim takes a multiple of G={G} windows "
                             f"per block (G <= {MAX_PACK}), got "
                             f"{windows_per_block}")
    elif windows_per_block not in WINDOWS_PER_BLOCK:
        raise ValueError(f"windows_per_block must be one of "
                         f"{WINDOWS_PER_BLOCK}, got {windows_per_block}")
    if not fits(variant, N, hd, windows_per_block, G):
        raise ValueError(f"{variant} at {windows_per_block} windows per block "
                         f"does not fit a block's shared memory")
    return nW, N, C, hd, G


def window_attention_ablate(variant: str, qkv: torch.Tensor,
                            bias: torch.Tensor, num_heads: int,
                            windows_per_block: int = 1) -> torch.Tensor:
    """K8: one variant of the body on bf16 (nW, N, 3C) qkv and float32
    (H, N, N) bias (packslim: the packed bias) -> (nW, N, C) bf16, see the
    module doc."""
    global ABLATE_LAUNCHES
    if not build.on_card(qkv, "W-MSA ablation"):
        return ablate_reference(variant, qkv, bias, num_heads)
    nW, N, C, hd, G = _check(variant, qkv, bias, num_heads,
                             windows_per_block)
    out = torch.empty((nW, N, C), dtype=qkv.dtype, device=qkv.device)
    lib = build.load()
    with torch.cuda.device(qkv.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = lib.ipe_window_msa_ablate(
            VARIANTS.index(variant), qkv.data_ptr(), bias.data_ptr(),
            out.data_ptr(), nW, N, num_heads, hd, float(hd ** -0.5),
            windows_per_block, G, stream)
    build.check(lib, err, f"window_msa_ablate ({variant}) launch")
    ABLATE_LAUNCHES += 1
    return out
