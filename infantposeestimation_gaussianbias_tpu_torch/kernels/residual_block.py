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

With bf16 weights each conv is one launch of a halo-staged tensor-core
kernel whose grid ``chain_plan`` picks (pixel tiles of whole rows or whole
images, slabs of output channels); ``fused_residual_chain_emulation``
repeats its indexing in plain PyTorch for the CPU tests.
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import torch
import torch.nn.functional as F

from . import build

# Kernel launches since the last reset: one per chain (its 2n conv
# launches count together), nowhere else.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

# The bf16 kernel (csrc/residual_block.cu ``conv_tc_kernel``): the most
# pixels a tile holds for each output-channel slab width TCO (its 4 warps'
# m16 slabs, ``Tc<TCO>::BM``), the weight rows of a staged k slice, the
# ring's slices, the most input-channel parts, and the shared memory a
# block may opt in to (bytes).
TILE_PIXELS = {16: 256, 32: 256, 48: 192, 64: 128, 96: 96, 128: 64}
K_SLICE = 64
RING_STAGES = 4
MAX_PARTS = 8
MAX_SMEM = 232448
# The weight slab is staged whole (no ring) for TCO <= 64 when the block's
# shared memory stays within half an SM's, so that two blocks fit.
WHOLE_SMEM = MAX_SMEM // 2
# The plan's cost model: a guess at the rates that mma.sync products and
# the L2's reads of staged tiles and weights reach on the H100 (FLOP/s,
# bytes/s).  It only ranks tilings; no bound or check uses it.
_MMA_RATE = 400e12
_L2_RATE = 5e12


def _pad16(n: int) -> int:
    return -(-n // 16) * 16


def chain_smem(W: int, C: int, rows: int, slots: int, tco: int,
               whole: bool, parts: int = 1) -> int:
    """Shared memory of one block of the bf16 kernel (bytes,
    ``tc_smem``): the staged input tile, ``slots`` x (rows + 2) x (W + 2)
    pixels of its part's Cq = pad16(C) / parts channels + 8 (the row
    stride), and the weights, the part's whole tap-padded (9 Cq, tco) slab
    or a ring of RING_STAGES slices of K_SLICE rows, rows of tco + 8."""
    cq = _pad16(C) // parts
    slices = -(-9 * cq // K_SLICE) if whole else RING_STAGES
    return 2 * (slots * (rows + 2) * (W + 2) * (cq + 8)
                + slices * K_SLICE * (tco + 8))


def _parts(C: int) -> list:
    """Input-channel splits the kernel takes: each part a multiple of 16
    channels of C rounded up to 16."""
    cp = _pad16(C)
    return [p for p in range(1, MAX_PARTS + 1) if cp % (16 * p) == 0]


def _slab_widths(C: int) -> tuple:
    """TCO candidates: C rounded up to a compiled width up to 128, else
    64 or 128."""
    if C > 128:
        return (64, 128)
    return (min(t for t in TILE_PIXELS if t >= C),)


@functools.lru_cache(maxsize=256)
def chain_plan(B: int, H: int, W: int, C: int, sm_count: int = 132) -> dict:
    """The bf16 kernel's grid for (B, H, W, C) maps on ``sm_count`` SMs.

    A pixel tile is ``rows`` whole rows of one image (a band; an image has
    ``ceil(H / rows)`` of them, the last shorter where rows does not divide
    H) or, with ``rows == H``, ``slots`` whole images (the last tile may
    hold fewer); it holds at most ``TILE_PIXELS[tco]`` pixels.  ``tco``
    output channels a slab: C rounded up to a compiled width up to 128 (no
    slab wider than C needs: 32 at C = 32), 64 or 128 above.  ``parts``:
    the input channels cut into that many ranges, one block each, whose
    float32 sums the tile's last block adds (more blocks for a tile, so
    that large tiles still fill the card).  One block per (tile, slab,
    part): ``blocks`` = ``tiles`` x ceil(C / tco) x ``parts``.  ``whole``:
    each block's weight slab (9 C / parts rows) staged whole (tco <= 64 and
    within WHOLE_SMEM); ``smem`` the block's bytes.

    Of the tilings that launch at least one block per SM (a full wave),
    the plan takes the one the cost model ranks first: products of the
    tiles' m16 slabs (rows past a tile's pixels are zeros multiplied), L2
    reads of staged tiles and weight slabs (a slab per tile, so small tiles
    of wide maps stream the weights many times), and the parts' sums
    written and read back.  Where none does it takes the finest tiling
    (most blocks; ``fills_wave`` False): a tile is at least one row, a slab
    C wide up to 128 (64 above) and a part at least 16 channels (at most
    MAX_PARTS parts), so one image launches at most H ceil(C / tco) parts
    blocks.  At hrnet_w32's and hrnet_w48's branches every b >= 2 fills a
    wave; at b = 1 hrnet_w32's b0, b1 and b2 cannot: 64 rows x 2 parts, 32
    x 4 and 16 x 8 make 128 blocks each.  Cached: the wrapper calls it per
    launch; callers do not change it."""
    Cp = _pad16(C)
    best = None
    for tco in _slab_widths(C):
        cap = TILE_PIXELS[tco]
        slabs_c = -(-C // tco)
        tilings = [(r, 1) for r in range(1, H) if r * W <= cap]
        tilings += [(H, k) for k in range(1, B + 1) if k * H * W <= cap]
        for rows, slots in tilings:
            if rows < H:
                nb = -(-H // rows)
                last = H - (nb - 1) * rows
                tiles = B * nb
                tile_px = [rows * W] * (nb - 1) + [last * W]
                slabs = B * sum(-(-p // 16) for p in tile_px)
                cells = B * sum((r + 2) * (W + 2)
                                for r in [rows] * (nb - 1) + [last])
            else:
                tiles = -(-B // slots)
                last = B - (tiles - 1) * slots
                slabs = ((tiles - 1) * -(-slots * H * W // 16)
                         + -(-last * H * W // 16))
                cells = B * (H + 2) * (W + 2)
            for parts in _parts(C):
                blocks = tiles * slabs_c * parts
                whole = (tco <= 64 and chain_smem(
                    W, C, rows, slots, tco, True, parts) <= WHOLE_SMEM)
                smem = chain_smem(W, C, rows, slots, tco, whole, parts)
                if smem > MAX_SMEM:
                    continue
                flops = 2 * slabs * 16 * slabs_c * tco * 9 * Cp
                nbytes = 2 * slabs_c * (cells * Cp + tiles * 9 * Cp * tco)
                if parts > 1:  # the parts' float32 sums, written and read
                    nbytes += 2 * 4 * parts * B * H * W * C
                cost = flops / _MMA_RATE + nbytes / _L2_RATE
                key = ((0, cost) if blocks >= sm_count
                       else (1, -blocks, cost))
                if best is None or key < best[0]:
                    best = (key, dict(rows=rows, slots=slots, tco=tco,
                                      parts=parts, whole=whole, smem=smem,
                                      tiles=tiles, blocks=blocks,
                                      fills_wave=blocks >= sm_count))
    if best is None:
        raise ValueError(f"no K7 tiling of ({B}, {H}, {W}, {C}) maps fits a "
                         f"block: a row of {W} pixels is more than "
                         f"{max(TILE_PIXELS[t] for t in _slab_widths(C))}")
    return best[1]


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


def _emulated_conv(src: torch.Tensor, w9: torch.Tensor, ab: torch.Tensor,
                   res, plan: dict) -> torch.Tensor:
    """One conv of the bf16 kernel as it indexes: src (B, H, W, C) float32
    (the staged operand's values), w9 (9C, C), ab (2, C), res None or (B,
    H, W, C) float32 -> (B, H, W, C) float32 before any rounding."""
    B, H, W, C = src.shape
    Cp = _pad16(C)
    rows, slots, tco = plan["rows"], plan["slots"], plan["tco"]
    parts = plan["parts"]
    cq = Cp // parts
    WP = W + 2
    # the tap-padded (9, Cp, C) weight, channels C.. of each tap zero
    wp = torch.zeros(9, Cp, C)
    wp[:, :C] = w9.float().reshape(9, C, C)
    nb = -(-H // rows)
    tiles = -(-B * nb // slots)
    out = torch.empty(B * H * W, C)
    flat_res = None if res is None else res.reshape(-1, C)
    a, b = ab[0].float(), ab[1].float()
    # the nine taps' cell shifts, (dh - 1) rows and (dw - 1) columns
    shifts = [(t // 3 - 1) * WP + t % 3 - 1 for t in range(9)]
    for t in range(tiles):
        band0 = t * slots
        img0, y0 = band0 // nb, (band0 % nb) * rows
        nslots = min(slots, B - img0)
        rows_here = min(rows, H - y0)
        P = (nslots - 1) * rows * W + rows_here * W
        # the staged tile: slot s, row i (image row y0 - 1 + i), column j
        # (image column j - 1); zero off the map and in channels C..
        stage = torch.zeros(slots * (rows + 2) * WP, Cp)
        for s in range(nslots):
            for i in range(rows_here + 2):
                y = y0 - 1 + i
                if 0 <= y < H:
                    c0 = (s * (rows + 2) + i) * WP + 1
                    stage[c0:c0 + W, :C] = src[img0 + s, y]
        p = torch.arange(P)
        sl, r = p // (rows * W), p % (rows * W)
        cell = (sl * (rows + 2) + r // W + 1) * WP + r % W + 1
        m0 = (img0 * H + y0) * W
        for co0 in range(0, C, tco):
            cs = slice(co0, min(C, co0 + tco))
            # each part: its channels of the nine taps (rows tap * cq + c
            # of its slab), the parts' sums added in part order
            acc = 0
            for q in range(parts):
                ch = slice(q * cq, (q + 1) * cq)
                A = torch.cat([stage[cell + sh, ch] for sh in shifts], dim=1)
                acc = acc + A @ wp[:, ch, cs].reshape(9 * cq, -1)
            v = acc * a[cs] + b[cs]
            if flat_res is not None:
                v = v + flat_res[m0:m0 + P, cs]
            out[m0:m0 + P, cs] = torch.relu(v)
    return out.reshape(B, H, W, C)


def fused_residual_chain_emulation(x: torch.Tensor, weights: torch.Tensor,
                                   affines: torch.Tensor, num_blocks: int,
                                   plan: dict) -> torch.Tensor:
    """K7's bf16 route as its kernel indexes it, in plain PyTorch on the
    CPU: per launch the tiles of ``plan`` (``chain_plan``'s keys rows,
    slots, tco and parts), each staged with its halo into a zero-filled
    cell array, the nine taps read at their cell shifts, the tap-padded
    weight per slab of tco channels and part of the input channels, the
    parts' sums added in part order, the epilogue's order; the operand of
    each first conv is the previous second conv's float32 output rounded
    to the weights' dtype once.  Equal to ``fused_residual_chain_reference``
    up to the order of float32 sums.  For the tests only: no model path
    runs it."""
    wdt = weights.dtype
    xf = x.float()
    for blk in range(num_blocks):
        y = _emulated_conv(xf.to(wdt).float(), weights[2 * blk],
                           affines[2 * blk], None, plan)
        xf = _emulated_conv(y.to(wdt).float(), weights[2 * blk + 1],
                            affines[2 * blk + 1], xf, plan)
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


@functools.lru_cache(maxsize=None)
def _sm_count(index) -> int:
    """SMs of CUDA device ``index`` (the current one if None)."""
    return torch.cuda.get_device_properties(
        torch.cuda.current_device() if index is None else index
    ).multi_processor_count


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
    dev = x.device
    out = torch.empty_like(x)
    carry = torch.empty((B, H, W, C), dtype=torch.float32, device=dev)
    y = torch.empty((B, H, W, C), dtype=weights.dtype, device=dev)
    xw = partial = counters = None
    tiling = (0, 0, 0, 0, 1)
    if weights.dtype == torch.bfloat16:
        plan = chain_plan(B, H, W, C, _sm_count(dev.index))
        xw = torch.empty((B, H, W, C), dtype=torch.bfloat16, device=dev)
        tiling = (plan["rows"], plan["slots"], plan["tco"],
                  int(plan["whole"]), plan["parts"])
        if plan["parts"] > 1:
            partial = torch.empty((plan["parts"], B, H, W, C),
                                  dtype=torch.float32, device=dev)
            counters = torch.zeros(plan["blocks"] // plan["parts"],
                                   dtype=torch.int32, device=dev)
    lib = build.load()

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        err = lib.ipe_residual_chain(
            x.data_ptr(), weights.data_ptr(), affines.data_ptr(),
            out.data_ptr(), carry.data_ptr(), ptr(xw), y.data_ptr(),
            ptr(partial), ptr(counters), B, H, W, C, num_blocks,
            _DTYPE_CODES[x.dtype], _DTYPE_CODES[weights.dtype], *tiling,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "residual_chain launch")
    LAUNCHES += 1
    return out
