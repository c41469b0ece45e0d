"""K9 and K10: the int8 products of int8 PTQ serving (ops/quant.py).

Neither replaces a TPU kernel: the JAX package leaves both to XLA (its
ops/quant.py ``qconv``/``qconv_affine``, an int8 ``conv_general_dilated``
with int32 accumulation, and ``qdense``, an int8 ``dot_general``).  Stock
PyTorch has no CUDA int8 convolution, and ``torch._int_mm`` wants K and N
in multiples of 8, so both are hand-written for Hopper: ``csrc/qgemm.cu``
(K9) and ``csrc/qdense.cu`` (K10), on the int8 warpgroup product of
``csrc/qgemm_common.cuh``.  Each launch follows a plan computed here from
the shapes alone (``conv_plan``, ``dense_plan``; cached): the tile, the
warpgroups, the split of the depth (K9) or of N (K10) over blocks, the
shared memory.

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

import ctypes
import functools
import struct
import threading
from typing import NamedTuple, Optional

import torch
import torch.nn.functional as F

from . import build

# Kernel launches since the last reset: one per call, nowhere else.
CONV_LAUNCHES = 0
DENSE_LAUNCHES = 0

# The variants with one phase compiled in (csrc/qgemm_common.cuh; csrc/
# qgemm_ablate_*.cu), by phase: 1 staging, 2 the products, 4 the epilogue.
ABLATED_PHASES = {1: "stage", 2: "products", 4: "epilogue"}

INT8_MAX = 127.0
# csrc/qgemm_common.cuh's residual kinds (its output kinds: 0 float32, 1
# int8 for K9; K10 takes a bf16 flag).
_RES_NONE, _RES_INT8, _RES_F32 = 0, 1, 2

# The kernels' geometry (csrc/qgemm_common.cuh, qgemm.cu, qdense.cu).
SLICE = 128           # bytes of depth per staged slice
STAGES = 4            # slices in the staging ring
MAX_SMEM = 232448     # bytes of shared memory a block may opt in to (H100)
CONV_TILES_N = (32, 64, 128, 256)   # K9's N tiles (wgmma m64nNk32)
DENSE_TILE_N = 128                  # K10's N tile
WGMMA_N_INT8 = frozenset((8, 16, 24, *range(32, 257, 16)))  # legal s8 N


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


_F32, _I8 = torch.float32, torch.int8


def _f32_vector(t: torch.Tensor, n: int, name: str, device) -> None:
    if (t.dtype is not _F32 or t.shape != (n,) or not t.is_contiguous()
            or t.device != device):
        raise ValueError(f"{name} must be a contiguous float32 ({n},) tensor "
                         f"on {device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _f32_scalar(t: torch.Tensor, name: str, device) -> None:
    if t.dtype is not _F32 or t.numel() != 1 or t.device != device:
        raise ValueError(f"{name} must be a one-element float32 tensor on "
                         f"{device}, got {t.dtype} {tuple(t.shape)} on "
                         f"{t.device}")


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


class ConvPlan(NamedTuple):
    """One K9 launch: tile ``bn`` output channels by 64 ``wg`` pixels,
    ``byte_route`` (C % 16 != 0: staged byte by byte), a ring of
    ``stages`` slices, a grid of ``m_tiles`` x ``n_tiles`` x ``splits``
    blocks, each split ``per_split`` of the ``slices`` 128-byte depth
    slices; ``ws`` int32 partials and ``tiles`` counters when split;
    ``smem`` bytes a block."""
    M: int
    K: int
    bn: int
    wg: int
    byte_route: bool
    stages: int
    m_tiles: int
    n_tiles: int
    slices: int
    splits: int
    per_split: int
    ws: int
    tiles: int
    smem: int


class DensePlan(NamedTuple):
    """One K10 launch: ``wg`` warpgroups (64 ``wg`` rows a block),
    ``Kp`` (K rounded up to 128: the padded weights' rows and the resident
    rows' depth), ``slices`` of 128 bytes, ``n_tiles`` of 128 columns
    split over ``n_split`` blocks of ``per_split`` tiles; ``smem`` bytes
    a block."""
    M: int
    K: int
    N: int
    Kp: int
    wg: int
    m_tiles: int
    n_tiles: int
    slices: int
    n_split: int
    per_split: int
    smem: int


def conv_smem(bn: int, wg: int, stages: int) -> int:
    """csrc/qgemm.cu ``conv_smem``: alignment slack, the ring of ``stages``
    A and B slices or the epilogue's int32 tile (bn + 8 columns a row),
    whichever is larger (they take turns), the column scale and bias, a
    flag."""
    return (1024 + max(stages * (64 * wg + bn) * SLICE,
                       64 * wg * (bn + 8) * 4) + 2 * bn * 4 + 16)


def dense_smem(wg: int, slices: int) -> int:
    """csrc/qdense.cu ``dense_smem``: alignment slack, the weight ring, the
    block's quantized rows, each warp's 512-byte output buffer."""
    return (1024 + STAGES * DENSE_TILE_N * SLICE + slices * 64 * wg * SLICE
            + 4 * wg * 512)


@functools.lru_cache(maxsize=1024)
def conv_plan(B: int, H: int, W: int, C: int, Co: int, k: int, stride: int,
              sms: int, byte_route: bool = False) -> ConvPlan:
    """K9's launch for x (B, H, W, C) and w (Co, k, k, C) on a card of
    ``sms`` SMs (``byte_route``: stage byte by byte though C % 16 == 0).
    The N tile is the smallest of CONV_TILES_N that holds Co (256 and
    several tiles above it), so the gathered pixels are read once for
    every output channel; at most 128 where the depth is one or two slices
    (1x1 convs: the epilogue's tile then sets the shared memory, and a
    smaller one lets more blocks share an SM).  Two warpgroups (128
    pixels) a block where that still gives a block per SM, else one.
    Where the tiles number fewer than the SMs (the 16x12 and 8x6 maps),
    the N tile narrows down to 64, then the depth is split (at least two
    slices a split) until they reach them; the byte route splits it into
    pairs of slices.  The ring holds 4 slices, or 2 where no split has
    more."""
    Ho, Wo = conv_out_size(H, W, k, stride)
    M, K = B * Ho * Wo, k * k * C
    byte_route = byte_route or C % 16 != 0
    slices = _cdiv(K, SLICE)
    bn = 64 if byte_route else next((n for n in CONV_TILES_N if n >= Co),
                                    CONV_TILES_N[-1])
    if slices <= 2:
        bn = min(bn, 128)
    wg = 2 if _cdiv(M, 128) * _cdiv(Co, bn) >= sms else 1
    m_tiles = _cdiv(M, 64 * wg)
    while bn > 64 and m_tiles * _cdiv(Co, bn) < sms:
        bn //= 2
    n_tiles = _cdiv(Co, bn)
    tiles = m_tiles * n_tiles
    splits = 1
    if tiles < sms and slices >= 4:
        splits = min(slices // 2, _cdiv(sms, tiles))
    per_split = _cdiv(slices, splits)
    if byte_route:
        per_split = min(per_split, 2)
    splits = _cdiv(slices, per_split)
    stages = 2 if per_split <= 2 else STAGES
    ws = tiles * splits * 64 * wg * bn if splits > 1 else 0
    return ConvPlan(M, K, bn, wg, byte_route, stages, m_tiles, n_tiles,
                    slices, splits, per_split, ws, tiles if splits > 1 else 0,
                    conv_smem(bn, wg, stages))


@functools.lru_cache(maxsize=1024)
def dense_plan(M: int, K: int, N: int, sms: int) -> DensePlan:
    """K10's launch for rows (M, K) and w (N, K) on a card of ``sms`` SMs:
    two warpgroups (128 resident rows) where the rows fit beside the ring
    and the row tiles still fill the card, else one; N split over blocks
    only as far as the row tiles fall short of the SMs.  Raises if even
    64 rows of depth K do not fit in shared memory."""
    slices = _cdiv(K, SLICE)
    Kp = slices * SLICE
    if dense_smem(1, slices) > MAX_SMEM:
        raise ValueError(f"int8 dense: K = {K} is too deep for 64 resident "
                         f"rows in shared memory")
    wg = (2 if dense_smem(2, slices) <= MAX_SMEM and _cdiv(M, 128) >= sms
          else 1)
    m_tiles = _cdiv(M, 64 * wg)
    n_tiles = _cdiv(N, DENSE_TILE_N)
    n_split = min(n_tiles, max(1, _cdiv(sms, m_tiles)))
    per_split = _cdiv(n_tiles, n_split)
    n_split = _cdiv(n_tiles, per_split)
    return DensePlan(M, K, N, Kp, wg, m_tiles, n_tiles, slices, n_split,
                     per_split, dense_smem(wg, slices))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_SPLIT_BUFFERS: dict = {}


def _split_buffers(device: torch.device, stream: int, ws: int,
                   tiles: int) -> tuple:
    """K9's split-K partials (int32, at least ``ws``) and per-tile counters
    (zeros, at least ``tiles``; the last block of a tile sets its counter
    back to 0), one pair per card and stream, grown when a plan needs
    more, made while ``stream`` is current.  The launches of one stream
    use them one after another; two streams never share them, so split
    launches on two streams may overlap."""
    key = (device, stream)
    have = _SPLIT_BUFFERS.get(key)
    if have is None or have[0].numel() < ws or have[1].numel() < tiles:
        old = (0, 0) if have is None else (have[0].numel(), have[1].numel())
        have = (torch.empty(max(ws, old[0]), dtype=torch.int32, device=device),
                torch.zeros(max(tiles, old[1]), dtype=torch.int32,
                            device=device))
        _SPLIT_BUFFERS[key] = have
    return have


def padded_dense_weight(w: torch.Tensor, Kp: int, rows: int) -> torch.Tensor:
    """w (N, K) int8 as K10 reads it: (rows, Kp), zero-padded.  Made once
    per weight tensor and kept on it (``w._qdense_padded``, never in a
    state dict), made again when the tensor changes in place."""
    version = None if w.is_inference() else w._version
    key = (version, w.data_ptr(), Kp, rows)
    cached = getattr(w, "_qdense_padded", None)
    if cached is not None and cached[0] == key:
        return cached[1]
    padded = torch.zeros((rows, Kp), dtype=torch.int8, device=w.device)
    padded[:w.shape[0], :w.shape[1]] = w
    w._qdense_padded = (key, padded)
    return padded


_raw_stream = getattr(torch._C, "_cuda_getCurrentRawStream", None)
# The C entries' argument structs (csrc/qgemm.cuh QconvArgs, csrc/qdense.cuh
# QdenseArgs): pointers, then ints, packed into one buffer a thread (one
# ctypes argument instead of thirty).
_CONV_ARGS = struct.Struct("<12Q21i")
_DENSE_ARGS = struct.Struct("<7Q11i")
_ARGS = threading.local()


def _arg_buffer():
    buf = getattr(_ARGS, "buf", None)
    if buf is None:
        buf = _ARGS.buf = ctypes.create_string_buffer(
            max(_CONV_ARGS.size, _DENSE_ARGS.size))
    return buf


def _stream(device: torch.device) -> int:
    if _raw_stream is not None:
        return _raw_stream(device.index)
    return torch.cuda.current_stream(device).cuda_stream


def _on_device(device: torch.device, launch) -> int:
    """``launch(stream)`` with ``device`` current (only switched when it is
    not)."""
    if device.index == torch.cuda.current_device():
        return launch(_stream(device))
    with torch.cuda.device(device):
        return launch(_stream(device))


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
    out = _qconv_launch("ipe_qconv", x, x_scale, w, eff_scale, eff_bias,
                        stride, relu, out_scale, residual, res_scale)
    CONV_LAUNCHES += 1
    return out


def _qconv_ablate(phase: int, *args, **kwargs) -> torch.Tensor:
    """K9 on the card with only ``phase`` compiled in (1 staging, 2 the
    products, 4 the epilogue: ``ABLATED_PHASES``), for measuring where a
    launch's time goes; ``qconv``'s arguments and checks, a meaningless
    output, no count."""
    if not build.on_card(args[0], "int8 conv variant"):
        raise ValueError("the int8 conv's variants run on the card only")
    return _qconv_launch(f"ipe_qconv_{ABLATED_PHASES[phase]}_only", *args,
                         **kwargs)


def _qconv_launch(entry: str, x: torch.Tensor, x_scale: torch.Tensor,
                  w: torch.Tensor, eff_scale: torch.Tensor,
                  eff_bias: torch.Tensor, stride: int = 1, relu: bool = False,
                  out_scale: Optional[torch.Tensor] = None,
                  residual: Optional[torch.Tensor] = None,
                  res_scale: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Check ``qconv``'s arguments on the card and launch the C entry
    ``entry`` on the current stream; raises on anything it does not
    take."""
    dev = x.device
    if x.dtype is not _I8 or x.dim() != 4 or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous int8 (B, H, W, C) tensor, "
                         f"got {x.dtype} {tuple(x.shape)}")
    B, H, W, C = x.shape
    Co, k, kw, wc = w.shape if w.dim() == 4 else (0, 0, 0, 0)
    if (w.dtype is not _I8 or wc != C or k != kw or not w.is_contiguous()
            or w.device != dev):
        raise ValueError(f"w must be a contiguous int8 (Co, k, k, {C}) tensor "
                         f"on {dev}, got {w.dtype} {tuple(w.shape)}")
    if stride not in (1, 2):
        raise ValueError(f"stride must be 1 or 2, got {stride}")
    Ho, Wo = conv_out_size(H, W, k, stride)
    _f32_scalar(x_scale, "x_scale", dev)
    _f32_vector(eff_scale, Co, "eff_scale", dev)
    _f32_vector(eff_bias, Co, "eff_bias", dev)
    res_kind, p_res, p_res_scale = _RES_NONE, 0, 0
    if residual is not None:
        if (residual.shape != (B, Ho, Wo, Co) or not residual.is_contiguous()
                or residual.device != dev
                or residual.dtype not in (_I8, _F32)):
            raise ValueError(f"residual must be a contiguous int8 or float32 "
                             f"{(B, Ho, Wo, Co)} tensor on {dev}, got "
                             f"{residual.dtype} {tuple(residual.shape)}")
        p_res = residual.data_ptr()
        res_kind = _RES_INT8 if residual.dtype is _I8 else _RES_F32
        if res_kind == _RES_INT8:
            _f32_scalar(res_scale, "res_scale", dev)
            p_res_scale = res_scale.data_ptr()
    p_out_scale = 0
    if out_scale is not None:
        _f32_scalar(out_scale, "out_scale", dev)
        p_out_scale = out_scale.data_ptr()
    out = torch.empty((B, Ho, Wo, Co), device=dev,
                      dtype=_F32 if out_scale is None else _I8)
    p_x, p_w, p_out = x.data_ptr(), w.data_ptr(), out.data_ptr()
    # 16-byte copies need C % 16 == 0 and 16-byte aligned x and w
    plan = conv_plan(B, H, W, C, Co, k, stride, _sm_count(dev.index),
                     p_x % 16 != 0 or p_w % 16 != 0)
    vec_out = Co % 16 == 0 and p_out % 16 == 0 and p_res % 16 == 0
    lib, buf = build.load(), _arg_buffer()

    def launch(stream: int) -> int:
        p_ws = p_counters = 0
        if plan.splits > 1:
            ws, counters = _split_buffers(dev, stream, plan.ws, plan.tiles)
            p_ws, p_counters = ws.data_ptr(), counters.data_ptr()
        _CONV_ARGS.pack_into(
            buf, 0, p_x, p_w, x_scale.data_ptr(), eff_scale.data_ptr(),
            eff_bias.data_ptr(), p_res, p_res_scale, p_out_scale, p_out,
            p_ws, p_counters, stream, plan.bn, plan.wg, int(plan.byte_route),
            plan.stages, plan.M, Co, plan.K, H, W, C, Ho, Wo, k, stride,
            k // 2, res_kind, int(out_scale is not None), int(relu),
            int(vec_out), plan.splits, plan.per_split)
        return getattr(lib, entry)(buf)

    build.check(lib, _on_device(dev, launch), "int8 conv launch")
    return out


def qdense(x: torch.Tensor, w: torch.Tensor, w_scale: torch.Tensor,
           bias: torch.Tensor, in_scale: torch.Tensor,
           out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """K10, see the module doc: x (..., K) float32 or bf16 -> (..., N) in
    ``out_dtype`` (float32 or bf16)."""
    global DENSE_LAUNCHES
    if not build.on_card(x, "int8 dense"):
        return qdense_reference(x, w, w_scale, bias, in_scale, out_dtype)
    out, launched = _qdense_launch("ipe_qdense", x, w, w_scale, bias,
                                   in_scale, out_dtype)
    DENSE_LAUNCHES += launched
    return out


def _qdense_ablate(phase: int, *args, **kwargs) -> torch.Tensor:
    """K10 on the card with only ``phase`` compiled in (as
    ``_qconv_ablate``); ``qdense``'s arguments and checks, a meaningless
    output, no count."""
    if not build.on_card(args[0], "int8 dense variant"):
        raise ValueError("the int8 dense's variants run on the card only")
    return _qdense_launch(f"ipe_qdense_{ABLATED_PHASES[phase]}_only", *args,
                          **kwargs)[0]


def _qdense_launch(entry: str, x: torch.Tensor, w: torch.Tensor,
                   w_scale: torch.Tensor, bias: torch.Tensor,
                   in_scale: torch.Tensor,
                   out_dtype: torch.dtype = torch.float32) -> tuple:
    """Check ``qdense``'s arguments on the card and launch the C entry
    ``entry`` on the current stream (none for zero rows): (the output,
    the launches, 0 or 1); raises on anything it does not take."""
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
    if not M:
        return out, 0
    plan = dense_plan(M, K, N, _sm_count(x.device.index))
    wp = padded_dense_weight(w, plan.Kp, plan.n_tiles * DENSE_TILE_N)
    bf16 = x.dtype == torch.bfloat16
    # elements a load: 16-byte loads (8 bf16 or 4 float32), else 8-byte
    # loads of 4 bf16, else one at a time
    vec_in = (8 if bf16 and K % 8 == 0 and rows.data_ptr() % 16 == 0 else
              4 if K % 4 == 0 and rows.data_ptr() % (8 if bf16 else 16) == 0
              else 0)
    row_bytes = N * out.element_size()  # every output row start's alignment
    out_align = next(a for a in (16, 8, 4, 2)
                     if row_bytes % a == 0 and out.data_ptr() % a == 0)
    lib, buf = build.load(), _arg_buffer()

    def launch(stream: int) -> int:
        _DENSE_ARGS.pack_into(
            buf, 0, rows.data_ptr(), wp.data_ptr(), in_scale.data_ptr(),
            w_scale.data_ptr(), bias.data_ptr(), out.data_ptr(), stream,
            plan.wg, int(bf16), M, N, K, plan.Kp, plan.n_split,
            plan.per_split, int(out_dtype == torch.bfloat16), vec_in,
            out_align)
        return getattr(lib, entry)(buf)

    build.check(lib, _on_device(x.device, launch), "int8 dense launch")
    return out, 1
