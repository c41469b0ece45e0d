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

import functools

import torch

from . import build

# Kernel launches since the last reset: one per call (its partial and
# fixed-order sum passes count together), nowhere else.
LAUNCHES = 0

_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
# float32 (the CUDA-core route): dW tiles of 64 x 64, and the blocks per SM
# the split of the pixel sum aims at.
_TILE = 64
_BLOCKS_PER_SM = 4
_MIN_CHUNK = 512
# bf16 (csrc/conv_wgrad.cu ``wgrad_band_kernel``): input channels of a
# tile, about how many pixels a band holds, the zeros that padded pixels
# read, and the shared memory a block may opt in to (bytes).
BAND_CI = 32
_BAND_PIXELS = 192
_ZEROS = 64
MAX_SMEM = 232448


def splits(P: int, Q: int, M: int, sm_count: int) -> int:
    """float32: how many chunks of the M pixel rows the kernel sums
    separately (then adds in a fixed order): about ``_BLOCKS_PER_SM``
    blocks per SM over the (P/64) x (Q/64) tiles of dW, each chunk at
    least ``_MIN_CHUNK`` rows."""
    tiles = -(-P // _TILE) * -(-Q // _TILE)
    want = -(-_BLOCKS_PER_SM * sm_count // tiles)
    return max(1, min(want, -(-M // _MIN_CHUNK)))


def band_smem(rows: int, W: int, tco: int) -> int:
    """Shared memory of the bf16 kernel (bytes): two buffers of the x rows
    of a band with their halo ((rows + 2) x (W + 2) pixels, BAND_CI + 8
    bf16 each) and its dy rows (rows x W, tco + 8 bf16 each), and a row of
    zeros."""
    elems = (rows + 2) * (W + 2) * (BAND_CI + 8) + rows * W * (tco + 8)
    return 2 * (2 * elems + _ZEROS)


@functools.lru_cache(maxsize=256)
def wgrad_plan(B: int, H: int, W: int, Ci: int, Co: int,
               sm_count: int) -> dict:
    """The bf16 kernel's grid (csrc/conv_wgrad.cu): ``rows`` pixel rows a
    band (about _BAND_PIXELS pixels, at most the map), ``tco`` output
    channels a (BAND_CI x tco) tile of (Ci, Co), every tile for all nine
    taps, and the B * ceil(H / rows) bands cut into ``splits`` chunks of
    ``bands_per_chunk``, one block per (tile, chunk) and one partial dW per
    chunk.  The splits fill a wave: at least one block per SM, up to two
    (a block's 288 threads and its two band buffers leave room for two)
    while the partials (written and read back once) stay within the
    bytes of x and dy; a small dW (b0: 288 x 32) is split over bands, a
    large one (b3: 2,304 x 256 at 8 x 6) mostly over its tiles.  The 64-
    wide tile, which does twice the products per fragment, where the
    products dominate (Ci Co >= 32,768 over >= 16,384 pixels).  Cached:
    the wrapper calls it per launch; callers do not change it."""
    M = B * H * W
    rows = min(H, max(1, _BAND_PIXELS // W))
    bands = B * -(-H // rows)
    tco = 64 if Co % 64 == 0 and Ci * Co >= 32768 and M >= 16384 else 32
    tiles = -(-Ci // BAND_CI) * -(-Co // tco)
    partial = 4 * 9 * Ci * Co
    cap = 2 * M * (Ci + Co) // partial  # partial bytes within x and dy's
    want = max(-(-sm_count // tiles), min(2 * sm_count // tiles, cap))
    want = max(1, min(want, bands))
    bpc = -(-bands // want)
    if -(-bands // bpc) * tiles < sm_count:
        bpc = max(1, bands // want)
    return dict(rows=rows, tco=tco, bands=bands, bands_per_chunk=bpc,
                splits=-(-bands // bpc), tiles=tiles,
                smem=band_smem(rows, W, tco))


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


def conv3x3_wgrad_band_emulation(x: torch.Tensor, dy: torch.Tensor,
                                 plan: dict) -> torch.Tensor:
    """The bf16 kernel's order of sums in plain PyTorch, on the CPU: per
    chunk of ``plan`` (``wgrad_plan``), its bands' nine shifted products
    (x_shift^T dy over the band's pixels, float32) added in band order;
    then the chunks added as ``launch_colsum`` adds them (rows r = ry, ry +
    8, ... summed per ry, the eight sums in ry order).  For the tests only:
    no model path runs it."""
    B, H, W, Ci = x.shape
    Co = dy.shape[-1]
    rows, bpc = plan["rows"], plan["bands_per_chunk"]
    nb = -(-H // rows)
    xp = torch.nn.functional.pad(x.float(), (0, 0, 1, 1, 1, 1))
    d32 = dy.float()
    parts = []
    for z in range(plan["splits"]):
        acc = torch.zeros(9, Ci, Co)
        for b in range(z * bpc, min(B * nb, (z + 1) * bpc)):
            img, r0 = b // nb, (b % nb) * rows
            r1 = min(H, r0 + rows)
            d = d32[img, r0:r1].reshape(-1, Co)
            for t in range(9):
                dh, dw = divmod(t, 3)
                a = xp[img, r0 + dh:r1 + dh, dw:dw + W].reshape(-1, Ci)
                acc[t] = acc[t] + a.t() @ d
        parts.append(acc)
    if len(parts) == 1:
        return parts[0].reshape(3, 3, Ci, Co)
    groups = [torch.zeros(9, Ci, Co) for _ in range(8)]
    for r, part in enumerate(parts):
        groups[r % 8] = groups[r % 8] + part
    out = groups[0]
    for grp in groups[1:]:
        out = out + grp
    return out.reshape(3, 3, Ci, Co)


def conv3x3_wgrad(x: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """K6: (x, dy) -> dW (3, 3, Ci, Co) float32, see the module doc.  The
    sum over pixels is taken in chunks whose partials are added in a
    fixed order: the result does not depend on how blocks are
    scheduled."""
    global LAUNCHES
    if not build.on_card(x, "3x3 weight-gradient"):
        return conv3x3_wgrad_reference(x, dy)
    code = _check(x, dy)
    B, H, W, Ci = x.shape
    Co = dy.shape[-1]
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    if code:
        plan = wgrad_plan(B, H, W, Ci, Co, sms)
        n, band = plan["splits"], (plan["rows"], plan["tco"],
                                   plan["bands_per_chunk"])
    else:
        n, band = splits(9 * Ci, Co, B * H * W, sms), (0, 0, 0)
    out = torch.empty((3, 3, Ci, Co), dtype=torch.float32, device=x.device)
    # float32 always sums its chunks' partials; bf16 writes one chunk
    # straight into out
    partial = torch.empty((0 if code and n == 1 else n, 9 * Ci, Co),
                          dtype=torch.float32, device=x.device)
    lib = build.load()
    with torch.cuda.device(x.device):
        err = lib.ipe_conv3x3_wgrad(
            x.data_ptr(), dy.data_ptr(), out.data_ptr(), partial.data_ptr(),
            B, H, W, Ci, Co, n, *band, code,
            torch.cuda.current_stream().cuda_stream)
    build.check(lib, err, "conv3x3_wgrad launch")
    LAUNCHES += 1
    return out
