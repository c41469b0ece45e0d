"""Shared building blocks: compute-dtype Linear, Conv2d (depthwise too)
and ConvTranspose2d, BatchNorm and
GroupNorm (``make_norm``), ConvNorm, BasicBlock, Bottleneck, bilinear
resize, DropPath, and the transition and all-pairs fuse layers of the
multi-resolution backbones; their int8 serving twins (``QConvNorm``,
``QDense``, the ``quant`` forms of the blocks and fuse) and the
calibration sow points (``sow_absmax``).

Port of infantposeestimation_gaussianbias_tpu/models/layers.py.  Feature
maps are NHWC, as in the JAX package: a convolution hands PyTorch the
NCHW view of its NHWC input (``permute``, no copy), so the convolution
sees a ``channels_last`` tensor and returns one whose NHWC view is
contiguous again.

Precision is set by explicit casts, not autocast: parameters stay
float32, and each Linear and Conv2d casts its input, weight and bias to
the module's ``compute_dtype`` before the product, as a flax
``nn.Dense(dtype=...)`` does.  BatchNorm folds its statistics in float32
and applies the affine in the activation dtype.

Under a process grid (parallel/mesh.py) a train-mode BatchNorm whose
``grid`` is set takes its statistics over the global batch: the float32
sum, sum of squares and count are all-reduced over the grid's data group
(``_GlobalSums``), as GSPMD's statistics over a 'data'-sharded batch are
global in the JAX package.

int8 PTQ (ops/quant.py), as the JAX package's ``quant`` and ``calibrate``
modes: under ``calibrating(record)`` every sow point of the float model
adds the running abs-max of its tensor to ``record`` (a ConvNorm's output
at ``{conv}.out_absmax``, a block's at ``{block}.out_absmax``, a fused
sum at ``{module}.fused{i}_absmax``, a wide Linear's input at
``{linear}.in_absmax``); the ``quant`` modules read the buffers that
``ops.quant.convert_tree`` makes of that record, named alike.  Between
int8 layers activations travel as ``QTensor``s.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Iterator, List, Optional, Sequence

import torch
import torch.distributed as dist
import torch.nn as nn
import torch.nn.functional as F

from ..kernels import ops as kops
from ..kernels import quant as qk
from ..ops.quant import QTensor, requantize
from ..parallel.tensor import column_parallel

# True while a checkpointed forward is recomputed in the backward: the
# recomputation must not update the running statistics a second time.
_STATS_FROZEN = contextvars.ContextVar("ipe_bn_stats_frozen", default=False)


@contextlib.contextmanager
def frozen_batch_stats() -> Iterator[None]:
    """Within this context train-mode BatchNorm normalises with batch
    statistics but leaves its running statistics as they are."""
    token = _STATS_FROZEN.set(True)
    try:
        yield
    finally:
        _STATS_FROZEN.reset(token)


# -- int8 PTQ calibration -----------------------------------------------------

class Calibration:
    """The running abs-max of every sow point of one model, keyed by the
    module's name in it (``model.named_modules()``) and the point's name.
    ``convs``: record the conv points (HRNet quantizes its convs); the
    wide Linears' inputs are recorded always (HRFormer quantizes those)."""

    def __init__(self, model: nn.Module, convs: bool = True):
        self.names = {id(m): n for n, m in model.named_modules()}
        self.convs = convs
        self.values: Dict[str, torch.Tensor] = {}


_CALIB: contextvars.ContextVar = contextvars.ContextVar("ipe_calibration",
                                                        default=None)


@contextlib.contextmanager
def calibrating(record: Optional[Calibration]) -> Iterator[None]:
    """Within this context the sow points record into ``record`` (None:
    nowhere)."""
    token = _CALIB.set(record)
    try:
        yield
    finally:
        _CALIB.reset(token)


def is_calibrating() -> bool:
    return _CALIB.get() is not None


def sow_absmax(module: nn.Module, name: str, x: torch.Tensor,
               conv: bool = True) -> None:
    """Record max |x| (taken in x's dtype, kept as float32) at
    ``{module's name}.{name}``, as a running maximum over forwards; a no-op
    outside ``calibrating``.  ``conv``: a conv point, skipped unless the
    record takes them."""
    rec = _CALIB.get()
    if rec is None or (conv and not rec.convs):
        return
    path = rec.names[id(module)]
    key = f"{path}.{name}" if path else name
    v = x.detach().abs().amax().float()
    old = rec.values.get(key)
    rec.values[key] = v if old is None else torch.maximum(old, v)


# -- layers ---------------------------------------------------------------------

class Linear(nn.Linear):
    """nn.Linear that computes in ``compute_dtype`` (float32 parameters).
    ``init``: the initialiser ``weights.init_weights`` draws its weight
    from, "trunc_normal" (std 0.02, the HRFormer's) or "lecun" (flax's
    ``nn.Dense`` default, truncated normal of variance 1 / fan-in)."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32,
                 init: str = "trunc_normal"):
        super().__init__(in_features, out_features)
        self.compute_dtype = compute_dtype
        self.init = init

    tp = None  # a parallel.tensor.Shard once shard_params cuts the weight

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        if self.tp is not None:
            return column_parallel(x.to(dt), self.weight.to(dt),
                                   self.bias.to(dt), self.tp, F.linear)
        return F.linear(x.to(dt), self.weight.to(dt), self.bias.to(dt))


class Conv2d(nn.Conv2d):
    """NHWC-in, NHWC-out nn.Conv2d computing in ``compute_dtype``, with the
    symmetric ``kernel_size // 2`` padding of the JAX ConvNorm; ``groups``
    as torch's (``groups=C``: a depthwise conv, flax's
    ``feature_group_count``).  ``init``: how ``weights.init_weights``
    draws it, "auto" (kaiming-normal fan-out without a bias, a prediction
    conv's normal 0.001 with one) or "kaiming" (kaiming-normal fan-out and
    a zero bias)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 1, bias: bool = False,
                 compute_dtype: torch.dtype = torch.float32,
                 groups: int = 1, init: str = "auto"):
        super().__init__(in_channels, out_channels, kernel_size, stride=stride,
                         padding=kernel_size // 2, bias=bias, groups=groups)
        self.compute_dtype = compute_dtype
        self.init = init

    tp = None  # a parallel.tensor.Shard once shard_params cuts the weight

    def _conv(self, x: torch.Tensor, w: torch.Tensor,
              b: Optional[torch.Tensor] = None) -> torch.Tensor:
        y = F.conv2d(x.permute(0, 3, 1, 2), w, b, self.stride, self.padding,
                     groups=self.groups)
        return y.permute(0, 2, 3, 1)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        b = None if self.bias is None else self.bias.to(dt)
        if self.tp is not None:
            return column_parallel(x.to(dt), self.weight.to(dt), b, self.tp,
                                   self._conv)
        return self._conv(x.to(dt), self.weight.to(dt), b)


def same_transpose_padding(kernel: int, stride: int) -> tuple:
    """(padding, output_padding, crop) that make ``F.conv_transpose2d``
    with a spatially flipped kernel compute ``lax.conv_transpose(...,
    padding="SAME")``: an unflipped correlation over the input dilated by
    ``stride`` and padded (a, b), a = k - 1 if stride > k - 1 else
    ceil((k + stride - 2) / 2), b = k + stride - 2 - a, giving an output of
    ``stride`` x the input.  torch pads k - 1 - padding before and that
    plus output_padding after; where b < a it pads a on both sides and the
    last ``crop`` rows and columns are dropped."""
    pad_len = kernel + stride - 2
    a = kernel - 1 if stride > kernel - 1 else -(-pad_len // 2)
    b = pad_len - a
    return kernel - 1 - a, max(b - a, 0), max(a - b, 0)


class ConvTranspose2d(nn.ConvTranspose2d):
    """NHWC flax ``nn.ConvTranspose`` (``transpose_kernel=False``,
    ``padding="SAME"``, no bias) computing in ``compute_dtype``: flax
    applies its (kh, kw, I, O) kernel unflipped to the dilated input and
    torch's transposed conv flips its (I, O, kh, kw) weight, so the
    weight holds the flax kernel flipped in both spatial axes (see
    ``same_transpose_padding`` for the padding)."""

    def __init__(self, in_channels: int, out_channels: int, kernel_size: int,
                 stride: int = 2, compute_dtype: torch.dtype = torch.float32):
        pad, out_pad, crop = same_transpose_padding(kernel_size, stride)
        super().__init__(in_channels, out_channels, kernel_size,
                         stride=stride, padding=pad, output_padding=out_pad,
                         bias=False)
        self.crop = crop
        self.compute_dtype = compute_dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        y = F.conv_transpose2d(x.to(dt).permute(0, 3, 1, 2),
                               self.weight.to(dt), None, self.stride,
                               self.padding, self.output_padding)
        if self.crop:
            y = y[:, :, :y.shape[2] - self.crop, :y.shape[3] - self.crop]
        return y.permute(0, 2, 3, 1)


class _GlobalSums(torch.autograd.Function):
    """Sum a tensor of per-rank partial sums over a process group.  Every
    rank's loss reads the global sums, so the gradient of each rank's
    partial sums is the sum over the group of the gradients of the global
    ones: the backward all-reduces too."""

    @staticmethod
    def forward(ctx, sums: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = sums.clone()
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class BatchNorm(nn.BatchNorm2d):
    """BatchNorm2d over the last (channel) axis of an NHWC map, with the
    JAX package's arithmetic (models/layers.py:124-165 there); eps 1e-5.

    Inference folds (weight, bias, running_mean, running_var) into one
    per-channel (a, b) in float32 and applies ``x * a + b`` in the
    activation dtype.  Training takes the batch mean and the biased
    variance E[x^2] - E[x]^2 in float32, moves the running statistics to
    ``0.9 * running + 0.1 * batch`` with that biased variance (torch's own
    BatchNorm2d would use the unbiased one), and returns
    ``(x.float() * a + b)`` cast back to x's dtype.  With ``grid`` set (a
    ProcessGrid of more than one data rank) the batch is the global one:
    its sums are all-reduced over the data group, so every rank normalises
    with the same statistics and moves its running statistics alike.
    """

    MOMENTUM = 0.9  # flax's convention: the weight of the running value
    grid = None     # set by models.build_model under a process grid

    def _batch_stats(self, xf: torch.Tensor) -> tuple:
        dims = (0, 1, 2)
        grid = self.grid
        if grid is None or grid.data == 1:
            mean = xf.mean(dim=dims)
            return mean, (xf * xf).mean(dim=dims) - mean * mean
        C = xf.shape[-1]
        count = xf.new_full((1,), xf.numel() // C)
        sums = _GlobalSums.apply(
            torch.cat([xf.sum(dim=dims), (xf * xf).sum(dim=dims), count]),
            grid.data_group)
        mean = sums[:C] / sums[-1]
        return mean, sums[C:2 * C] / sums[-1] - mean * mean

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            a = self.weight * torch.rsqrt(self.running_var + self.eps)
            b = self.bias - self.running_mean * a
            return x * a.to(x.dtype) + b.to(x.dtype)
        xf = x.float()
        mean, var = self._batch_stats(xf)
        if not _STATS_FROZEN.get():
            m = self.MOMENTUM
            with torch.no_grad():
                self.running_mean.copy_(m * self.running_mean
                                        + (1 - m) * mean)
                self.running_var.copy_(m * self.running_var + (1 - m) * var)
        a = self.weight * torch.rsqrt(var + self.eps)
        b = self.bias - mean * a
        return (xf * a + b).to(x.dtype)


class GroupNorm(nn.GroupNorm):
    """GroupNorm over the last (channel) axis of an NHWC map, the JAX
    package's ``Norm(kind="groupnorm")`` (models/layers.py:168-186 there):
    ``min(32, C)`` groups, lowered until they divide C; eps 1e-5;
    statistics over (H, W, group channels) in float32; the output cast
    back to the input's dtype.  flax takes the variance as E[x^2] - E[x]^2
    and torch's ``group_norm`` as E[(x - mean)^2]: the two agree to float32
    rounding of the statistics (tests/test_torch_norm.py states the
    bound).  No running statistics: train and eval are the same."""

    def __init__(self, channels: int):
        groups = min(32, channels)
        while channels % groups:
            groups -= 1
        super().__init__(groups, channels, eps=1e-5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.group_norm(x.float().permute(0, 3, 1, 2), self.num_groups,
                         self.weight, self.bias, self.eps)
        return y.permute(0, 2, 3, 1).to(x.dtype)


NORMS = {"batchnorm": BatchNorm, "groupnorm": GroupNorm}


class QConvNorm(nn.Module):
    """int8 twin of a ConvNorm (the JAX package's ``ConvNorm._quant_call``):
    K9 (kernels/quant.py ``qconv``) on a QTensor, the BatchNorm folded into
    its epilogue.  ``relu``: the output is ReLU'd and requantized to int8
    with ``out_scale`` (``quant_out``); without it the output is the
    float32 pre-activation.  Its buffers (ops.quant.convert_convnorm):
    ``w_int8`` (Co, k, k, Ci), ``eff_scale``, ``eff_bias`` (Co,), and
    ``out_scale`` (), calibrated for every ConvNorm as in the JAX
    package."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel_size: int = 3, stride: int = 1, relu: bool = True):
        super().__init__()
        self.stride = stride
        self.relu = relu
        self.register_buffer("w_int8", torch.zeros(
            out_channels, kernel_size, kernel_size, in_channels,
            dtype=torch.int8))
        self.register_buffer("eff_scale", torch.zeros(out_channels))
        self.register_buffer("eff_bias", torch.zeros(out_channels))
        self.register_buffer("out_scale", torch.ones(()))

    def forward(self, x: QTensor):
        out_scale = self.out_scale if self.relu else None
        if torch.compiler.is_exporting():  # one operator node (kernels/ops)
            y = kops.qconv(x.data, x.scale, self.w_int8, self.eff_scale,
                           self.eff_bias, self.stride, self.relu, out_scale,
                           None, None)
        else:
            y = qk.qconv(x.data, x.scale, self.w_int8, self.eff_scale,
                         self.eff_bias, self.stride, relu=self.relu,
                         out_scale=out_scale)
        return QTensor(y, self.out_scale) if self.relu else y

    def fused(self, x: QTensor, residual, out_scale: torch.Tensor) -> QTensor:
        """A residual block's tail in one launch: this conv's affine, plus
        ``residual`` (a QTensor, dequantized, or float32), ReLU, and the
        requantize with the block's ``out_scale``."""
        res, res_scale = ((residual.data, residual.scale)
                          if isinstance(residual, QTensor) else (residual, None))
        if torch.compiler.is_exporting():  # one operator node (kernels/ops)
            y = kops.qconv(x.data, x.scale, self.w_int8, self.eff_scale,
                           self.eff_bias, self.stride, True, out_scale, res,
                           res_scale)
        else:
            y = qk.qconv(x.data, x.scale, self.w_int8, self.eff_scale,
                         self.eff_bias, self.stride, relu=True,
                         out_scale=out_scale, residual=res,
                         res_scale=res_scale)
        return QTensor(y, out_scale)


class QDense(nn.Module):
    """int8 serving twin of a Linear (the JAX package's ``QDense``): K10
    (kernels/quant.py ``qdense``) on a float input, the output in
    ``compute_dtype``.  Buffers (ops.quant.convert_dense): ``w_int8``
    (out, in), ``w_scale``, ``bias`` (out,), ``in_scale`` ()."""

    def __init__(self, in_features: int, out_features: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.register_buffer("w_int8", torch.zeros(out_features, in_features,
                                                   dtype=torch.int8))
        self.register_buffer("w_scale", torch.zeros(out_features))
        self.register_buffer("bias", torch.zeros(out_features))
        self.register_buffer("in_scale", torch.ones(()))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if torch.compiler.is_exporting():  # one operator node (kernels/ops)
            return kops.qdense(x, self.w_int8, self.w_scale, self.bias,
                               self.in_scale, self.compute_dtype)
        return qk.qdense(x, self.w_int8, self.w_scale, self.bias,
                         self.in_scale, self.compute_dtype)


def make_norm(kind: str, channels: int, fold: bool = False) -> nn.Module:
    """The norm layer ``cfg.model.norm`` names: "batchnorm" or
    "groupnorm"; any other name raises, as the JAX package's ``Norm``
    does.  ``fold``: the BN-folded serving form (models/fold.py), an
    identity in the norm's place, whose conv carries the folded affine as
    its bias."""
    if kind not in NORMS:
        raise ValueError(f"Unknown norm {kind!r}")
    return nn.Identity() if fold else NORMS[kind](channels)


class ConvNormSeq(nn.Sequential):
    """A Sequential ConvNorm that records its output at
    ``{conv}.out_absmax`` (``sow_absmax``)."""

    def forward(self, x):
        y = super().forward(x)
        sow_absmax(self[0], "out_absmax", y)
        return y


def conv_norm(in_channels: int, out_channels: int, kernel_size: int = 3,
              stride: int = 1, relu: bool = True,
              compute_dtype: torch.dtype = torch.float32,
              norm: str = "batchnorm", fold: bool = False,
              quant: bool = False) -> nn.Sequential:
    """Conv (bias-free) -> norm (-> ReLU), named 0/1(/2) as the
    reference's ``Sequential`` blocks; with ``fold`` a biased conv and an
    identity (the JAX package's ``ConvNorm(fold=True)``); with ``quant`` a
    ``QConvNorm`` and an identity (a ReLU'd ConvNorm requantizes, the
    others end in float32, as the JAX package's ``quant_out``)."""
    if quant:
        return nn.Sequential(QConvNorm(in_channels, out_channels,
                                       kernel_size, stride, relu),
                             nn.Identity())
    mods = [Conv2d(in_channels, out_channels, kernel_size, stride,
                   bias=fold, compute_dtype=compute_dtype),
            make_norm(norm, out_channels, fold)]
    if relu:
        mods.append(nn.ReLU())
    return ConvNormSeq(*mods)


class BasicBlock(nn.Module):
    """Two 3x3 conv-BN units with an identity residual: relu(bn1(conv1(x)))
    -> bn2(conv2(.)) -> relu(. + x), named as the reference's BasicBlock
    (models/layers.py:193-222 of the JAX package); ``fold`` as
    ``conv_norm``'s.  ``quant``: conv1 a ReLU'd QConvNorm, conv2's launch
    also adds the dequantized input, ReLUs and requantizes with the
    block's ``out_scale``."""

    def __init__(self, features: int,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm", fold: bool = False,
                 quant: bool = False):
        super().__init__()
        self.quant = quant
        if quant:
            self.conv1 = QConvNorm(features, features, 3)
            self.conv2 = QConvNorm(features, features, 3, relu=False)
            self.register_buffer("out_scale", torch.ones(()))
            return
        kw = dict(bias=fold, compute_dtype=compute_dtype)
        self.conv1 = Conv2d(features, features, 3, **kw)
        self.bn1 = make_norm(norm, features, fold)
        self.conv2 = Conv2d(features, features, 3, **kw)
        self.bn2 = make_norm(norm, features, fold)

    def forward(self, x):
        if self.quant:
            return self.conv2.fused(self.conv1(x), x, self.out_scale)
        y = F.relu(self.bn1(self.conv1(x)))
        sow_absmax(self.conv1, "out_absmax", y)
        y = self.bn2(self.conv2(y))
        sow_absmax(self.conv2, "out_absmax", y)
        out = F.relu(y + x)
        sow_absmax(self, "out_absmax", out)
        return out


class Bottleneck(nn.Module):
    """1x1 -> 3x3 -> 1x1 (x4) residual block with an optional 1x1
    ``downsample`` on the skip when the channel count changes; ``fold`` as
    ``conv_norm``'s.  ``quant``: ReLU'd QConvNorms conv1 and conv2; conv3's
    launch adds the skip (the float32 downsample, or the dequantized
    input), ReLUs and requantizes with the block's ``out_scale``."""

    expansion = 4

    def __init__(self, in_channels: int, features: int,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm", fold: bool = False,
                 quant: bool = False):
        super().__init__()
        out = features * self.expansion
        self.quant = quant
        # registration order (convs, then downsample) is the order in
        # which weights.init_weights draws the seeded weights
        if quant:
            self.conv1 = QConvNorm(in_channels, features, 1)
            self.conv2 = QConvNorm(features, features, 3)
            self.conv3 = QConvNorm(features, out, 1, relu=False)
            self.register_buffer("out_scale", torch.ones(()))
        else:
            kw = dict(bias=fold, compute_dtype=compute_dtype)
            self.conv1 = Conv2d(in_channels, features, 1, **kw)
            self.bn1 = make_norm(norm, features, fold)
            self.conv2 = Conv2d(features, features, 3, **kw)
            self.bn2 = make_norm(norm, features, fold)
            self.conv3 = Conv2d(features, out, 1, **kw)
            self.bn3 = make_norm(norm, out, fold)
        self.downsample = (conv_norm(in_channels, out, 1, relu=False,
                                     compute_dtype=compute_dtype, norm=norm,
                                     fold=fold, quant=quant)
                           if in_channels != out else None)

    def forward(self, x):
        residual = x if self.downsample is None else self.downsample(x)
        if self.quant:
            y = self.conv2(self.conv1(x))
            return self.conv3.fused(y, residual, self.out_scale)
        y = F.relu(self.bn1(self.conv1(x)))
        sow_absmax(self.conv1, "out_absmax", y)
        y = F.relu(self.bn2(self.conv2(y)))
        sow_absmax(self.conv2, "out_absmax", y)
        y = self.bn3(self.conv3(y))
        sow_absmax(self.conv3, "out_absmax", y)
        out = F.relu(y + residual)
        sow_absmax(self, "out_absmax", out)
        return out


def resize_bilinear(x: torch.Tensor, height: int, width: int) -> torch.Tensor:
    """Bilinear NHWC resize with half-pixel centres and edge clamp, which is
    ``F.interpolate(mode="bilinear", align_corners=False)``."""
    if x.shape[1] == height and x.shape[2] == width:
        return x
    y = F.interpolate(x.permute(0, 3, 1, 2), size=(height, width),
                      mode="bilinear", align_corners=False)
    return y.permute(0, 2, 3, 1)


def drop_path(x: torch.Tensor, keep: Optional[torch.Tensor],
              rate: float) -> torch.Tensor:
    """Per-sample stochastic depth (models/layers.py:299-312 of the JAX
    package): samples whose ``keep`` flag is False are zeroed, the others
    scaled by 1 / (1 - rate).  ``keep`` is a (B,) bool tensor drawn by the
    caller (train/step.py ``draw_drop_masks``), or None for the identity."""
    if keep is None or rate == 0.0:
        return x
    mask = keep.reshape((-1,) + (1,) * (x.dim() - 1))
    return torch.where(mask, x / (1.0 - rate), 0.0).to(x.dtype)


def make_transition(prev: Sequence[int], cur: Sequence[int],
                    compute_dtype: torch.dtype = torch.float32,
                    norm: str = "batchnorm", fold: bool = False,
                    quant: bool = False) -> nn.ModuleList:
    """Transition into a stage of ``cur`` branches from one of ``prev``: a
    3x3 ConvNorm where a branch's width changes (Identity where it does
    not), and a stride-2 3x3 ConvNorm from the lowest branch for each new
    one, wrapped in one more Sequential as in the reference."""
    kw = dict(compute_dtype=compute_dtype, norm=norm, fold=fold, quant=quant)
    trans = nn.ModuleList()
    for i, ch in enumerate(cur):
        if i < len(prev):
            trans.append(conv_norm(prev[i], ch, 3, **kw)
                         if prev[i] != ch else nn.Identity())
        else:
            trans.append(nn.Sequential(
                conv_norm(prev[-1], ch, 3, stride=2, **kw)))
    return trans


def apply_transition(trans: nn.ModuleList,
                     xs: List[torch.Tensor]) -> List[torch.Tensor]:
    """A new branch takes the lowest existing one as its input."""
    return [tr(xs[i] if i < len(xs) else xs[-1])
            for i, tr in enumerate(trans)]


def make_fuse_layers(channels: Sequence[int],
                     compute_dtype: torch.dtype = torch.float32,
                     norm: str = "batchnorm", fold: bool = False,
                     quant: bool = False) -> nn.ModuleList:
    """All-pairs fuse layers of an exchange module: layer (i, j) is, for
    j > i, a 1x1 ConvNorm (upsampled in ``fuse``); for j == i the
    identity; for j < i a chain of stride-2 3x3 ConvNorms, ReLU on all but
    the last, which also changes the width."""
    kw = dict(compute_dtype=compute_dtype, norm=norm, fold=fold, quant=quant)
    n = len(channels)
    rows = nn.ModuleList()
    for i in range(n):
        row = nn.ModuleList()
        for j in range(n):
            if j > i:
                row.append(conv_norm(channels[j], channels[i], 1,
                                     relu=False, **kw))
            elif j == i:
                row.append(nn.Identity())
            else:
                row.append(nn.Sequential(*[
                    conv_norm(channels[j],
                              channels[i] if k == i - j - 1 else channels[j],
                              3, stride=2, relu=k != i - j - 1, **kw)
                    for k in range(i - j)]))
        rows.append(row)
    return rows


def fuse(fuse_layers: nn.ModuleList, ys: list,
         module: Optional[nn.Module] = None) -> list:
    """Output i = relu(sum over j of layer (i, j) of branch j), the
    higher-indexed (lower-resolution) branches resized to branch i's map;
    each recorded at ``{module}.fused{i}_absmax``.  int8 (``ys``
    QTensors, the JAX HRModule's quant fuse): every contribution lands in
    float32 (the identity dequantized, the projections and chains ending
    in float32), and the ReLU'd sum is requantized with ``module``'s
    ``fused{i}_scale``."""
    quant = isinstance(ys[0], QTensor)
    out = []
    for i, row in enumerate(fuse_layers):
        acc = None
        for j, layer in enumerate(row):
            contrib = layer(ys[j])
            if j == i and quant:
                contrib = contrib.dequantize()
            elif j > i:
                contrib = resize_bilinear(contrib, ys[i].shape[1],
                                          ys[i].shape[2])
            acc = contrib if acc is None else acc + contrib
        acc = F.relu(acc)
        if quant:
            acc = requantize(acc, getattr(module, f"fused{i}_scale"))
        else:
            sow_absmax(module, f"fused{i}_absmax", acc)
        out.append(acc)
    return out


def remat_contexts():
    """(forward context, recomputation context) for
    ``torch.utils.checkpoint``: the recomputed forward must not move the
    BatchNorm running statistics a second time (flax's remat returns them
    from the first pass only)."""
    return contextlib.nullcontext(), frozen_batch_stats()
