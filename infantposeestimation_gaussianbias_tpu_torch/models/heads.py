"""Prediction heads on NHWC features: the heatmap head (with its optional
deconv stack), the 3-branch fusion head, the Stack-B fused head and the
SimCC head.

Ports of HeatmapHead, FusionHead, FusedHead and SimCCHead in
infantposeestimation_gaussianbias_tpu/models/heads.py.  The heatmap and
fusion heads are named as the reference's state dicts: ``final_layer``
(HeatmapHead); ``shared_layers``, ``heatmap_branch``, ``offset_branch``,
``variance_branch``, ``fusion_weight``, ``subpixel_refine.alpha``
(``HeatmapRegressionHead``).  The rest, which no reference checkpoint
holds, are named as the flax module paths: ``deconv{i}``,
``deconv{i}_norm``; ``hm``, ``reg_conv``, ``reg_fc``, ``refine_conv``,
``refine_final``; ``kpt_conv``, ``fc_x``, ``fc_y``.

Outputs are float32 and NHWC: heatmaps (B, H, W, K), offsets
(B, H, W, K, 2), variances (B, H, W, K); the fused head's coords and
refined_coords (B, K, 2), normalised to [0, 1]; the SimCC head's
simcc_x (B, K, W_bins) and simcc_y (B, K, H_bins) logits.

int8 PTQ (an int8 HRNet hands over a QTensor): HeatmapHead dequantizes
into the compute dtype; FusionHead's hidden ConvNorms are QConvNorms on K9
(``quant``), and its 1x1 finals run in the compute dtype on the
dequantized maps, as the JAX package's heads.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quant import QTensor
from .layers import (Conv2d, ConvTranspose2d, Linear, QConvNorm, conv_norm,
                     make_norm, sow_absmax)


def dequantized(x, dtype: torch.dtype) -> torch.Tensor:
    """A QTensor dequantized into ``dtype``; any other input as it is."""
    return x.dequantize(dtype) if isinstance(x, QTensor) else x


class HeatmapHead(nn.Module):
    """SimpleBaseline-style head: ``num_deconv_layers`` stride-2 transposed
    convs (``deconv_kernels``, ``deconv_filters``; no bias) each with a
    norm and ReLU, then one 1x1 prediction conv with bias.  ``build_model``
    builds it without the deconv stack (``num_deconv_layers=0``), as the
    JAX PoseEstimator does."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 compute_dtype: torch.dtype = torch.float32,
                 num_deconv_layers: int = 0,
                 deconv_filters: Sequence[int] = (256, 256, 256),
                 deconv_kernels: Sequence[int] = (4, 4, 4),
                 norm: str = "batchnorm"):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.num_deconv_layers = num_deconv_layers
        width = in_channels
        for i in range(num_deconv_layers):
            setattr(self, f"deconv{i}", ConvTranspose2d(
                width, deconv_filters[i], deconv_kernels[i],
                compute_dtype=compute_dtype))
            setattr(self, f"deconv{i}_norm",
                    make_norm(norm, deconv_filters[i]))
            width = deconv_filters[i]
        self.final_layer = Conv2d(width, num_keypoints, 1, bias=True,
                                  compute_dtype=compute_dtype)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = dequantized(x, self.compute_dtype)
        for i in range(self.num_deconv_layers):
            x = F.relu(getattr(self, f"deconv{i}_norm")(
                getattr(self, f"deconv{i}")(x)))
        return {"heatmaps": self.final_layer(x).float()}


class _SubpixelRefine(nn.Module):
    """Holds the learnable sub-pixel blend logit (decode reads it)."""

    def __init__(self):
        super().__init__()
        self.alpha = nn.Parameter(torch.tensor(0.5))


class FusionHead(nn.Module):
    """Shared trunk (2 x 3x3 conv-norm-ReLU) + heatmap / offset / variance
    branches (3x3 conv-norm-ReLU -> 1x1), variance through softplus, plus
    the two decode logits.  ``fold``: the BN-folded serving form of its
    hidden ConvNorms (models/fold.py); ``quant``: the int8 one (each
    ConvNorm a QConvNorm at the conv's index, identities after it)."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 hidden_dim: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm", fold: bool = False,
                 quant: bool = False):
        super().__init__()
        h, K = hidden_dim, num_keypoints
        kw = dict(compute_dtype=compute_dtype)
        ckw = dict(bias=fold, **kw)
        self.num_keypoints = K
        self.compute_dtype = compute_dtype
        self.quant = quant

        def unit(cin: int, cout: int) -> list:
            """A 3x3 ConvNorm with ReLU as three Sequential entries."""
            if quant:
                return [QConvNorm(cin, cout, 3), nn.Identity(), nn.Identity()]
            return [Conv2d(cin, cout, 3, **ckw), make_norm(norm, cout, fold),
                    nn.ReLU()]

        self.shared_layers = nn.Sequential(*unit(in_channels, h), *unit(h, h))

        def branch(width: int, out: int) -> nn.Sequential:
            return nn.Sequential(*unit(h, width),
                                 Conv2d(width, out, 1, bias=True, **kw))

        self.heatmap_branch = branch(h, K)
        self.offset_branch = branch(h, 2 * K)
        self.variance_branch = branch(h // 2, K)
        self.subpixel_refine = _SubpixelRefine()
        self.fusion_weight = nn.Parameter(torch.tensor(0.5))

    def _unit(self, seq: nn.Sequential, at: int, x):
        """The ConvNorm at ``seq[at]`` (its norm and ReLU after it), its
        output recorded at ``{conv}.out_absmax``."""
        if self.quant:
            return seq[at](x)
        y = seq[at + 2](seq[at + 1](seq[at](x)))
        sow_absmax(seq[at], "out_absmax", y)
        return y

    def _branch(self, seq: nn.Sequential, f) -> torch.Tensor:
        return seq[3](dequantized(self._unit(seq, 0, f), self.compute_dtype))

    def forward(self, x) -> Dict[str, torch.Tensor]:
        f = self._unit(self.shared_layers, 3,
                       self._unit(self.shared_layers, 0, x))
        heatmaps = self._branch(self.heatmap_branch, f)
        offsets = self._branch(self.offset_branch, f)
        B, H, W, _ = offsets.shape
        return {
            "heatmaps": heatmaps.float(),
            "offsets": offsets.reshape(B, H, W, self.num_keypoints, 2).float(),
            "variances": F.softplus(
                self._branch(self.variance_branch, f).float()),
            "fusion_weight_logit": self.fusion_weight,
            "subpixel_alpha_logit": self.subpixel_refine.alpha,
        }


class FusedHead(nn.Module):
    """Stack-B fused head: a 1x1 heatmap conv ``hm``; a regression branch
    (``reg_conv``, a 3x3 ConvNorm of max(C / 2, 8) channels, global
    average pool, ``reg_fc`` to K x 2 coords normalised to [0, 1]); and an
    offset refinement (``refine_conv``, a 3x3 ConvNorm of C channels on
    the features concatenated with the heatmaps, ``refine_final`` 1x1 to
    K x 2): refined = coords + 0.1 x the offsets' spatial mean."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm"):
        super().__init__()
        C, K = in_channels, num_keypoints
        kw = dict(compute_dtype=compute_dtype)
        self.num_keypoints = K
        self.hm = Conv2d(C, K, 1, bias=True, **kw)
        hidden = max(C // 2, 8)
        self.reg_conv = conv_norm(C, hidden, 3, norm=norm, **kw)
        self.reg_fc = Linear(hidden, 2 * K, init="lecun", **kw)
        self.refine_conv = conv_norm(C + K, C, 3, norm=norm, **kw)
        self.refine_final = Conv2d(C, 2 * K, 1, bias=True, **kw)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        K = self.num_keypoints
        heatmaps = self.hm(x)
        r = self.reg_conv(x).mean(dim=(1, 2))  # global average pool
        coords = self.reg_fc(r).reshape(-1, K, 2).float()
        o = self.refine_conv(torch.cat([x, heatmaps.to(x.dtype)], dim=-1))
        offsets = self.refine_final(o)
        mean_off = offsets.mean(dim=(1, 2)).reshape(-1, K, 2)
        return {"heatmaps": heatmaps.float(), "coords": coords,
                "refined_coords": coords + 0.1 * mean_off.float()}


def feature_size(input_size: Tuple[int, int]) -> Tuple[int, int]:
    """(H, W) of a backbone's stride-4 features for an input of (W, H):
    two stride-2 3x3 convs with padding 1, ceil(ceil(n / 2) / 2)."""
    W, H = input_size
    return (math.ceil(math.ceil(H / 2) / 2), math.ceil(math.ceil(W / 2) / 2))


class SimCCHead(nn.Module):
    """SimCC head: ``kpt_conv`` (1x1 to K maps), each map flattened in
    (H, W) order, and ``fc_x``/``fc_y`` to W x split and H x split bins
    (``input_size`` is (W, H)).  The Linears need the flattened size, which
    JAX's Dense infers from its input: the stride-4 features of
    ``input_size`` (``feature_size``)."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 input_size: Tuple[int, int], split_ratio: float = 2.0,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        kw = dict(compute_dtype=compute_dtype)
        fh, fw = feature_size(input_size)
        self.kpt_conv = Conv2d(in_channels, num_keypoints, 1, bias=True, **kw)
        self.fc_x = Linear(fh * fw, int(input_size[0] * split_ratio),
                           init="lecun", **kw)
        self.fc_y = Linear(fh * fw, int(input_size[1] * split_ratio),
                           init="lecun", **kw)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.kpt_conv(x)
        B, H, W, K = feats.shape
        flat = feats.permute(0, 3, 1, 2).reshape(B, K, H * W)
        return {"simcc_x": self.fc_x(flat).float(),
                "simcc_y": self.fc_y(flat).float()}

    @staticmethod
    def decode(simcc_x: torch.Tensor, simcc_y: torch.Tensor,
               split_ratio: float = 2.0
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Softmax expectation over each axis: coords (B, K, 2) in input
        pixels (bins / split_ratio) and scores (B, K), the smaller of the
        two axes' peak probabilities."""
        px = torch.softmax(simcc_x.float(), dim=-1)
        py = torch.softmax(simcc_y.float(), dim=-1)
        xs = (px * torch.arange(px.shape[-1], dtype=torch.float32,
                                device=px.device)).sum(-1)
        ys = (py * torch.arange(py.shape[-1], dtype=torch.float32,
                                device=py.device)).sum(-1)
        coords = torch.stack([xs, ys], dim=-1) / split_ratio
        scores = torch.minimum(px.amax(-1), py.amax(-1))
        return coords, scores
