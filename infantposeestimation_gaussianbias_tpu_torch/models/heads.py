"""Prediction heads on NHWC features: the plain heatmap head and the
3-branch fusion head.

Ports of HeatmapHead and FusionHead in
infantposeestimation_gaussianbias_tpu/models/heads.py, named as the
reference's state dicts: ``final_layer`` (HeatmapHead); ``shared_layers``,
``heatmap_branch``, ``offset_branch``, ``variance_branch``,
``fusion_weight``, ``subpixel_refine.alpha`` (``HeatmapRegressionHead``).

Outputs are float32 and NHWC: heatmaps (B, H, W, K), offsets
(B, H, W, K, 2), variances (B, H, W, K).

int8 PTQ (an int8 HRNet hands over a QTensor): HeatmapHead dequantizes
into the compute dtype; FusionHead's hidden ConvNorms are QConvNorms on K9
(``quant``), and its 1x1 finals run in the compute dtype on the
dequantized maps, as the JAX package's heads.
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from ..ops.quant import QTensor
from .layers import Conv2d, QConvNorm, make_norm, sow_absmax


def dequantized(x, dtype: torch.dtype) -> torch.Tensor:
    """A QTensor dequantized into ``dtype``; any other input as it is."""
    return x.dequantize(dtype) if isinstance(x, QTensor) else x


class HeatmapHead(nn.Module):
    """One 1x1 prediction conv with bias: the path ``build_model`` builds
    (no deconv stack, ``num_deconv_layers=0``)."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.compute_dtype = compute_dtype
        self.final_layer = Conv2d(in_channels, num_keypoints, 1, bias=True,
                                  compute_dtype=compute_dtype)

    def forward(self, x) -> Dict[str, torch.Tensor]:
        x = dequantized(x, self.compute_dtype)
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
