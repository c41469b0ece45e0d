"""Prediction heads on NHWC features: the plain heatmap head and the
3-branch fusion head.

Ports of HeatmapHead and FusionHead in
infantposeestimation_gaussianbias_tpu/models/heads.py, named as the
reference's state dicts: ``final_layer`` (HeatmapHead); ``shared_layers``,
``heatmap_branch``, ``offset_branch``, ``variance_branch``,
``fusion_weight``, ``subpixel_refine.alpha`` (``HeatmapRegressionHead``).

Outputs are float32 and NHWC: heatmaps (B, H, W, K), offsets
(B, H, W, K, 2), variances (B, H, W, K).
"""

from __future__ import annotations

from typing import Dict

import torch
import torch.nn as nn
import torch.nn.functional as F

from .layers import Conv2d, make_norm


class HeatmapHead(nn.Module):
    """One 1x1 prediction conv with bias: the path ``build_model`` builds
    (no deconv stack, ``num_deconv_layers=0``)."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 compute_dtype: torch.dtype = torch.float32):
        super().__init__()
        self.final_layer = Conv2d(in_channels, num_keypoints, 1, bias=True,
                                  compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
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
    hidden ConvNorms (models/fold.py)."""

    def __init__(self, in_channels: int, num_keypoints: int,
                 hidden_dim: int = 256,
                 compute_dtype: torch.dtype = torch.float32,
                 norm: str = "batchnorm", fold: bool = False):
        super().__init__()
        h, K = hidden_dim, num_keypoints
        kw = dict(compute_dtype=compute_dtype)
        ckw = dict(bias=fold, **kw)
        self.num_keypoints = K
        self.shared_layers = nn.Sequential(
            Conv2d(in_channels, h, 3, **ckw), make_norm(norm, h, fold),
            nn.ReLU(), Conv2d(h, h, 3, **ckw), make_norm(norm, h, fold),
            nn.ReLU())

        def branch(width: int, out: int) -> nn.Sequential:
            return nn.Sequential(Conv2d(h, width, 3, **ckw),
                                 make_norm(norm, width, fold),
                                 nn.ReLU(), Conv2d(width, out, 1, bias=True,
                                                   **kw))

        self.heatmap_branch = branch(h, K)
        self.offset_branch = branch(h, 2 * K)
        self.variance_branch = branch(h // 2, K)
        self.subpixel_refine = _SubpixelRefine()
        self.fusion_weight = nn.Parameter(torch.tensor(0.5))

    def forward(self, x: torch.Tensor) -> Dict[str, torch.Tensor]:
        f = self.shared_layers(x)
        heatmaps = self.heatmap_branch(f)
        offsets = self.offset_branch(f)
        B, H, W, _ = offsets.shape
        return {
            "heatmaps": heatmaps.float(),
            "offsets": offsets.reshape(B, H, W, self.num_keypoints, 2).float(),
            "variances": F.softplus(self.variance_branch(f).float()),
            "fusion_weight_logit": self.fusion_weight,
            "subpixel_alpha_logit": self.subpixel_refine.alpha,
        }
