"""Losses: the six-term fusion loss, the Stack-B morphology and combined
losses, and the weighted heatmap MSE."""

from typing import Optional

import torch

from .fusion import (GlobalSum, batch_mean, distribution_shape_loss,
                     fusion_pose_loss, heatmap_mse, heatmap_variance,
                     smooth_l1, spatial_overlap_loss,
                     variance_alignment_loss, weighted_mean)
from .morphology import (combined_loss, fused_pose_loss, joints_mse_loss,
                         morphology_shape_loss, offset_regression_loss,
                         spatial_statistics)


def keypoint_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                      weight: Optional[torch.Tensor] = None,
                      use_target_weight: bool = True,
                      global_sum: GlobalSum = None) -> torch.Tensor:
    """Weight-multiplied mean MSE, mean((pred*w - target*w)^2) over all
    elements, in float32; pred and target (B, H, W, K), weight (B, K).
    ``global_sum``: see losses/fusion.py (the mean over a grid's global
    batch)."""
    p = pred.float()
    t = target.float()
    if use_target_weight and weight is not None:
        w = weight[:, None, None, :]
        p = p * w
        t = t * w
    return batch_mean((p - t) ** 2, global_sum)


__all__ = [
    "combined_loss",
    "distribution_shape_loss",
    "fused_pose_loss",
    "fusion_pose_loss",
    "heatmap_mse",
    "heatmap_variance",
    "joints_mse_loss",
    "keypoint_mse_loss",
    "morphology_shape_loss",
    "offset_regression_loss",
    "smooth_l1",
    "spatial_overlap_loss",
    "spatial_statistics",
    "variance_alignment_loss",
    "weighted_mean",
]
