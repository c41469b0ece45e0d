"""Stack-B losses: the morphology shape loss and the combined infant loss.

Port of infantposeestimation_gaussianbias_tpu/losses/morphology.py:

* weighted heatmap MSE / SmoothL1        (``fused_pose_loss``)
* the morphology shape loss, the paper's key innovation: the squared
  difference of the spatial variance (and mean) of the sum-normalised
  predicted and target heatmaps          (``morphology_shape_loss``)
* coordinate regression SmoothL1 / L1 / MSE (``offset_regression_loss``)
* the classic per-joint 0.5 MSE          (``joints_mse_loss``)
* combined = heatmap + w_morph morph + w_reg (regression + refined)
                                         (``combined_loss``)

Every term is float32 and a mean over the batch rows.  Layouts: heatmaps
(B, H, W, K); weights (B, K); coords (B, K, 2) normalised to [0, 1].
``global_sum`` as in losses/fusion.py: under a process grid each data
rank's term is its rows' sum over the global element count.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from .fusion import GlobalSum, batch_mean, smooth_l1


def fused_pose_loss(pred: torch.Tensor, target: torch.Tensor,
                    weight: Optional[torch.Tensor] = None,
                    loss_type: str = "mse",
                    global_sum: GlobalSum = None) -> torch.Tensor:
    """Per-pixel MSE (or SmoothL1), times the keypoint's weight, mean over
    everything."""
    p, t = pred.float(), target.float()
    per = (p - t) ** 2 if loss_type == "mse" else smooth_l1(p, t)
    if weight is not None:
        per = per * weight[:, None, None, :]
    return batch_mean(per, global_sum)


def spatial_statistics(heatmaps: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Spatial mean and variance, each (B, K, 2) as (x, y), of the
    heatmaps normalised to sum to 1 (plus 1e-8) over (H, W)."""
    B, H, W, K = heatmaps.shape
    h = heatmaps.float()
    prob = h / (h.sum(dim=(1, 2), keepdim=True) + 1e-8)
    dev = heatmaps.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :, None]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None, None]
    mean_x = (prob * xs).sum(dim=(1, 2))
    mean_y = (prob * ys).sum(dim=(1, 2))
    var_x = (prob * (xs - mean_x[:, None, None, :]) ** 2).sum(dim=(1, 2))
    var_y = (prob * (ys - mean_y[:, None, None, :]) ** 2).sum(dim=(1, 2))
    return (torch.stack([mean_x, mean_y], dim=-1),
            torch.stack([var_x, var_y], dim=-1))


def morphology_shape_loss(pred: torch.Tensor, target: torch.Tensor,
                          weight: Optional[torch.Tensor] = None,
                          lambda_variance: float = 1.0,
                          lambda_mean: float = 0.5,
                          global_sum: GlobalSum = None) -> torch.Tensor:
    """mean(lambda_var (Var(P) - Var(T))^2 + lambda_mean (Mu(P) -
    Mu(T))^2), each keypoint's (x, y) pair times its weight."""
    p_mean, p_var = spatial_statistics(pred)
    t_mean, t_var = spatial_statistics(target)
    per = (lambda_variance * (p_var - t_var) ** 2
           + lambda_mean * (p_mean - t_mean) ** 2)  # (B, K, 2)
    if weight is not None:
        per = per * weight[:, :, None]
    return batch_mean(per, global_sum)


def offset_regression_loss(pred_coords: torch.Tensor,
                           target_coords: torch.Tensor,
                           weight: Optional[torch.Tensor] = None,
                           loss_type: str = "smoothl1",
                           global_sum: GlobalSum = None) -> torch.Tensor:
    """SmoothL1 (or L1, or else MSE) of (B, K, 2) coords, times the
    keypoint's weight, mean over everything."""
    p, t = pred_coords.float(), target_coords.float()
    if loss_type == "smoothl1":
        per = smooth_l1(p, t)
    elif loss_type == "l1":
        per = (p - t).abs()
    else:
        per = (p - t) ** 2
    if weight is not None:
        per = per * weight[:, :, None]
    return batch_mean(per, global_sum)


def joints_mse_loss(pred: torch.Tensor, target: torch.Tensor,
                    weight: torch.Tensor, use_target_weight: bool = True,
                    global_sum: GlobalSum = None) -> torch.Tensor:
    """The classic per-joint 0.5 MSE of the weight-multiplied maps,
    averaged over the joints: 0.5 x the mean over (B, H W, K)."""
    B, H, W, K = pred.shape
    p = pred.float().reshape(B, H * W, K)
    t = target.float().reshape(B, H * W, K)
    if use_target_weight:
        p = p * weight[:, None, :]
        t = t * weight[:, None, :]
    return 0.5 * batch_mean((p - t) ** 2, global_sum)


def combined_loss(predictions: Dict[str, torch.Tensor],
                  targets: Dict[str, torch.Tensor],
                  morph_weight: float = 0.1, morph_lambda: float = 1.0,
                  morph_mean_lambda: float = 0.5, reg_weight: float = 0.5,
                  global_sum: GlobalSum = None
                  ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The combined Stack-B training loss and its terms (``heatmap``,
    ``morph``, ``regression`` and ``refined`` where the predictions hold
    coords, ``total``).  predictions: heatmaps (B, H, W, K) [+ coords,
    refined_coords (B, K, 2)]; targets: heatmaps, weights (B, K) [+ coords
    (B, K, 2) normalised]."""
    weight = targets.get("weights")
    losses: Dict[str, torch.Tensor] = {}
    losses["heatmap"] = fused_pose_loss(predictions["heatmaps"],
                                        targets["heatmaps"], weight,
                                        global_sum=global_sum)
    losses["morph"] = morphology_shape_loss(
        predictions["heatmaps"], targets["heatmaps"], weight,
        lambda_variance=morph_lambda, lambda_mean=morph_mean_lambda,
        global_sum=global_sum)
    total = losses["heatmap"] + morph_weight * losses["morph"]
    for key, name in (("coords", "regression"),
                      ("refined_coords", "refined")):
        if key in predictions and "coords" in targets:
            losses[name] = offset_regression_loss(
                predictions[key], targets["coords"], weight,
                global_sum=global_sum)
            total = total + reg_weight * losses[name]
    losses["total"] = total
    return total, losses
