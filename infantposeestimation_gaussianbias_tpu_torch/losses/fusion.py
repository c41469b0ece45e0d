"""The six-term Gaussian-constraint fusion loss, as one function.

Port of infantposeestimation_gaussianbias_tpu/losses/fusion.py:

  L = w1 * L_heatmap  (visibility-weighted MSE)
    + w2 * L_offset   (SmoothL1 of offsets sampled at the soft-argmax vs
                       GT - soft-argmax)
    + w3 * L_peak     (squared L2 of soft-argmax coords vs GT)
    + w4 * L_variance (2nd-moment sigma and variance-branch mean vs sigma_t)
    + w5 * L_overlap  (skeleton-edge sigmoid-overlap hinge)
    + w6 * L_shape    (softmax entropy vs the analytic Gaussian entropy)

Every term is float32, whatever the model's compute dtype.  Layouts:
heatmaps and variances (B, H, W, K); offsets (B, H, W, K, 2); weights
(B, K); gt_keypoints (B, K, 2) in input-image pixels.

Every term is a ratio over the batch, sum(loss * w) / (sum(w) + 1e-8) or a
mean.  Under a process grid each data rank holds some of the batch rows;
``global_sum`` (a function summing a detached 0-d tensor over the data
ranks) then gives the global denominator, so that each rank's term is its
share of the global term and the shares add up to it (losses/fusion.py:
40-42 and 95 in the JAX package, over the global batch).  None: the batch
is the whole batch.
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Optional, Tuple

import torch

from ..ops import decode as decode_ops


def smooth_l1(pred: torch.Tensor, target: torch.Tensor,
              beta: float = 1.0) -> torch.Tensor:
    """Elementwise SmoothL1 (torch's default beta 1)."""
    d = (pred - target).abs()
    return torch.where(d < beta, 0.5 * d * d / beta, d - 0.5 * beta)


GlobalSum = Optional[Callable[[torch.Tensor], torch.Tensor]]


def _ratio(num: torch.Tensor, den: torch.Tensor,
           global_sum: GlobalSum) -> torch.Tensor:
    """num / (den + 1e-8), den summed over the data ranks under a grid."""
    if global_sum is not None:
        den = global_sum(den.detach())
    return num / (den + 1e-8)


def weighted_mean(per_kpt: torch.Tensor, weight: torch.Tensor,
                   global_sum: GlobalSum = None) -> torch.Tensor:
    """sum(loss * w) / (sum(w) + 1e-8) over all (B, K)."""
    return _ratio((per_kpt * weight).sum(), weight.sum(), global_sum)


def batch_mean(x: torch.Tensor, global_sum: GlobalSum = None
               ) -> torch.Tensor:
    """x.mean(); under a grid, x's sum over the global element count."""
    if global_sum is None:
        return x.mean()
    return x.sum() / global_sum(x.new_tensor(float(x.numel())))


def _pixel_grids(H: int, W: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
    """x and y pixel coordinates broadcast as (1, H, W, 1)."""
    xs = torch.arange(W, dtype=torch.float32, device=device)
    ys = torch.arange(H, dtype=torch.float32, device=device)
    return xs[None, None, :, None], ys[None, :, None, None]


def heatmap_mse(pred: torch.Tensor, target: torch.Tensor,
                weight: torch.Tensor, use_weight: bool = True,
                global_sum: GlobalSum = None) -> torch.Tensor:
    """Per-keypoint spatial-mean MSE, visibility-weighted."""
    per = ((pred.float() - target) ** 2).mean(dim=(1, 2))  # (B, K)
    if use_weight:
        return weighted_mean(per, weight, global_sum)
    return batch_mean(per, global_sum)


def heatmap_variance(heatmaps: torch.Tensor, coords: torch.Tensor
                     ) -> torch.Tensor:
    """Sigma from the second moment of the ReLU-normalised heatmap about
    coords.  Returns (B, K)."""
    B, H, W, K = heatmaps.shape
    pos = torch.relu(heatmaps.float())
    norm = pos / (pos.sum(dim=(1, 2), keepdim=True) + 1e-8)
    gx, gy = _pixel_grids(H, W, heatmaps.device)
    mx = coords[..., 0][:, None, None, :]
    my = coords[..., 1][:, None, None, :]
    var_x = (norm * (gx - mx) ** 2).sum(dim=(1, 2))
    var_y = (norm * (gy - my) ** 2).sum(dim=(1, 2))
    return torch.sqrt(var_x + var_y + 1e-8)


def variance_alignment_loss(heatmaps: torch.Tensor, coords: torch.Tensor,
                            weight: torch.Tensor,
                            variances: Optional[torch.Tensor],
                            target_sigma: float,
                            global_sum: GlobalSum = None) -> torch.Tensor:
    """(sigma_heatmap - sigma_t)^2 + (mean variance branch - sigma_t)^2,
    weighted."""
    per = (heatmap_variance(heatmaps, coords) - target_sigma) ** 2
    if variances is not None:
        sig_pred = variances.float().mean(dim=(1, 2))  # (B, K)
        per = per + (sig_pred - target_sigma) ** 2
    return weighted_mean(per, weight, global_sum)


def spatial_overlap_loss(heatmaps: torch.Tensor, weight: torch.Tensor,
                         skeleton: torch.Tensor,
                         threshold: float = 0.5,
                         global_sum: GlobalSum = None) -> torch.Tensor:
    """Per-edge min(sigmoid h_i, sigmoid h_j) overlap-ratio hinge over the
    (E, 2) skeleton edge table."""
    prob = torch.sigmoid(heatmaps.float())  # (B, H, W, K)
    hi = prob[..., skeleton[:, 0]]          # (B, H, W, E)
    hj = prob[..., skeleton[:, 1]]
    overlap = torch.minimum(hi, hj).sum(dim=(1, 2))  # (B, E)
    si = hi.sum(dim=(1, 2))
    sj = hj.sum(dim=(1, 2))
    ratio = overlap / (torch.minimum(si, sj) + 1e-8)
    penalty = torch.relu(ratio - threshold)
    vis = weight[:, skeleton[:, 0]] * weight[:, skeleton[:, 1]]  # (B, E)
    return _ratio((penalty * vis).sum(), vis.sum(), global_sum)


def distribution_shape_loss(heatmaps: torch.Tensor, weight: torch.Tensor,
                            target_sigma: float,
                            global_sum: GlobalSum = None) -> torch.Tensor:
    """Softmax entropy against the analytic 2D Gaussian entropy
    log(2 pi e sigma^2)."""
    B, H, W, K = heatmaps.shape
    probs = torch.softmax(heatmaps.float().reshape(B, H * W, K), dim=1)
    entropy = -(probs * torch.log(probs + 1e-8)).sum(dim=1)  # (B, K)
    target = math.log(2 * math.pi * math.e * target_sigma ** 2)
    return weighted_mean((entropy - target) ** 2, weight, global_sum)


def fusion_pose_loss(outputs: Dict[str, torch.Tensor],
                     target_heatmaps: torch.Tensor,
                     target_weight: torch.Tensor,
                     gt_keypoints: torch.Tensor,
                     skeleton: torch.Tensor,
                     input_size: Tuple[int, int] = (192, 256),
                     weights: Tuple[float, ...] = (1.0, 1.0, 0.5, 0.1, 0.05,
                                                   0.05),
                     target_sigma: float = 2.0,
                     use_target_weight: bool = True,
                     global_sum: GlobalSum = None
                     ) -> Dict[str, torch.Tensor]:
    """The six weighted terms and their sum ``total_loss``.  The offset
    target is GT (in heatmap pixels) minus the *current* soft-argmax
    (beta 1), the reference's self-referential contract."""
    heatmaps = outputs["heatmaps"]
    offsets = outputs["offsets"]
    variances = outputs.get("variances")
    B, H, W, K = heatmaps.shape
    w1, w2, w3, w4, w5, w6 = weights
    wt = target_weight.float()

    pred_coords, _ = decode_ops.soft_argmax(heatmaps, beta=1.0)
    scale = torch.tensor([W / input_size[0], H / input_size[1]],
                         dtype=torch.float32, device=heatmaps.device)
    gt_hm = gt_keypoints.float() * scale  # (B, K, 2) heatmap pixels

    sampled = decode_ops.sample_at_coords(offsets, pred_coords)  # (B, K, 2)
    off_per = smooth_l1(sampled, gt_hm - pred_coords).mean(dim=-1)
    peak_per = ((pred_coords - gt_hm) ** 2).sum(dim=-1)
    gs = global_sum
    if use_target_weight:
        l_off = weighted_mean(off_per, wt, gs)
        l_peak = weighted_mean(peak_per, wt, gs)
    else:
        l_off = batch_mean(off_per, gs)
        l_peak = batch_mean(peak_per, gs)

    losses = {
        "heatmap_loss": w1 * heatmap_mse(heatmaps, target_heatmaps, wt,
                                         use_target_weight, gs),
        "offset_loss": w2 * l_off,
        "peak_loss": w3 * l_peak,
        "variance_loss": w4 * variance_alignment_loss(
            heatmaps, pred_coords, wt, variances, target_sigma, gs),
        "overlap_loss": w5 * spatial_overlap_loss(heatmaps, wt, skeleton,
                                                  global_sum=gs),
        "shape_loss": w6 * distribution_shape_loss(heatmaps, wt,
                                                   target_sigma, gs),
    }
    losses["total_loss"] = sum(losses.values())
    return losses
