"""Gaussian heatmap targets, generated on the device for a whole batch.

Port of infantposeestimation_gaussianbias_tpu/ops/heatmap.py: closed-form
broadcasts over the (B, H, W, K) grid, no per-keypoint loop.  Heatmaps are
(B, H, W, K), as in the JAX package.
"""

from __future__ import annotations

from typing import Tuple

import torch


def generate_targets(keypoints: torch.Tensor, visible: torch.Tensor,
                     heatmap_size: Tuple[int, int],
                     input_size: Tuple[int, int], sigma: float = 2.0,
                     mode: str = "msra") -> Tuple[torch.Tensor, torch.Tensor]:
    """Gaussian heatmap targets and per-keypoint loss weights.

    keypoints (B, K, 2) in input-image pixels; visible (B, K) COCO flags
    (0/1/2); heatmap_size and input_size are (W, H); sigma in heatmap
    pixels.  ``mode``:
      "msra"  - the reference's clipped (6 sigma + 1)^2 window with its peak
                on an integer pixel (int() truncation reproduced);
      "exact" - a sub-pixel-centred Gaussian over the whole map.
    Returns targets (B, H, W, K) float32 and weights (B, K) float32: the
    visibility value, zeroed for invisible keypoints and for windows (msra)
    or centres (exact) off the map.
    """
    W, H = int(heatmap_size[0]), int(heatmap_size[1])
    stride_x = float(input_size[0]) / W
    stride_y = float(input_size[1]) / H
    kpts = keypoints.float()
    vis = visible.float()
    mu_x = kpts[..., 0] / stride_x  # (B, K) heatmap space
    mu_y = kpts[..., 1] / stride_y

    dev = kpts.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :, None]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None, None]

    def grid(t: torch.Tensor) -> torch.Tensor:  # (B, K) -> (B, 1, 1, K)
        return t[:, None, None, :]

    vis_ok = vis >= 0.5
    if mode == "msra":
        tmp = sigma * 3.0
        # The reference pastes into [ul, br) with ul = int(mu - tmp),
        # br = int(mu + tmp + 1), the window's peak at ul + (2 tmp + 1) // 2.
        half = float((2.0 * tmp + 1.0) // 2.0)
        ul_x = torch.trunc(mu_x - tmp)
        ul_y = torch.trunc(mu_y - tmp)
        br_x = torch.trunc(mu_x + tmp + 1.0)
        br_y = torch.trunc(mu_y + tmp + 1.0)
        g = torch.exp(-((xs - grid(ul_x + half)) ** 2
                        + (ys - grid(ul_y + half)) ** 2) / (2.0 * sigma ** 2))
        in_win = ((xs >= grid(ul_x)) & (xs < grid(br_x))
                  & (ys >= grid(ul_y)) & (ys < grid(br_y)))
        off_map = (ul_x >= W) | (ul_y >= H) | (br_x < 0) | (br_y < 0)
        weights = torch.where(vis_ok & ~off_map, vis, 0.0)
        paint = grid(vis_ok & ~off_map) & in_win
        targets = torch.where(paint, g, 0.0)
    elif mode == "exact":
        g = torch.exp(-((xs - grid(mu_x)) ** 2 + (ys - grid(mu_y)) ** 2)
                      / (2.0 * sigma ** 2))
        in_map = (mu_x >= 0) & (mu_x < W) & (mu_y >= 0) & (mu_y < H)
        weights = torch.where(vis_ok & in_map, vis, 0.0)
        targets = torch.where(grid(weights > 0), g, 0.0)
    else:
        raise ValueError(f"Unknown target mode {mode!r}")
    return targets.float(), weights.float()
