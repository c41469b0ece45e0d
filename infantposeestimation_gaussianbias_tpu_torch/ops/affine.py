"""Affine crop geometry and the batched axis-aligned crop warp.

Port of the unrotated path of
infantposeestimation_gaussianbias_tpu/ops/affine.py.  ``center`` and
``scale`` are (x, y) pixels, ``output_size`` is (width, height), and
matrices are 2x3 forward maps dst = M @ [src, 1].  The rotated two-pass
warp is not ported yet.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def get_affine_matrix(center: torch.Tensor, scale: torch.Tensor,
                      output_size: Tuple[int, int]) -> torch.Tensor:
    """Forward (..., 2, 3) unrotated matrix mapping source-image to crop
    pixels: the zoom s = dst_w / scale[0], with ``center`` moved to the
    crop centre."""
    center = center.float()
    scale = scale.float()
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    # a true division: python-float / tensor would multiply by a reciprocal
    s = torch.div(scale.new_tensor(dst_w), scale[..., 0])
    zero = torch.zeros_like(s)
    tx = dst_w * 0.5 - s * center[..., 0]
    ty = dst_h * 0.5 - s * center[..., 1]
    row0 = torch.stack([s, zero, tx], dim=-1)
    row1 = torch.stack([zero, s, ty], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def invert_affine(mat: torch.Tensor) -> torch.Tensor:
    """Invert a (..., 2, 3) affine matrix."""
    a, b, tx = mat[..., 0, 0], mat[..., 0, 1], mat[..., 0, 2]
    c, d, ty = mat[..., 1, 0], mat[..., 1, 1], mat[..., 1, 2]
    det = a * d - b * c
    ia, ib = d / det, -b / det
    ic, id_ = -c / det, a / det
    itx = -(ia * tx + ib * ty)
    ity = -(ic * tx + id_ * ty)
    row0 = torch.stack([ia, ib, itx], dim=-1)
    row1 = torch.stack([ic, id_, ity], dim=-1)
    return torch.stack([row0, row1], dim=-2)


def _axis_weights(inv_scale: torch.Tensor, inv_offset: torch.Tensor,
                  out_size: int, src_size: int) -> torch.Tensor:
    """(B, out, src) bilinear resampling matrix; taps outside the source
    get zero weight (cv2's BORDER_CONSTANT 0)."""
    dev = inv_scale.device
    dst = torch.arange(out_size, dtype=torch.float32, device=dev)
    src = inv_scale[:, None] * dst[None, :] + inv_offset[:, None]
    grid = torch.arange(src_size, dtype=torch.float32, device=dev)
    return F.relu(1.0 - (src[:, :, None] - grid[None, None, :]).abs())


def warp_affine_separable(imgs: torch.Tensor, mats: torch.Tensor,
                          out_w: int, out_h: int) -> torch.Tensor:
    """Bilinear warp of (B, H, W, C) images by axis-aligned forward
    matrices as two batched products, out = W_y @ img @ W_x^T (float32)."""
    B, H, W, C = imgs.shape
    inv = invert_affine(mats)
    wy = _axis_weights(inv[:, 1, 1], inv[:, 1, 2], out_h, H)  # (B, out_h, H)
    wx = _axis_weights(inv[:, 0, 0], inv[:, 0, 2], out_w, W)  # (B, out_w, W)
    tmp = torch.einsum("boh,bhwc->bowc", wy, imgs.float())
    return torch.einsum("bpw,bowc->bopc", wx, tmp)


def crop_and_normalize(imgs: torch.Tensor, centers: torch.Tensor,
                       scales: torch.Tensor, output_size: Tuple[int, int],
                       mean: Tuple[float, float, float] = (0.485, 0.456,
                                                           0.406),
                       std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
                       ) -> torch.Tensor:
    """Unrotated crop + /255 + ImageNet normalisation of (B, H, W, 3)
    frames (any dtype) to float32 NHWC crops."""
    out_w, out_h = int(output_size[0]), int(output_size[1])
    mats = get_affine_matrix(centers, scales, output_size)
    crops = warp_affine_separable(imgs, mats, out_w, out_h)
    dev = crops.device
    mean_a = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    std_a = torch.tensor(std, dtype=torch.float32, device=dev) * 255.0
    return (crops - mean_a) / std_a
