"""Affine crop geometry and the batched crop warps.

Port of infantposeestimation_gaussianbias_tpu/ops/affine.py.  ``center``
and ``scale`` are (x, y) pixels, ``output_size`` is (width, height), and
matrices are 2x3 forward maps dst = M @ [src, 1].  The warps are bilinear
with out-of-range taps contributing zero (cv2.warpAffine INTER_LINEAR,
BORDER_CONSTANT 0); an unrotated crop is two batched products
(``warp_affine_separable``), a rotated one two single-axis resample passes
(``warp_affine_twopass``) with a per-sample fallback to the joint 4-tap
gather (``warp_affine_batch``) past a shear of 2.  Geometry and warps
stay float32 on purpose: a bf16 product would lose ~0.5 px on image-sized
coordinates.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch
import torch.nn.functional as F

# The largest per-column vertical shear |ic / ia| (|tan(rot)| for a
# rotation) the two-pass warp takes (|rot| up to ~63 deg); samples beyond
# it, the +-90 deg NaN zone included, take the joint gather.
_TWOPASS_MAX_SHEAR = 2.0


def get_affine_matrix(center: torch.Tensor, scale: torch.Tensor,
                      output_size: Tuple[int, int],
                      rot_deg: Union[torch.Tensor, float] = 0.0
                      ) -> torch.Tensor:
    """Forward (..., 2, 3) matrix mapping source-image to crop pixels: a
    rotation by ``rot_deg`` about ``center``, the zoom s = dst_w /
    scale[0], and ``center`` moved to the crop centre,
    dst = s R(-theta) (src - center) + (dst_w / 2, dst_h / 2)."""
    center = center.float()
    scale = scale.float()
    rot = torch.as_tensor(rot_deg, dtype=torch.float32, device=center.device)
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    # a true division: python-float / tensor would multiply by a reciprocal
    s = torch.div(scale.new_tensor(dst_w), scale[..., 0])
    theta = rot * (math.pi / 180.0)
    a = s * torch.cos(theta)
    b = s * torch.sin(theta)
    cx, cy = center[..., 0], center[..., 1]
    tx = dst_w * 0.5 - (a * cx + b * cy)
    ty = dst_h * 0.5 - (-b * cx + a * cy)
    row0 = torch.stack(torch.broadcast_tensors(a, b, tx), dim=-1)
    row1 = torch.stack(torch.broadcast_tensors(-b, a, ty), dim=-1)
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


def transform_points(points: torch.Tensor, mat: torch.Tensor
                     ) -> torch.Tensor:
    """Apply (..., 2, 3) matrices to (..., N, 2) points, elementwise in
    float32 (no product on the tensor cores)."""
    x, y = points[..., 0], points[..., 1]
    m = mat[..., None, :, :]  # broadcast over the points
    nx = m[..., 0, 0] * x + m[..., 0, 1] * y + m[..., 0, 2]
    ny = m[..., 1, 0] * x + m[..., 1, 1] * y + m[..., 1, 2]
    return torch.stack([nx, ny], dim=-1)


def _warp_joint(imgs: torch.Tensor, inv: torch.Tensor, out_w: int,
                out_h: int) -> torch.Tensor:
    """Bilinear warp of (B, H, W, C) float images by dst->src matrices
    ``inv``: four taps gathered at each output pixel."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    dst_y, dst_x = torch.meshgrid(
        torch.arange(out_h, dtype=torch.float32, device=dev),
        torch.arange(out_w, dtype=torch.float32, device=dev), indexing="ij")
    m = inv[:, :, :, None, None]  # (B, 2, 3, 1, 1)
    src_x = m[:, 0, 0] * dst_x + m[:, 0, 1] * dst_y + m[:, 0, 2]
    src_y = m[:, 1, 0] * dst_x + m[:, 1, 1] * dst_y + m[:, 1, 2]
    x0, y0 = torch.floor(src_x), torch.floor(src_y)
    fx, fy = src_x - x0, src_y - y0
    x0i, y0i = x0.long(), y0.long()
    flat = imgs.reshape(B, H * W, C)

    def tap(yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
        valid = (xi >= 0) & (xi < W) & (yi >= 0) & (yi < H)
        lin = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
        vals = flat.gather(1, lin.reshape(B, -1, 1).expand(-1, -1, C))
        return vals.reshape(B, out_h, out_w, C) * valid[..., None]

    w00 = ((1 - fx) * (1 - fy))[..., None]
    w01 = (fx * (1 - fy))[..., None]
    w10 = ((1 - fx) * fy)[..., None]
    w11 = (fx * fy)[..., None]
    return (tap(y0i, x0i) * w00 + tap(y0i, x0i + 1) * w01
            + tap(y0i + 1, x0i) * w10 + tap(y0i + 1, x0i + 1) * w11)


def warp_affine_batch(imgs: torch.Tensor, mats: torch.Tensor, out_w: int,
                      out_h: int) -> torch.Tensor:
    """Warp (B, H, W, C) images by per-sample forward matrices (rotation
    included): the joint 4-tap bilinear gather, float32."""
    return _warp_joint(imgs.float(), invert_affine(mats), out_w, out_h)


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


def _lerp_taps_along(x: torch.Tensor, src: torch.Tensor, axis: int,
                     size: int) -> torch.Tensor:
    """2-tap bilinear resample of ``x`` (B, ..., C) along ``axis`` at
    positions ``src`` (x's shape without C, ``axis`` resized), taps out of
    range contributing zero."""
    i0 = torch.floor(src)
    f = (src - i0)[..., None]
    i0 = i0.long()
    C = x.shape[-1]

    def tap(idx: torch.Tensor) -> torch.Tensor:
        valid = (idx >= 0) & (idx < size)
        idx = idx.clamp(0, size - 1)[..., None].expand(*idx.shape, C)
        return torch.gather(x, axis, idx) * valid[..., None]

    return tap(i0) * (1.0 - f) + tap(i0 + 1) * f


def warp_affine_twopass(imgs: torch.Tensor, mats: torch.Tensor, out_w: int,
                        out_h: int) -> torch.Tensor:
    """General batched warp (rotation included) as two single-axis
    resample passes, the JAX package's Catmull-Smith decomposition: for the
    dst->src inverse [[ia, ib, itx], [ic, id, ity]], pass 1 resamples each
    source column j vertically at s y + u j + v (u = ic / ia, s = id -
    ib ic / ia, v = ity - u itx), pass 2 each row horizontally at ia x + ib
    y + itx.  The positions are exact; the bilinear footprint is a sheared
    parallelogram when u != 0.  Samples with |u| > 2 (or NaN, at |rot| =
    90 deg) take the joint gather instead."""
    B, H, W, C = imgs.shape
    imgs = imgs.float()
    inv = invert_affine(mats)
    ia, ib, itx = inv[:, 0, 0], inv[:, 0, 1], inv[:, 0, 2]
    ic, id_, ity = inv[:, 1, 0], inv[:, 1, 1], inv[:, 1, 2]
    u = ic / ia
    s = id_ - ib * ic / ia
    v = ity - u * itx
    dev = imgs.device
    ys = torch.arange(out_h, dtype=torch.float32, device=dev)
    xs = torch.arange(out_w, dtype=torch.float32, device=dev)
    js = torch.arange(W, dtype=torch.float32, device=dev)
    src_y = (s[:, None, None] * ys[None, :, None]
             + u[:, None, None] * js[None, None, :] + v[:, None, None])
    tmp = _lerp_taps_along(imgs, src_y, 1, H)          # (B, out_h, W, C)
    src_x = (ia[:, None, None] * xs[None, None, :]
             + ib[:, None, None] * ys[None, :, None] + itx[:, None, None])
    two_pass = _lerp_taps_along(tmp, src_x, 2, W)      # (B, out_h, out_w, C)
    bad = ~(u.abs() <= _TWOPASS_MAX_SHEAR)
    if not bool(bad.any()):
        return two_pass
    joint = _warp_joint(imgs, inv, out_w, out_h)
    return torch.where(bad[:, None, None, None], joint, two_pass)


def crop_and_normalize(imgs: torch.Tensor, centers: torch.Tensor,
                       scales: torch.Tensor, output_size: Tuple[int, int],
                       rots: Optional[torch.Tensor] = None,
                       mean: Tuple[float, float, float] = (0.485, 0.456,
                                                           0.406),
                       std: Tuple[float, float, float] = (0.229, 0.224, 0.225)
                       ) -> torch.Tensor:
    """Crop + /255 + ImageNet normalisation of (B, H, W, 3) frames (any
    dtype) to float32 NHWC crops: the separable warp without ``rots``, the
    two-pass warp with per-sample rotations ``rots`` (degrees)."""
    out_w, out_h = int(output_size[0]), int(output_size[1])
    if rots is None:
        mats = get_affine_matrix(centers, scales, output_size)
        crops = warp_affine_separable(imgs, mats, out_w, out_h)
    else:
        mats = get_affine_matrix(centers, scales, output_size, rots)
        crops = warp_affine_twopass(imgs, mats, out_w, out_h)
    dev = crops.device
    mean_a = torch.tensor(mean, dtype=torch.float32, device=dev) * 255.0
    std_a = torch.tensor(std, dtype=torch.float32, device=dev) * 255.0
    return (crops - mean_a) / std_a
