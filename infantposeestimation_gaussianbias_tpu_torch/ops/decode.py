"""Keypoint decoding and trajectory smoothing, batched on the device.

Port of the heatmap-head decodes (argmax, quarter shift, Taylor), the
fusion-path functions, the Stack-B fused decode (``fused_alpha_decode``),
the window-centroid refinement and the temporal
smoothers of infantposeestimation_gaussianbias_tpu/ops/decode.py.
Heatmaps are (B, H, W, K), trajectories (T, K, 2), and all maths runs in
float32.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def argmax_decode(heatmaps: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """coords (B, K, 2) of each map's maximum in heatmap pixels (x, y) and
    the maximum (B, K); a tie goes to the lowest row-major (H, W) index."""
    B, H, W, K = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(B, K, H * W)
    idx = torch.argmax(flat, dim=-1)
    maxvals = torch.take_along_dim(flat, idx[..., None], dim=-1)[..., 0]
    coords = torch.stack([(idx % W).float(), (idx // W).float()], dim=-1)
    return coords, maxvals


def _gather_hm(heatmaps: torch.Tensor, xi: torch.Tensor,
               yi: torch.Tensor) -> torch.Tensor:
    """heatmaps[b, y, x, k] at per-(b, k) integer coords (B, K), clamped
    to the map."""
    B, H, W, K = heatmaps.shape
    flat = heatmaps.permute(0, 3, 1, 2).reshape(B, K, H * W)
    lin = yi.clamp(0, H - 1) * W + xi.clamp(0, W - 1)
    return torch.take_along_dim(flat, lin[..., None], dim=-1)[..., 0]


def quarter_shift_decode(heatmaps: torch.Tensor
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax, then 0.25 px towards the larger neighbour on each axis
    (the sign of the central difference), strictly inside the border."""
    B, H, W, K = heatmaps.shape
    coords, maxvals = argmax_decode(heatmaps)
    xi, yi = coords[..., 0].long(), coords[..., 1].long()
    dx = _gather_hm(heatmaps, xi + 1, yi) - _gather_hm(heatmaps, xi - 1, yi)
    dy = _gather_hm(heatmaps, xi, yi + 1) - _gather_hm(heatmaps, xi, yi - 1)
    inside = (xi > 0) & (xi < W - 1) & (yi > 0) & (yi < H - 1)
    zero = torch.zeros((), device=heatmaps.device)
    shift = torch.stack([torch.where(inside, torch.sign(dx) * 0.25, zero),
                         torch.where(inside, torch.sign(dy) * 0.25, zero)],
                        dim=-1)
    return coords + shift, maxvals


def taylor_decode(heatmaps: torch.Tensor
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Argmax, then per axis d1 / (2 |d2|) clipped to +-0.5 (first and
    second central differences), where d2 < 0 and the peak lies at least
    2 px inside the low borders (1 < p < size - 1)."""
    B, H, W, K = heatmaps.shape
    coords, maxvals = argmax_decode(heatmaps)
    xi, yi = coords[..., 0].long(), coords[..., 1].long()
    c = _gather_hm(heatmaps, xi, yi)
    xr, xl = _gather_hm(heatmaps, xi + 1, yi), _gather_hm(heatmaps, xi - 1, yi)
    yd, yu = _gather_hm(heatmaps, xi, yi + 1), _gather_hm(heatmaps, xi, yi - 1)
    dx, dy = xr - xl, yd - yu
    dxx, dyy = xr - 2 * c + xl, yd - 2 * c + yu
    inside = (xi > 1) & (xi < W - 1) & (yi > 1) & (yi < H - 1)
    off_x = (dx / (2.0 * dxx.abs() + 1e-12)).clamp(-0.5, 0.5)
    off_y = (dy / (2.0 * dyy.abs() + 1e-12)).clamp(-0.5, 0.5)
    zero = torch.zeros((), device=heatmaps.device)
    shift = torch.stack([torch.where(inside & (dxx < 0), off_x, zero),
                         torch.where(inside & (dyy < 0), off_y, zero)],
                        dim=-1)
    return coords + shift, maxvals


def soft_argmax(heatmaps: torch.Tensor, beta: float = 1.0
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Softmax over the H*W grid of beta-scaled logits; coords (B, K, 2)
    are the expected pixel position, scores (B, K) the raw heatmap max."""
    B, H, W, K = heatmaps.shape
    logits = (heatmaps * beta).float().reshape(B, H * W, K)
    probs = torch.softmax(logits, dim=1).reshape(B, H, W, K)
    dev = heatmaps.device
    xs = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :, None]
    ys = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None, None]
    x = (probs * xs).sum(dim=(1, 2))
    y = (probs * ys).sum(dim=(1, 2))
    scores = heatmaps.amax(dim=(1, 2))
    return torch.stack([x, y], dim=-1), scores


def local_gaussian_refine(heatmaps: torch.Tensor, coarse: torch.Tensor,
                          radius: int = 2) -> torch.Tensor:
    """Softmax-weighted centroid over the (2r+1)^2 patch around the rounded
    coarse coordinate; taps outside the map carry zero weight."""
    B, H, W, K = heatmaps.shape
    r = radius
    dev = heatmaps.device
    # torch.round rounds half to even, as jnp.round does.
    px = torch.round(coarse[..., 0]).clamp(0, W - 1).long()  # (B, K)
    py = torch.round(coarse[..., 1]).clamp(0, H - 1).long()

    offs = torch.arange(-r, r + 1, device=dev)
    win_x = px[..., None] + offs                               # (B, K, w)
    win_y = py[..., None] + offs
    valid_x = (win_x >= 0) & (win_x < W)
    valid_y = (win_y >= 0) & (win_y < H)
    gx = win_x.clamp(0, W - 1)
    gy = win_y.clamp(0, H - 1)

    flat = heatmaps.permute(0, 3, 1, 2).reshape(B, K, H * W)
    lin = gy[..., :, None] * W + gx[..., None, :]              # (B, K, w, w)
    patches = torch.take_along_dim(flat, lin.reshape(B, K, -1), dim=-1)
    patches = patches.reshape(B, K, 2 * r + 1, 2 * r + 1)

    valid = valid_y[..., :, None] & valid_x[..., None, :]
    logits = torch.where(valid, patches.float(),
                         torch.tensor(float("-inf"), device=dev))
    w = torch.softmax(logits.reshape(B, K, -1), dim=-1)
    w = w.reshape(B, K, 2 * r + 1, 2 * r + 1)
    rx = (w * gx[..., None, :].float()).sum(dim=(-1, -2))
    ry = (w * gy[..., :, None].float()).sum(dim=(-1, -2))
    return torch.stack([rx, ry], dim=-1)


def subpixel_refine(heatmaps: torch.Tensor, alpha_logit: torch.Tensor,
                    beta: float = 1.0, radius: int = 2
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Soft-argmax and local Gaussian refinement blended by
    sigmoid(alpha)."""
    g_coords, scores = soft_argmax(heatmaps, beta=beta)
    l_coords = local_gaussian_refine(heatmaps, g_coords, radius=radius)
    a = torch.sigmoid(alpha_logit)
    return a * g_coords + (1.0 - a) * l_coords, scores


def sample_at_coords(maps: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Bilinear point-sample (B, H, W, K, C) per-keypoint maps at (B, K, 2)
    pixel coordinates, clamped to the map (grid_sample with border padding
    and align_corners=True).  Returns (B, K, C)."""
    B, H, W, K, C = maps.shape
    x = coords[..., 0].clamp(0.0, W - 1.0)
    y = coords[..., 1].clamp(0.0, H - 1.0)
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0i = x0.long()
    y0i = y0.long()
    x1i = (x0i + 1).clamp(0, W - 1)
    y1i = (y0i + 1).clamp(0, H - 1)

    flat = maps.permute(0, 3, 1, 2, 4).reshape(B, K, H * W, C)

    def tap(yi, xi):
        lin = (yi * W + xi)[..., None, None].expand(B, K, 1, C)
        return torch.gather(flat, 2, lin)[:, :, 0, :]

    return (tap(y0i, x0i) * (1 - fx) * (1 - fy) + tap(y0i, x1i) * fx * (1 - fy)
            + tap(y1i, x0i) * (1 - fx) * fy + tap(y1i, x1i) * fx * fy)


def fusion_decode(heatmaps: torch.Tensor, offsets: torch.Tensor,
                  alpha_logit: torch.Tensor, fusion_weight_logit: torch.Tensor,
                  beta: float = 1.0, radius: int = 2
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sub-pixel refinement, then coords += sigmoid(fusion_weight) times
    the offsets sampled at the coords."""
    coords, scores = subpixel_refine(heatmaps, alpha_logit, beta=beta,
                                     radius=radius)
    sampled = sample_at_coords(offsets, coords)
    return coords + torch.sigmoid(fusion_weight_logit) * sampled, scores


def flip_heatmaps(heatmaps: torch.Tensor, flip_index: torch.Tensor,
                  shift: bool = False) -> torch.Tensor:
    """Mirror (B, H, W, K) heatmaps horizontally and swap the mirrored
    keypoint channels; ``shift`` applies the 1 px SHIFT_HEATMAP correction."""
    out = torch.flip(heatmaps, dims=[2])[..., flip_index]
    if shift:
        out = torch.cat([out[:, :, :1, :], out[:, :, :-1, :]], dim=2)
    return out


def transform_preds(coords: torch.Tensor, centers: torch.Tensor,
                    scales: torch.Tensor, output_size) -> torch.Tensor:
    """Back-project (B, K, 2) crop-space coords to the source image:
    coord / output_size * scale + center - scale / 2."""
    osz = torch.tensor(output_size, dtype=torch.float32, device=coords.device)
    return (coords / osz * scales[:, None, :] + centers[:, None, :]
            - scales[:, None, :] / 2.0)


def fused_alpha_decode(heatmaps: torch.Tensor,
                       regression_coords: Optional[torch.Tensor] = None,
                       alpha: float = 0.5, image_size: float = 256.0,
                       adaptive: bool = True
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stack-B fused decode: Taylor heatmap coords scaled to image space
    (``image_size`` / the map's side), blended with the regression coords
    (given normalised to [0, 1], scaled by ``image_size``) by ``alpha``;
    with ``adaptive`` the blend's alpha is maxval / (maxval + 0.1) per
    keypoint instead, as the reference overwrites it.  Without regression
    coords, the scaled heatmap coords.  Returns coords (B, K, 2) in image
    space and maxvals (B, K)."""
    B, H, W, K = heatmaps.shape
    hm_coords, maxvals = taylor_decode(heatmaps)
    hm_coords = hm_coords * torch.tensor(
        [image_size / W, image_size / H], dtype=torch.float32,
        device=heatmaps.device)
    if regression_coords is None:
        return hm_coords, maxvals
    reg = regression_coords * image_size
    a = (maxvals / (maxvals + 0.1))[..., None] if adaptive else alpha
    return a * hm_coords + (1.0 - a) * reg, maxvals


def window_centroid_refine(heatmaps: torch.Tensor, coords: torch.Tensor,
                           window_size: int = 5) -> torch.Tensor:
    """Weighted centroid of the raw heatmap values in a window around
    each (truncated) coordinate, the window cut at the borders."""
    B, H, W, K = heatmaps.shape
    r = window_size // 2
    px = coords[..., 0].to(torch.int64)  # int() truncation
    py = coords[..., 1].to(torch.int64)
    offs = torch.arange(-r, r + 1, device=heatmaps.device)
    win_x, win_y = px[..., None] + offs, py[..., None] + offs
    valid = (((win_y >= 0) & (win_y < H))[..., :, None]
             & ((win_x >= 0) & (win_x < W))[..., None, :])
    gx, gy = win_x.clamp(0, W - 1), win_y.clamp(0, H - 1)
    flat = heatmaps.permute(0, 3, 1, 2).reshape(B, K, H * W)
    lin = gy[..., :, None] * W + gx[..., None, :]
    patches = torch.take_along_dim(flat, lin.reshape(B, K, -1), dim=-1)
    patches = torch.where(valid, patches.reshape(B, K, window_size,
                                                 window_size), 0.0)
    w = patches / (patches.sum(dim=(-1, -2), keepdim=True) + 1e-8)
    rx = (w * gx[..., None, :].float()).sum(dim=(-1, -2))
    ry = (w * gy[..., :, None].float()).sum(dim=(-1, -2))
    return torch.stack([rx, ry], dim=-1)


def temporal_smooth(coords_seq: torch.Tensor, window_size: int = 5,
                    method: str = "gaussian", fps: float = 30.0
                    ) -> torch.Tensor:
    """Smooth a (T, K, 2) trajectory over time: "gaussian" (the
    reference's one-sided kernel exp(-i^2 / 2 sigma^2), i = 0..w-1, sigma =
    w / 3) or "moving_average", each a full convolution of the edge-padded
    sequence as ``np.convolve(..., "valid")``; "one_euro" is
    ``one_euro_smooth``."""
    if method == "one_euro":
        return one_euro_smooth(coords_seq, fps=fps)
    T, K, D = coords_seq.shape
    if method == "gaussian":
        sig = window_size / 3.0
        kernel = np.exp(-np.arange(window_size) ** 2 / (2 * sig ** 2))
        kernel = kernel / kernel.sum()
    else:
        kernel = np.ones(window_size) / window_size
    # a convolution flips its kernel; conv1d correlates
    kern = torch.tensor(kernel[::-1].copy(), dtype=torch.float32,
                        device=coords_seq.device)
    half = window_size // 2
    traj = coords_seq.float().reshape(T, K * D).t()[:, None, :]
    padded = F.pad(traj, (half, half), mode="replicate")
    sm = F.conv1d(padded, kern[None, None, :])[:, 0, :]   # (K*D, T)
    return sm.t().reshape(T, K, D)


def one_euro_smooth(coords_seq: torch.Tensor, fps: float = 30.0,
                    min_cutoff: float = 1.0, beta: float = 0.007,
                    d_cutoff: float = 1.0) -> torch.Tensor:
    """One-Euro filter over a (T, K, 2) trajectory, causal: the cutoff
    rises with the smoothed speed, so slow jitter is damped and fast
    motion follows."""
    dt = 1.0 / fps

    def alpha(cutoff):
        tau = 1.0 / (2.0 * math.pi * cutoff)
        return 1.0 / (1.0 + tau / dt)

    x_prev = coords_seq[0].float()
    dx_prev = torch.zeros_like(x_prev)
    out = [x_prev]
    a_d = alpha(d_cutoff)
    for x in coords_seq[1:].float():
        dx_hat = a_d * ((x - x_prev) / dt) + (1 - a_d) * dx_prev
        a = alpha(min_cutoff + beta * dx_hat.abs())
        x_prev = a * x + (1 - a) * x_prev
        dx_prev = dx_hat
        out.append(x_prev)
    return torch.stack(out)
