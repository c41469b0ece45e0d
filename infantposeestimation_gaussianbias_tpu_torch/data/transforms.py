"""Top-down augmentation: flip, vertical flip, half-body and
scale/rotate/shift, composed into one 2x3 affine matrix per sample.

Port of infantposeestimation_gaussianbias_tpu/data/transforms.py (numpy).
Every geometric augmentation composes into a single crop matrix, so each
sample is warped once (cv2.warpAffine or the native decode+warp); a
horizontal flip of the source image is x' = (img_w - 1) - x folded into
the matrix, with the symmetric joints swapped.  Each sample's RNG comes
from (seed, epoch, index) (data/pipeline.py), so the port's samples are
the JAX package's bit for bit.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np

from ..schemas import KeypointSchema


def affine_matrix_np(center, scale, output_size, rot_deg=0.0) -> np.ndarray:
    """Forward 2x3 matrix, numpy twin of ops.affine.get_affine_matrix."""
    src_w = float(scale[0])
    dst_w, dst_h = float(output_size[0]), float(output_size[1])
    theta = np.deg2rad(rot_deg)
    s = dst_w / src_w
    a, b = s * np.cos(theta), s * np.sin(theta)
    cx, cy = float(center[0]), float(center[1])
    return np.array([
        [a, b, dst_w * 0.5 - (a * cx + b * cy)],
        [-b, a, dst_h * 0.5 - (-b * cx + a * cy)],
    ], np.float32)


def compose_flip(mat: np.ndarray, img_w: int) -> np.ndarray:
    """Compose a horizontal source-image flip under an affine crop matrix:
    returns M' with M'(x, y) = M(img_w - 1 - x, y)."""
    out = mat.copy()
    out[:, 2] = mat[:, 0] * (img_w - 1) + mat[:, 2]
    out[:, 0] = -mat[:, 0]
    return out


def random_flip(rng: np.random.RandomState, sample: Dict, img_w: int,
                schema: KeypointSchema, prob: float = 0.5) -> Dict:
    """Horizontal flip (ref transforms.py:110-151): mirror keypoints and
    center about the image, swap symmetric joints; record the flip for
    matrix composition."""
    if rng.random_sample() >= prob:
        return sample
    kpts = sample["keypoints"].copy()
    vis = sample["visible"].copy()
    center = sample["center"].copy()
    kpts[:, 0] = img_w - 1 - kpts[:, 0]
    center[0] = img_w - 1 - center[0]
    idx = schema.flip_index()
    sample = dict(sample)
    sample["keypoints"] = kpts[idx]
    sample["visible"] = vis[idx]
    sample["center"] = center
    sample["flipped"] = True
    return sample


def random_vertical_flip(rng: np.random.RandomState, sample: Dict,
                         img_h: int, prob: float = 0.0) -> Dict:
    """Vertical flip (Stack-B RandomFlip supports it,
    the reference's data/pose_transforms.py:81-136). No keypoint swap —
    up/down symmetry does not exchange left/right joints."""
    if prob <= 0 or rng.random_sample() >= prob:
        return sample
    kpts = sample["keypoints"].copy()
    center = sample["center"].copy()
    kpts[:, 1] = img_h - 1 - kpts[:, 1]
    center[1] = img_h - 1 - center[1]
    sample = dict(sample)
    sample["keypoints"] = kpts
    sample["center"] = center
    sample["vflipped"] = True
    return sample


def compose_vflip(mat: np.ndarray, img_h: int) -> np.ndarray:
    """Compose a vertical source-image flip under an affine crop matrix."""
    out = mat.copy()
    out[:, 2] = mat[:, 1] * (img_h - 1) + mat[:, 2]
    out[:, 1] = -mat[:, 1]
    return out


def random_half_body(rng: np.random.RandomState, sample: Dict,
                     schema: KeypointSchema, prob: float = 0.3,
                     min_keypoints: int = 3) -> Dict:
    """Half-body crop (ref transforms.py:235-297): recenter on the visible
    upper or lower body, scale = kpt bbox * 1.5, floored at scale * 0.5."""
    if rng.random_sample() > prob:
        return sample
    kpts, vis = sample["keypoints"], sample["visible"]
    upper = [kpts[i] for i in schema.upper_body if vis[i] > 0]
    lower = [kpts[i] for i in schema.lower_body if vis[i] > 0]
    if len(upper) >= min_keypoints and len(lower) >= min_keypoints:
        sel = upper if rng.random_sample() < 0.5 else lower
    elif len(upper) >= min_keypoints:
        sel = upper
    elif len(lower) >= min_keypoints:
        sel = lower
    else:
        return sample
    sel = np.asarray(sel, np.float32)
    center = sel.mean(axis=0)
    wh = sel.max(axis=0) - sel.min(axis=0)
    scale = np.maximum(wh * 1.5, sample["scale"] * 0.5).astype(np.float32)
    sample = dict(sample)
    sample["center"] = center.astype(np.float32)
    sample["scale"] = scale
    return sample


def random_bbox_transform(rng: np.random.RandomState, sample: Dict,
                          scale_factor: Tuple[float, float] = (0.5, 1.5),
                          rotation_factor: float = 40.0,
                          rotation_prob: float = 0.6,
                          shift_factor: float = 0.0,
                          shift_prob: float = 0.0) -> Dict:
    """Random rescale/rotation (ref transforms.py:154-195) plus the Stack-B
    bbox shift (ref data/pose_transforms.py:224-264)."""
    sample = dict(sample)
    s = rng.uniform(scale_factor[0], scale_factor[1])
    sample["scale"] = sample["scale"] * s
    if rng.random_sample() < rotation_prob:
        rot = float(np.clip(rng.randn() * rotation_factor,
                            -2 * rotation_factor, 2 * rotation_factor))
    else:
        rot = 0.0
    sample["rotation"] = rot
    if shift_factor > 0 and rng.random_sample() < shift_prob:
        shift = rng.uniform(-shift_factor, shift_factor, 2) * sample["scale"]
        sample["center"] = sample["center"] + shift.astype(np.float32)
    return sample


def finalize_affine(sample: Dict, input_size: Tuple[int, int],
                    img_w: int) -> Dict:
    """Build the final crop matrix (with flip composed in), transform
    keypoints to crop space, and invalidate out-of-bounds joints
    (ref transforms.py:198-232)."""
    mat = affine_matrix_np(sample["center"], sample["scale"], input_size,
                           sample.get("rotation", 0.0))
    kpts = sample["keypoints"].copy()
    vis = sample["visible"].copy()
    mask = vis > 0
    xy1 = np.concatenate([kpts, np.ones((len(kpts), 1), np.float32)], 1)
    warped = xy1 @ mat.T
    kpts[mask] = warped[mask]
    oob = ((kpts[:, 0] < 0) | (kpts[:, 0] >= input_size[0]) |
           (kpts[:, 1] < 0) | (kpts[:, 1] >= input_size[1]))
    vis[mask & oob] = 0.0

    warp_mat = compose_flip(mat, img_w) if sample.get("flipped") else mat
    if sample.get("vflipped"):
        warp_mat = compose_vflip(warp_mat, sample["img_h"])
    out = dict(sample)
    out["keypoints"] = kpts
    out["visible"] = vis
    out["matrix"] = warp_mat  # maps ORIGINAL image -> crop
    return out


def train_transform(rng: np.random.RandomState, sample: Dict, img_w: int,
                    schema: KeypointSchema, cfg_data,
                    img_h: int | None = None) -> Dict:
    """Full training pipeline (ref transforms.py:300-315):
    flip [+vflip] -> half-body -> scale/rotate[/shift] -> affine."""
    s = random_flip(rng, sample, img_w, schema, cfg_data.flip_prob)
    if img_h is not None and cfg_data.vertical_flip_prob > 0:
        s = dict(random_vertical_flip(rng, s, img_h,
                                      cfg_data.vertical_flip_prob))
        s["img_h"] = img_h
    s = random_half_body(rng, s, schema, cfg_data.half_body_prob)
    s = random_bbox_transform(
        rng, s, tuple(cfg_data.scale_factor), cfg_data.rotation_factor,
        cfg_data.rotation_prob, cfg_data.shift_factor, cfg_data.shift_prob)
    return finalize_affine(s, tuple(cfg_data.input_size), img_w)


def val_transform(sample: Dict, img_w: int, cfg_data) -> Dict:
    """Validation pipeline: plain affine crop (ref transforms.py:318-322)."""
    s = dict(sample)
    s["rotation"] = 0.0
    return finalize_affine(s, tuple(cfg_data.input_size), img_w)
