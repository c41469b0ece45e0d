"""Skeleton / heatmap / bbox drawing (host-side, cv2).

A copy of infantposeestimation_gaussianbias_tpu/viz/skeleton.py: the
reference's visualisation utilities, schema-parametric.  cv2 is imported
where a function draws.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np

from ..schemas import COCO17, KeypointSchema

# 17-entry BGR colour wheel, in the spirit of the reference's COCO_COLORS.
_COLORS = [
    (255, 0, 0), (255, 85, 0), (255, 170, 0), (255, 255, 0),
    (170, 255, 0), (85, 255, 0), (0, 255, 0), (0, 255, 85),
    (0, 255, 170), (0, 255, 255), (0, 170, 255), (0, 85, 255),
    (0, 0, 255), (85, 0, 255), (170, 0, 255), (255, 0, 255),
    (255, 0, 170),
]


def keypoint_color(k: int) -> Tuple[int, int, int]:
    return _COLORS[k % len(_COLORS)]


def draw_skeleton(
    img: np.ndarray,
    keypoints: np.ndarray,
    scores: Optional[np.ndarray] = None,
    schema: KeypointSchema = COCO17,
    threshold: float = 0.3,
    point_radius: int = 4,
    line_thickness: int = 2,
) -> np.ndarray:
    """Draw keypoints + skeleton edges on a BGR image."""
    import cv2

    out = img.copy()
    K = schema.num_keypoints
    vis = (scores >= threshold if scores is not None
           else np.ones(K, bool))
    for (i, j) in schema.skeleton:
        if i >= K or j >= K or not (vis[i] and vis[j]):
            continue
        p1 = tuple(np.round(keypoints[i]).astype(int))
        p2 = tuple(np.round(keypoints[j]).astype(int))
        cv2.line(out, p1, p2, keypoint_color(i), line_thickness)
    for k in range(K):
        if not vis[k]:
            continue
        p = tuple(np.round(keypoints[k]).astype(int))
        cv2.circle(out, p, point_radius, keypoint_color(k), -1)
    return out


def draw_heatmaps(img: np.ndarray, heatmaps: np.ndarray,
                  alpha: float = 0.5) -> np.ndarray:
    """Overlay max-over-keypoints heatmap with a JET colormap.  heatmaps:
    (H, W, K) or (K, H, W)."""
    import cv2

    hm = np.asarray(heatmaps)
    if hm.shape[0] < hm.shape[-1]:  # (K, H, W) -> (H, W, K)
        hm = hm.transpose(1, 2, 0)
    combined = hm.max(axis=-1)
    combined = np.clip(combined, 0, None)
    if combined.max() > 0:
        combined = combined / combined.max()
    combined = (combined * 255).astype(np.uint8)
    combined = cv2.resize(combined, (img.shape[1], img.shape[0]))
    colored = cv2.applyColorMap(combined, cv2.COLORMAP_JET)
    return cv2.addWeighted(img, 1 - alpha, colored, alpha, 0)


def draw_bbox(img: np.ndarray, bbox: Sequence[float],
              color=(0, 255, 0), thickness: int = 2) -> np.ndarray:
    import cv2

    out = img.copy()
    x1, y1, x2, y2 = [int(round(v)) for v in bbox]
    cv2.rectangle(out, (x1, y1), (x2, y2), color, thickness)
    return out


def create_grid_image(images: List[np.ndarray], cols: int = 4,
                      pad: int = 2) -> np.ndarray:
    """Tile images into a grid."""
    if not images:
        return np.zeros((1, 1, 3), np.uint8)
    h = max(im.shape[0] for im in images)
    w = max(im.shape[1] for im in images)
    rows = -(-len(images) // cols)
    grid = np.zeros((rows * (h + pad) - pad, cols * (w + pad) - pad, 3),
                    np.uint8)
    for idx, im in enumerate(images):
        r, c = divmod(idx, cols)
        y, x = r * (h + pad), c * (w + pad)
        grid[y:y + im.shape[0], x:x + im.shape[1]] = im
    return grid
