"""Synthetic COCO keypoint data for tests, smoke runs and benchmarks.

Port of infantposeestimation_gaussianbias_tpu/data/synthetic.py (numpy,
and cv2 to write the images): random images, keypoints as a clipped
Gaussian around the image centre, and a whole COCO-format dataset, its
images optionally written to disk as JPEGs.  The same seed gives the same
images and annotations as the JAX package.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np


def dummy_image(rng: np.random.RandomState, height: int = 480,
                width: int = 640) -> np.ndarray:
    return rng.randint(0, 255, (height, width, 3)).astype(np.uint8)


def dummy_keypoints(rng: np.random.RandomState, num: int = 17,
                    height: int = 480, width: int = 640) -> np.ndarray:
    """Keypoints clipped-Gaussian around the image center, all visible."""
    cx, cy = width / 2, height / 2
    xs = np.clip(cx + rng.randn(num) * width / 6, 0, width - 1)
    ys = np.clip(cy + rng.randn(num) * height / 6, 0, height - 1)
    vis = np.full(num, 2.0)
    return np.stack([xs, ys, vis], -1).astype(np.float32)


def synthetic_coco_dataset(
    num_images: int = 8,
    num_keypoints: int = 17,
    image_dir: Optional[str] = None,
    seed: int = 0,
    height: int = 256,
    width: int = 320,
    keypoint_names: Optional[List[str]] = None,
    skeleton: Optional[List[Tuple[int, int]]] = None,
) -> Dict:
    """Build a COCO-format dict (and optionally write images to disk).

    Each image has one person annotation whose bbox covers its keypoints.
    """
    import cv2

    rng = np.random.RandomState(seed)
    images, annotations = [], []
    for i in range(num_images):
        file_name = f"synth_{i:06d}.jpg"
        if image_dir is not None:
            img = dummy_image(rng, height, width)
            cv2.imwrite(os.path.join(image_dir, file_name), img)
        kpts = dummy_keypoints(rng, num_keypoints, height, width)
        x1, y1 = kpts[:, 0].min(), kpts[:, 1].min()
        x2, y2 = kpts[:, 0].max(), kpts[:, 1].max()
        pad = 10.0
        x1, y1 = max(0, x1 - pad), max(0, y1 - pad)
        x2, y2 = min(width - 1, x2 + pad), min(height - 1, y2 + pad)
        images.append({"id": i + 1, "file_name": file_name,
                       "width": width, "height": height})
        annotations.append({
            "id": i + 1, "image_id": i + 1, "category_id": 1,
            "keypoints": kpts.reshape(-1).tolist(),
            "num_keypoints": int((kpts[:, 2] > 0).sum()),
            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
            "area": float((x2 - x1) * (y2 - y1)),
            "iscrowd": 0,
        })
    names = keypoint_names or [f"kpt_{k}" for k in range(num_keypoints)]
    cat = {"id": 1, "name": "person", "supercategory": "person",
           "keypoints": list(names),
           "skeleton": [list(e) for e in (skeleton or [])]}
    return {"images": images, "annotations": annotations,
            "categories": [cat]}
