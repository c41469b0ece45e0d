"""Minimal COCO keypoint-annotation index (plain Python, no pycocotools).

Port of infantposeestimation_gaussianbias_tpu/data/coco.py: images,
per-image annotations and the keypoint category of a COCO JSON file, and
``build_records``, one training record per annotation (or per image).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np


class CocoIndex:
    """Lightweight COCO index over images / annotations / categories."""

    def __init__(self, ann_file: Optional[str] = None,
                 dataset: Optional[Dict[str, Any]] = None):
        if dataset is None:
            with open(ann_file) as f:
                dataset = json.load(f)
        self.dataset = dataset
        self.imgs: Dict[int, Dict] = {im["id"]: im
                                      for im in dataset.get("images", [])}
        self.anns: Dict[int, Dict] = {a["id"]: a
                                      for a in dataset.get("annotations", [])}
        self.cats: Dict[int, Dict] = {c["id"]: c
                                      for c in dataset.get("categories", [])}
        self.img_to_anns: Dict[int, List[Dict]] = {i: [] for i in self.imgs}
        for a in dataset.get("annotations", []):
            self.img_to_anns.setdefault(a["image_id"], []).append(a)

    def get_img_ids(self) -> List[int]:
        return sorted(self.imgs)

    def load_img(self, img_id: int) -> Dict:
        return self.imgs[img_id]

    def get_anns(self, img_id: int, iscrowd: Optional[bool] = None
                 ) -> List[Dict]:
        anns = self.img_to_anns.get(img_id, [])
        if iscrowd is None:
            return anns
        return [a for a in anns if bool(a.get("iscrowd", 0)) == iscrowd]

    def keypoint_category(self) -> Optional[Dict]:
        for c in self.cats.values():
            if "keypoints" in c:
                return c
        return None

    @property
    def num_keypoints(self) -> int:
        cat = self.keypoint_category()
        if cat is None:
            return 0
        return len(cat["keypoints"])


def build_records(
    index: CocoIndex,
    img_prefix: str = "",
    bbox_padding: float = 1.25,
    one_per_image: bool = False,
    min_keypoints: int = 1,
) -> List[Dict[str, Any]]:
    """Flatten the index to one record per annotation (Stack-A convention,
    the reference's datasets/coco_dataset.py:66-116) or one per image
    (Stack-B "one infant per image", the reference's data/coco_dataset.py).

    Record: image_file, image_id, ann_id, center, scale (both the clipped
    bbox * padding), bbox [x1,y1,x2,y2], keypoints (K,2), visible (K,), area.
    """
    records = []
    for img_id in index.get_img_ids():
        info = index.load_img(img_id)
        anns = index.get_anns(img_id, iscrowd=False)
        for ann in anns:
            if ann.get("num_keypoints", 0) < min_keypoints:
                continue
            x, y, w, h = ann["bbox"]
            if w <= 0 or h <= 0:
                continue
            x1, y1 = max(0.0, x), max(0.0, y)
            x2 = min(float(info["width"]), x + w)
            y2 = min(float(info["height"]), y + h)
            if x2 <= x1 or y2 <= y1:
                continue
            kpts = np.asarray(ann["keypoints"], np.float32).reshape(-1, 3)
            center = np.array([(x1 + x2) / 2, (y1 + y2) / 2], np.float32)
            scale = np.array([x2 - x1, y2 - y1], np.float32) * bbox_padding
            records.append({
                "image_file": os.path.join(img_prefix, info["file_name"]),
                "image_id": img_id,
                "ann_id": ann["id"],
                "center": center,
                "scale": scale,
                "bbox": np.array([x1, y1, x2, y2], np.float32),
                "keypoints": kpts[:, :2].copy(),
                "visible": kpts[:, 2].copy(),
                "area": float(ann.get("area", w * h)),
                # Image dims let the native loader compute the crop
                # matrix without decoding first (binding.decode_warp).
                "img_w": int(info["width"]),
                "img_h": int(info["height"]),
            })
            if one_per_image:
                break
    return records
