"""Extended keypoint schemas: face-68 / hand-21 templates, category
merging, keypoint groups, multi-task targets.

Port of infantposeestimation_gaussianbias_tpu/analysis/extension.py
(numpy only; the same templates, names and skeleton offsets): the
reference's coco_extension_guide.py:19-512 and
extended_dataset_loader.py:15-397 capabilities: predefined face/hand
landmark templates, COCO category add/merge (e.g. the 127-point
body+face+hands whole-body set), heuristic keypoint-group detection, and
per-group target splitting for multi-task heads.  The port's
``schemas.schema_from_category`` turns a category into a KeypointSchema.
"""

from __future__ import annotations

import copy
import json
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from ..schemas import COCO17, KeypointSchema, schema_from_category


def _chain(start: int, stop: int, close: bool = False) -> List[List[int]]:
    edges = [[i, i + 1] for i in range(start, stop)]
    if close:
        edges.append([stop, start])
    return edges


def _face68_template() -> Dict:
    names = (
        [f"jaw_{i}" for i in range(17)]
        + [f"left_eyebrow_{i}" for i in range(5)]
        + [f"right_eyebrow_{i}" for i in range(5)]
        + [f"nose_bridge_{i}" for i in range(4)]
        + [f"nose_tip_{i}" for i in range(5)]
        + [f"left_eye_{i}" for i in range(6)]
        + [f"right_eye_{i}" for i in range(6)]
        + [f"outer_lip_{i}" for i in range(12)]
        + [f"inner_lip_{i}" for i in range(8)]
    )
    skeleton = (
        _chain(0, 16)            # jaw
        + _chain(17, 21)         # left brow
        + _chain(22, 26)         # right brow
        + _chain(27, 30)         # nose bridge
        + _chain(31, 35) + [[35, 31]]   # nose tip loop
        + _chain(36, 41) + [[41, 36]]   # left eye loop
        + _chain(42, 47) + [[47, 42]]   # right eye loop
        + _chain(48, 59) + [[59, 48]]   # outer lip loop
        + _chain(60, 67) + [[67, 60]]   # inner lip loop
    )
    return {"num_keypoints": 68, "names": names, "skeleton": skeleton}


def _hand21_template() -> Dict:
    names = ["wrist"]
    for finger in ("thumb", "index", "middle", "ring", "pinky"):
        names += [f"{finger}_{i}" for i in range(1, 5)]
    skeleton = []
    for f in range(5):
        base = 1 + f * 4
        skeleton.append([0, base])
        skeleton += [[base + i, base + i + 1] for i in range(3)]
    return {"num_keypoints": 21, "names": names, "skeleton": skeleton}


TEMPLATES: Dict[str, Dict] = {
    "face_68": _face68_template(),
    "hand_21": _hand21_template(),
    "body_17": {
        "num_keypoints": 17,
        "names": list(COCO17.keypoint_names),
        "skeleton": [list(e) for e in COCO17.skeleton],
    },
}


class COCOKeypointExtender:
    """Add / merge keypoint categories in a COCO dataset
    (the reference's coco_extension_guide.py:130-295)."""

    def __init__(self, base_dataset: Optional[Dict] = None):
        self.dataset = (copy.deepcopy(base_dataset) if base_dataset else
                        {"images": [], "annotations": [], "categories": []})
        self._next_ann_id = 1 + max(
            [a["id"] for a in self.dataset.get("annotations", [])],
            default=0)

    def add_keypoint_category(self, category_id: int, category_name: str,
                              template_name: Optional[str] = None,
                              keypoint_names: Optional[List[str]] = None,
                              skeleton: Optional[List] = None) -> Dict:
        if template_name is not None:
            t = TEMPLATES[template_name]
            keypoint_names = list(t["names"])
            skeleton = [list(e) for e in t["skeleton"]]
        cat = {
            "id": category_id,
            "name": category_name,
            "supercategory": "person",
            "keypoints": list(keypoint_names or []),
            "skeleton": skeleton or [],
        }
        self.dataset["categories"].append(cat)
        return cat

    def merge_keypoint_categories(self, template_names: Sequence[str],
                                  category_id: int = 1,
                                  category_name: str = "whole_body") -> Dict:
        """Concatenate templates into one category; duplicate template uses
        get a part prefix (e.g. left_/right_ hand) and skeleton indices are
        offset — reproducing the reference's 127-pt body+face+hands merge
        (ref :472-512)."""
        seen: Dict[str, int] = {}
        names: List[str] = []
        skeleton: List[List[int]] = []
        offset = 0
        for tname in template_names:
            t = TEMPLATES[tname]
            count = seen.get(tname, 0)
            seen[tname] = count + 1
            prefix = ""
            if tname == "hand_21":
                prefix = "left_hand_" if count == 0 else "right_hand_"
            elif count > 0:
                prefix = f"{tname}_{count}_"
            names += [prefix + n for n in t["names"]]
            skeleton += [[a + offset, b + offset] for a, b in t["skeleton"]]
            offset += t["num_keypoints"]
        return self.add_keypoint_category(category_id, category_name,
                                          keypoint_names=names,
                                          skeleton=skeleton)

    def add_annotation(self, image_id: int, category_id: int,
                       keypoints: Sequence, bbox=None) -> Dict:
        kpts = np.asarray(keypoints, np.float64).reshape(-1, 3)
        if bbox is None:
            vis = kpts[kpts[:, 2] > 0]
            if len(vis):
                x1, y1 = vis[:, 0].min(), vis[:, 1].min()
                x2, y2 = vis[:, 0].max(), vis[:, 1].max()
                bbox = [x1, y1, x2 - x1, y2 - y1]
            else:
                bbox = [0, 0, 0, 0]
        ann = {
            "id": self._next_ann_id,
            "image_id": image_id,
            "category_id": category_id,
            "keypoints": kpts.reshape(-1).tolist(),
            "num_keypoints": int((kpts[:, 2] > 0).sum()),
            "bbox": [float(v) for v in bbox],
            "area": float(bbox[2] * bbox[3]),
            "iscrowd": 0,
        }
        self.dataset["annotations"].append(ann)
        self._next_ann_id += 1
        return ann

    def save(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.dataset, f)

    def schema(self, category_id: int = 1) -> KeypointSchema:
        for cat in self.dataset["categories"]:
            if cat["id"] == category_id:
                return schema_from_category(cat)
        raise KeyError(category_id)


# -- keypoint groups (ref extended_dataset_loader.py:308-397) ---------------

def detect_keypoint_groups(names: Sequence[str]) -> Dict[str, List[int]]:
    """Heuristic body/face/left_hand/right_hand/foot grouping by name."""
    groups: Dict[str, List[int]] = {}
    face_words = ("jaw", "eyebrow", "nose_bridge", "nose_tip",
                  "lip", "eye_")
    for i, n in enumerate(names):
        if "left_hand" in n:
            g = "left_hand"
        elif "right_hand" in n:
            g = "right_hand"
        elif any(w in n for w in face_words):
            g = "face"
        elif any(w in n for w in ("foot", "heel", "toe")):
            g = "foot"
        else:
            g = "body"
        groups.setdefault(g, []).append(i)
    return groups


def split_group_targets(keypoints: np.ndarray, visible: np.ndarray,
                        groups: Dict[str, List[int]]
                        ) -> Dict[str, Dict[str, np.ndarray]]:
    """Split (K, 2)/(K,) labels into per-group multi-task targets
    (ref extended_dataset_loader.py MultiTaskKeypointDataset)."""
    out = {}
    for g, idxs in groups.items():
        out[g] = {"keypoints": keypoints[..., idxs, :],
                  "visible": visible[..., idxs]}
    return out
