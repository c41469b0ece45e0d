"""Convert custom keypoint annotations to COCO format, validate, split.

Port of infantposeestimation_gaussianbias_tpu/tools/convert_to_coco.py:
the 13-keypoint infant category (or any schema), boxes from the keypoints
with 20 px of padding, the custom-JSON and TXT parsers, format
validation, and a train / val / test splitter.

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.convert_to_coco \
        --input-dir labels/ --output infants.json [--split]
"""

from __future__ import annotations

import copy
import json
import os
import random
from datetime import datetime
from typing import Dict, List, Optional, Sequence, Tuple

from ..schemas import INFANT13, KeypointSchema

BBOX_PADDING = 20  # px, ref tools/convert_to_coco.py:122


class COCOConverter:
    """Accumulate images + annotations into a COCO keypoint dataset."""

    def __init__(self, schema: KeypointSchema = INFANT13,
                 category_name: str = "preterm_infant"):
        self.schema = schema
        now = datetime.now()
        self.dataset: Dict = {
            "info": {
                "description": "Preterm Infant Pose Dataset",
                "version": "1.0",
                "year": now.year,
                "date_created": now.strftime("%Y-%m-%d"),
            },
            "licenses": [],
            "images": [],
            "annotations": [],
            "categories": [{
                "id": 1,
                "name": category_name,
                "supercategory": "person",
                "keypoints": list(schema.keypoint_names),
                "skeleton": [list(e) for e in schema.skeleton],
            }],
        }
        self.image_id = 1
        self.annotation_id = 1

    def add_image(self, file_name: str, width: Optional[int] = None,
                  height: Optional[int] = None,
                  image_path: Optional[str] = None) -> Optional[int]:
        if (width is None or height is None) and image_path:
            import cv2

            img = cv2.imread(image_path)
            if img is None:
                print(f"Warning: could not read image {image_path}")
                return None
            height, width = img.shape[:2]
        self.dataset["images"].append({
            "id": self.image_id,
            "file_name": file_name,
            "width": int(width),
            "height": int(height),
            "date_captured": datetime.now().strftime("%Y-%m-%d %H:%M:%S"),
        })
        self.image_id += 1
        return self.image_id - 1

    def add_annotation(self, image_id: int,
                       keypoints: Sequence[Sequence[float]],
                       bbox: Optional[Sequence[float]] = None) -> None:
        """keypoints: K x [x, y, v]; bbox [x, y, w, h] computed from visible
        keypoints + padding when absent (ref :111-127)."""
        kpts = [list(map(float, kp)) for kp in keypoints]
        if bbox is None:
            vis = [(x, y) for x, y, v in kpts if v > 0]
            if not vis:
                return
            xs, ys = zip(*vis)
            x_min, x_max = min(xs), max(xs)
            y_min, y_max = min(ys), max(ys)
            bbox = [max(0, x_min - BBOX_PADDING), max(0, y_min - BBOX_PADDING),
                    x_max - x_min + 2 * BBOX_PADDING,
                    y_max - y_min + 2 * BBOX_PADDING]
        flat = [v for kp in kpts for v in kp]
        self.dataset["annotations"].append({
            "id": self.annotation_id,
            "image_id": image_id,
            "category_id": 1,
            "keypoints": flat,
            "num_keypoints": sum(1 for kp in kpts if kp[2] > 0),
            "bbox": [float(b) for b in bbox],
            "area": float(bbox[2] * bbox[3]),
            "iscrowd": 0,
        })
        self.annotation_id += 1

    # -- input parsers ----------------------------------------------------

    @staticmethod
    def parse_custom_format(annotation_file: str) -> Dict:
        """{"image": ..., "keypoints": [[x,y,v]...], "bbox": optional}."""
        with open(annotation_file) as f:
            data = json.load(f)
        return {
            "image": data.get("image", data.get("image_file")),
            "keypoints": data["keypoints"],
            "bbox": data.get("bbox"),
        }

    @staticmethod
    def parse_txt_format(annotation_file: str) -> Dict:
        """First line: image name; following lines: 'x y v' per keypoint."""
        with open(annotation_file) as f:
            lines = [ln.strip() for ln in f if ln.strip()]
        kpts = []
        for ln in lines[1:]:
            parts = ln.split()
            kpts.append([float(parts[0]), float(parts[1]),
                         float(parts[2]) if len(parts) > 2 else 2.0])
        return {"image": lines[0], "keypoints": kpts, "bbox": None}

    def save(self, output_path: str) -> None:
        with open(output_path, "w") as f:
            json.dump(self.dataset, f, indent=2)
        print(f"Saved COCO dataset: {len(self.dataset['images'])} images, "
              f"{len(self.dataset['annotations'])} annotations -> "
              f"{output_path}")


def convert_dataset(input_dir: str, output_path: str,
                    image_dir: Optional[str] = None,
                    schema: KeypointSchema = INFANT13) -> Dict:
    """Batch-convert every .json/.txt annotation in a directory
    (ref :214-264); bad files are skipped with a warning."""
    conv = COCOConverter(schema)
    image_dir = image_dir or input_dir
    for name in sorted(os.listdir(input_dir)):
        path = os.path.join(input_dir, name)
        try:
            if name.endswith(".json"):
                ann = conv.parse_custom_format(path)
            elif name.endswith(".txt"):
                ann = conv.parse_txt_format(path)
            else:
                continue
            img_id = conv.add_image(
                ann["image"], image_path=os.path.join(image_dir,
                                                      ann["image"]))
            if img_id is not None:
                conv.add_annotation(img_id, ann["keypoints"], ann["bbox"])
        except Exception as e:  # skip-and-continue (ref :259-261)
            print(f"Warning: skipping {name}: {e}")
    conv.save(output_path)
    return conv.dataset


def validate_coco_format(dataset) -> Tuple[bool, List[str]]:
    """Check required COCO keys (ref :298-339). Accepts a path or dict."""
    if isinstance(dataset, str):
        with open(dataset) as f:
            dataset = json.load(f)
    errors = []
    for key in ("images", "annotations", "categories"):
        if key not in dataset:
            errors.append(f"missing top-level key {key!r}")
    for im in dataset.get("images", []):
        for key in ("id", "file_name", "width", "height"):
            if key not in im:
                errors.append(f"image missing {key!r}: {im.get('id')}")
                break
    img_ids = {im["id"] for im in dataset.get("images", [])}
    for ann in dataset.get("annotations", []):
        for key in ("id", "image_id", "category_id", "keypoints",
                    "num_keypoints", "bbox"):
            if key not in ann:
                errors.append(f"annotation missing {key!r}: {ann.get('id')}")
                break
        else:
            if ann["image_id"] not in img_ids:
                errors.append(f"annotation {ann['id']} references unknown "
                              f"image {ann['image_id']}")
            if len(ann["keypoints"]) % 3:
                errors.append(f"annotation {ann['id']} keypoints not "
                              "a multiple of 3")
    return not errors, errors


def split_dataset(dataset, train_ratio: float = 0.8, val_ratio: float = 0.1,
                  test_ratio: float = 0.1, seed: int = 0
                  ) -> Dict[str, Dict]:
    """Random train/val/test split by image (ref :342-390)."""
    if isinstance(dataset, str):
        with open(dataset) as f:
            dataset = json.load(f)
    assert abs(train_ratio + val_ratio + test_ratio - 1.0) < 1e-6
    images = list(dataset["images"])
    random.Random(seed).shuffle(images)
    n = len(images)
    n_train = int(n * train_ratio)
    n_val = int(n * val_ratio)
    splits = {
        "train": images[:n_train],
        "val": images[n_train:n_train + n_val],
        "test": images[n_train + n_val:],
    }

    def subset(imgs):
        ids = {im["id"] for im in imgs}
        out = copy.deepcopy({k: v for k, v in dataset.items()
                             if k not in ("images", "annotations")})
        out["images"] = imgs
        out["annotations"] = [a for a in dataset["annotations"]
                              if a["image_id"] in ids]
        return out

    return {name: subset(imgs) for name, imgs in splits.items()}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Convert annotations to COCO")
    p.add_argument("--input-dir", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--image-dir", default=None)
    p.add_argument("--schema", default="infant13")
    p.add_argument("--split", action="store_true")
    args = p.parse_args(argv)

    from ..schemas import get_schema

    ds = convert_dataset(args.input_dir, args.output, args.image_dir,
                         get_schema(args.schema))
    ok, errors = validate_coco_format(ds)
    print("valid" if ok else f"INVALID: {errors[:5]}")
    if args.split:
        base, ext = os.path.splitext(args.output)
        for name, sub in split_dataset(ds).items():
            with open(f"{base}_{name}{ext}", "w") as f:
                json.dump(sub, f)
            print(f"wrote {base}_{name}{ext} ({len(sub['images'])} images)")


if __name__ == "__main__":
    main()
