"""Dataset statistics and a quality report for a COCO keypoint set.

Port of infantposeestimation_gaussianbias_tpu/tools/analyze_dataset.py
(numpy; matplotlib for the optional plots): per-keypoint visibility, bbox
width / height / area / aspect statistics, image sizes, normalised
keypoint positions, and a text report with data-quality warnings.

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.analyze_dataset \
        --ann annotations/person_keypoints_val2017.json [--out-dir plots/]
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np

from ..data.coco import CocoIndex


class DatasetAnalyzer:
    """Compute and report statistics over a COCO keypoint dataset."""

    def __init__(self, dataset, keypoint_names: Optional[List[str]] = None):
        if isinstance(dataset, str):
            with open(dataset) as f:
                dataset = json.load(f)
        self.index = CocoIndex(dataset=dataset)
        cat = self.index.keypoint_category()
        self.keypoint_names = (keypoint_names or
                               (cat["keypoints"] if cat else []))
        self.stats = self._compute()

    def _compute(self) -> Dict:
        anns = list(self.index.anns.values())
        imgs = list(self.index.imgs.values())
        K = len(self.keypoint_names) or (
            len(anns[0]["keypoints"]) // 3 if anns else 0)

        vis_counts = np.zeros((K, 3))  # v=0 / v=1 / v=2
        positions = []  # normalized (x, y) of visible kpts
        bboxes = []
        for ann in anns:
            kpts = np.asarray(ann["keypoints"], np.float64).reshape(-1, 3)
            img = self.index.imgs[ann["image_id"]]
            for k in range(min(K, len(kpts))):
                v = int(np.clip(kpts[k, 2], 0, 2))
                vis_counts[k, v] += 1
                if v > 0:
                    positions.append([k, kpts[k, 0] / img["width"],
                                      kpts[k, 1] / img["height"]])
            x, y, w, h = ann["bbox"]
            bboxes.append([w, h, w * h, w / max(h, 1e-8)])
        bboxes = np.asarray(bboxes) if bboxes else np.zeros((0, 4))
        sizes = np.asarray([[im["width"], im["height"]] for im in imgs])

        return {
            "num_images": len(imgs),
            "num_annotations": len(anns),
            "num_keypoints": K,
            "visibility": vis_counts,
            "positions": np.asarray(positions) if positions else
                np.zeros((0, 3)),
            "bbox_stats": {
                "width": _describe(bboxes[:, 0]),
                "height": _describe(bboxes[:, 1]),
                "area": _describe(bboxes[:, 2]),
                "aspect": _describe(bboxes[:, 3]),
            } if len(bboxes) else {},
            "image_sizes": sizes,
        }

    def quality_warnings(self) -> List[str]:
        """Data-quality heuristics (ref analyze_dataset.py report section)."""
        s = self.stats
        warnings = []
        if s["num_annotations"] < 100:
            warnings.append(
                f"small dataset: only {s['num_annotations']} annotations")
        total = s["visibility"].sum(1)
        for k in range(s["num_keypoints"]):
            if total[k] > 0:
                vis_rate = s["visibility"][k, 1:].sum() / total[k]
                if vis_rate < 0.5:
                    name = (self.keypoint_names[k]
                            if k < len(self.keypoint_names) else str(k))
                    warnings.append(
                        f"keypoint {name!r} visible in only "
                        f"{vis_rate:.0%} of annotations")
        if len(s["image_sizes"]) and len(np.unique(s["image_sizes"],
                                                   axis=0)) > 10:
            warnings.append("heterogeneous image sizes "
                            f"({len(np.unique(s['image_sizes'], axis=0))} "
                            "distinct)")
        return warnings

    def text_report(self) -> str:
        s = self.stats
        lines = [
            "Dataset analysis",
            "=" * 50,
            f"images: {s['num_images']}  annotations: "
            f"{s['num_annotations']}  keypoints: {s['num_keypoints']}",
            "",
            "Per-keypoint visibility (v0 / v1 / v2):",
        ]
        for k in range(s["num_keypoints"]):
            name = (self.keypoint_names[k]
                    if k < len(self.keypoint_names) else f"kpt_{k}")
            v = s["visibility"][k]
            lines.append(f"  {name:>16}: {int(v[0]):5d} / {int(v[1]):5d} "
                         f"/ {int(v[2]):5d}")
        if s["bbox_stats"]:
            lines.append("")
            lines.append("BBox statistics:")
            for key, d in s["bbox_stats"].items():
                lines.append(
                    f"  {key:>7}: mean {d['mean']:8.1f}  std {d['std']:8.1f}"
                    f"  min {d['min']:8.1f}  max {d['max']:8.1f}")
        warns = self.quality_warnings()
        if warns:
            lines += ["", "Quality warnings:"] + [f"  ! {w}" for w in warns]
        return "\n".join(lines)

    def plot(self, out_dir: str) -> None:
        """Visibility bars, bbox histograms, position heatmaps
        (ref analyze_dataset.py plotting)."""
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        os.makedirs(out_dir, exist_ok=True)
        s = self.stats

        fig, ax = plt.subplots(figsize=(10, 4))
        vis_rate = (s["visibility"][:, 1:].sum(1) /
                    np.maximum(s["visibility"].sum(1), 1))
        ax.bar(range(s["num_keypoints"]), vis_rate)
        ax.set_xticks(range(s["num_keypoints"]))
        names = [n.replace("_", "\n") for n in self.keypoint_names] or \
            list(range(s["num_keypoints"]))
        ax.set_xticklabels(names, fontsize=6)
        ax.set_title("Keypoint visibility rate")
        fig.savefig(os.path.join(out_dir, "visibility.png"), dpi=120)
        plt.close(fig)

        if len(s["positions"]):
            K = s["num_keypoints"]
            cols = 5
            rows = -(-K // cols)
            fig, axes = plt.subplots(rows, cols,
                                     figsize=(3 * cols, 2.5 * rows))
            for k in range(K):
                ax = axes.flat[k]
                pts = s["positions"][s["positions"][:, 0] == k]
                if len(pts):
                    ax.hist2d(pts[:, 1], pts[:, 2], bins=20,
                              range=[[0, 1], [0, 1]])
                ax.invert_yaxis()
                ax.set_title(self.keypoint_names[k]
                             if k < len(self.keypoint_names) else str(k),
                             fontsize=8)
            for k in range(K, rows * cols):
                axes.flat[k].axis("off")
            fig.savefig(os.path.join(out_dir, "positions.png"), dpi=120)
            plt.close(fig)


def _describe(x: np.ndarray) -> Dict[str, float]:
    if not len(x):
        return {"mean": 0.0, "std": 0.0, "min": 0.0, "max": 0.0}
    return {"mean": float(x.mean()), "std": float(x.std()),
            "min": float(x.min()), "max": float(x.max())}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Analyze a COCO keypoint dataset")
    p.add_argument("--ann", required=True)
    p.add_argument("--out-dir", default=None)
    args = p.parse_args(argv)
    analyzer = DatasetAnalyzer(args.ann)
    print(analyzer.text_report())
    if args.out_dir:
        analyzer.plot(args.out_dir)
        print(f"plots written to {args.out_dir}")


if __name__ == "__main__":
    main()
