"""COCO keypoint evaluation: OKS matching and AP/AR, in numpy.

Port of infantposeestimation_gaussianbias_tpu/eval/coco_eval.py: the whole
published COCOeval keypoints protocol (OKS with per-keypoint sigmas,
greedy matching per threshold that honours ignore regions, the area ranges
all / medium / large, maxDets 20, 101-point interpolated precision), the
upstream pycocotools path where pycocotools is importable, and the
reference's one-threshold greedy AP for quick checks.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, Optional

import numpy as np

# COCO keypoint evaluation constants.
OKS_THRESHOLDS = np.round(np.arange(0.5, 1.0, 0.05), 2)
RECALL_THRESHOLDS = np.linspace(0.0, 1.0, 101)
AREA_RANGES = {
    "all": (0.0, 1e10),
    "medium": (32.0**2, 96.0**2),
    "large": (96.0**2, 1e10),
}
MAX_DETS = 20


def compute_oks(
    gt_kpts: np.ndarray,
    gt_area: float,
    dt_kpts: np.ndarray,
    sigmas: np.ndarray,
    gt_bbox: Optional[np.ndarray] = None,
) -> np.ndarray:
    """OKS between one GT (K, 3) and many detections (N, K, 3).

    oks = mean over labeled keypoints of exp(-d^2 / (2 s^2 kappa_i^2)),
    kappa_i = 2*sigma_i, s^2 = gt area.  When the GT has no labeled
    keypoints, the pycocotools fallback measures distance to the padded
    bbox region.
    """
    var = (sigmas * 2.0) ** 2
    xg, yg, vg = gt_kpts[:, 0], gt_kpts[:, 1], gt_kpts[:, 2]
    k1 = int((vg > 0).sum())
    xd, yd = dt_kpts[:, :, 0], dt_kpts[:, :, 1]
    if k1 > 0:
        dx = xd - xg[None]
        dy = yd - yg[None]
    else:
        if gt_bbox is None:
            return np.zeros(dt_kpts.shape[0])
        x0, y0 = gt_bbox[0] - gt_bbox[2], gt_bbox[1] - gt_bbox[3]
        x1, y1 = gt_bbox[0] + 2 * gt_bbox[2], gt_bbox[1] + 2 * gt_bbox[3]
        dx = np.maximum(x0 - xd, 0) + np.maximum(xd - x1, 0)
        dy = np.maximum(y0 - yd, 0) + np.maximum(yd - y1, 0)
    e = (dx**2 + dy**2) / var[None] / (gt_area + np.spacing(1)) / 2.0
    if k1 > 0:
        e = e[:, vg > 0]
    return np.exp(-e).sum(axis=1) / e.shape[1]


class COCOEvaluator:
    """Accumulate per-sample predictions; evaluate COCO keypoint AP/AR.

    Same update() contract as the reference evaluator
    (the reference's utils/metrics.py:61-106): per sample, predicted
    keypoints in ORIGINAL image coordinates plus per-keypoint scores.
    """

    def __init__(self, sigmas: np.ndarray,
                 gt_dataset: Optional[Dict] = None):
        self.sigmas = np.asarray(sigmas, np.float64)
        self.gt = gt_dataset  # COCO-format dict
        self.predictions: List[Dict] = []

    def update(self, image_ids, keypoints, scores, valid=None) -> None:
        """keypoints (B, K, 2); scores (B, K); valid optional (B,) mask."""
        keypoints = np.asarray(keypoints)
        scores = np.asarray(scores)
        for i, img_id in enumerate(np.asarray(image_ids).tolist()):
            if valid is not None and not valid[i]:
                continue
            kpts = np.concatenate(
                [keypoints[i], scores[i][:, None]], axis=1)
            self.predictions.append({
                "image_id": int(img_id),
                "keypoints": kpts,
                "score": float(scores[i].mean()),
            })

    def reset(self) -> None:
        self.predictions = []

    # -- full COCOeval keypoints protocol -------------------------------

    def evaluate(self, backend: str = "auto") -> Dict[str, float]:
        """Evaluate accumulated predictions.

        ``backend``: 'native' runs this module's vectorized protocol;
        'pycocotools' runs upstream pycocotools exactly as the reference
        does (the reference's utils/metrics.py:145-206), raising if it
        is not installed; 'auto' (default) prefers pycocotools when
        importable and falls back to native.  The native path is the JAX
        package's, held there against two independent oracles and in the
        port's tests against the JAX package's.
        """
        if backend not in ("auto", "native", "pycocotools"):
            raise ValueError(f"unknown backend {backend!r}")
        if self.gt is None:
            raise ValueError("evaluate() needs the GT dataset dict")
        if backend != "native":
            try:
                return self._evaluate_pycocotools()
            except ImportError:
                if backend == "pycocotools":
                    raise
        return self._evaluate_native()

    def _evaluate_pycocotools(self) -> Dict[str, float]:
        """Upstream pycocotools path, mirroring the reference's flow:
        COCO(gt) -> loadRes(predictions) -> COCOeval('keypoints') with
        our sigmas -> evaluate/accumulate/summarize."""
        import copy

        from pycocotools.coco import COCO
        from pycocotools.cocoeval import COCOeval

        if not self.predictions:
            # upstream loadRes cannot represent an empty result list
            return self._evaluate_native()
        coco_gt = COCO()
        gt = copy.deepcopy(self.gt)
        gt.setdefault("info", {})
        gt.setdefault("licenses", [])
        coco_gt.dataset = gt
        coco_gt.createIndex()
        cat_id = (gt["categories"][0]["id"] if gt.get("categories") else 1)
        results = [{
            "image_id": int(p["image_id"]),
            "category_id": cat_id,
            "keypoints": np.asarray(p["keypoints"], np.float64)
            .reshape(-1).tolist(),
            "score": float(p["score"]),
        } for p in self.predictions]
        coco_dt = coco_gt.loadRes(results)
        e = COCOeval(coco_gt, coco_dt, iouType="keypoints")
        e.params.kpt_oks_sigmas = np.asarray(self.sigmas, np.float64)
        e.evaluate()
        e.accumulate()
        e.summarize()
        names = ["AP", "AP50", "AP75", "AP_M", "AP_L",
                 "AR", "AR50", "AR75", "AR_M", "AR_L"]
        return {n: float(v) for n, v in zip(names, e.stats)}

    def _evaluate_native(self) -> Dict[str, float]:
        gts_by_img = defaultdict(list)
        for ann in self.gt["annotations"]:
            g = dict(ann)
            g["ignore"] = bool(g.get("iscrowd", 0)) or \
                g.get("num_keypoints", 0) == 0
            gts_by_img[ann["image_id"]].append(g)
        dts_by_img = defaultdict(list)
        for p in self.predictions:
            dts_by_img[p["image_id"]].append(p)

        img_ids = sorted(set(gts_by_img) | set(dts_by_img))
        T = len(OKS_THRESHOLDS)

        results = {}
        for range_name, (amin, amax) in AREA_RANGES.items():
            per_img = []
            for img_id in img_ids:
                per_img.append(self._evaluate_img(
                    gts_by_img[img_id], dts_by_img[img_id], amin, amax))
            results[range_name] = self._accumulate(per_img, T)

        p_all, r_all = results["all"]
        p_med, r_med = results["medium"]
        p_lrg, r_lrg = results["large"]

        def mean_or_neg1(x):
            x = x[x > -1]
            return float(x.mean()) if x.size else -1.0

        t50 = int(np.argwhere(np.isclose(OKS_THRESHOLDS, 0.5))[0][0])
        t75 = int(np.argwhere(np.isclose(OKS_THRESHOLDS, 0.75))[0][0])
        return {
            "AP": mean_or_neg1(p_all),
            "AP50": mean_or_neg1(p_all[t50]),
            "AP75": mean_or_neg1(p_all[t75]),
            "AP_M": mean_or_neg1(p_med),
            "AP_L": mean_or_neg1(p_lrg),
            "AR": mean_or_neg1(r_all),
            "AR50": mean_or_neg1(r_all[t50]),
            "AR75": mean_or_neg1(r_all[t75]),
            "AR_M": mean_or_neg1(r_med),
            "AR_L": mean_or_neg1(r_lrg),
        }

    def _evaluate_img(self, gts, dts, amin, amax):
        """Greedy per-threshold matching for one image (COCOeval protocol)."""
        T = len(OKS_THRESHOLDS)
        gts = list(gts)
        dts = sorted(dts, key=lambda d: -d["score"])[:MAX_DETS]
        if not gts and not dts:
            return None
        gt_ignore = np.array(
            [g["ignore"] or g.get("area", 0) < amin
             or g.get("area", 0) > amax for g in gts], bool)
        iscrowd = np.array([bool(g.get("iscrowd", 0)) for g in gts], bool)
        # sort gts: non-ignored first (pycocotools order)
        order = np.argsort(gt_ignore, kind="stable")
        gts = [gts[i] for i in order]
        gt_ignore = gt_ignore[order]
        iscrowd = iscrowd[order]

        G, D = len(gts), len(dts)
        ious = np.zeros((D, G))
        if D and G:
            dt_k = np.stack([np.asarray(d["keypoints"], np.float64)
                             for d in dts])
            for gi, g in enumerate(gts):
                kpts = np.asarray(g["keypoints"], np.float64).reshape(-1, 3)
                ious[:, gi] = compute_oks(
                    kpts, float(g.get("area", 1.0)), dt_k, self.sigmas,
                    np.asarray(g["bbox"], np.float64))

        gtm = -np.ones((T, G), int)
        dtm = -np.ones((T, D), int)
        dt_ignore = np.zeros((T, D), bool)
        for ti, thr in enumerate(OKS_THRESHOLDS):
            for di in range(D):
                best_iou = min(thr, 1 - 1e-10)
                m = -1
                for gi in range(G):
                    # an already-matched gt can only be re-matched if crowd
                    if gtm[ti, gi] >= 0 and not iscrowd[gi]:
                        continue
                    # stop at ignored gts once a real match exists
                    if m > -1 and not gt_ignore[m] and gt_ignore[gi]:
                        break
                    if ious[di, gi] < best_iou:
                        continue
                    best_iou = ious[di, gi]
                    m = gi
                if m == -1:
                    continue
                dtm[ti, di] = m
                gtm[ti, m] = di
                dt_ignore[ti, di] = gt_ignore[m]
        # Unmatched dets outside the area range are ignored.  pycocotools'
        # loadRes assigns each keypoint detection area = tight keypoint
        # extent bbox ((max x - min x) * (max y - min y)); reproduce that.
        dt_area = np.array([self._det_area(d) for d in dts])
        out_of_range = (dt_area < amin) | (dt_area > amax)
        dt_ignore = dt_ignore | ((dtm == -1) & out_of_range[None, :])
        scores = np.array([d["score"] for d in dts])
        return {
            "dtm": dtm, "dt_ignore": dt_ignore, "scores": scores,
            "num_gt": int((~gt_ignore).sum()),
        }

    @staticmethod
    def _det_area(det) -> float:
        """Detection area per pycocotools loadRes: tight bbox over ALL
        predicted keypoints (regardless of score)."""
        k = np.asarray(det["keypoints"], np.float64)
        x, y = k[:, 0], k[:, 1]
        return float((x.max() - x.min()) * (y.max() - y.min()))

    @staticmethod
    def _accumulate(per_img, T):
        per_img = [e for e in per_img if e is not None]
        if not per_img:
            return -np.ones((T, len(RECALL_THRESHOLDS))), -np.ones(T)
        scores = np.concatenate([e["scores"] for e in per_img])
        order = np.argsort(-scores, kind="mergesort")
        dtm = np.concatenate([e["dtm"] for e in per_img], axis=1)[:, order]
        dtig = np.concatenate([e["dt_ignore"] for e in per_img],
                              axis=1)[:, order]
        npig = sum(e["num_gt"] for e in per_img)
        precision = -np.ones((T, len(RECALL_THRESHOLDS)))
        recall = -np.ones(T)
        if npig == 0:
            return precision, recall
        tps = (dtm >= 0) & ~dtig
        fps = (dtm < 0) & ~dtig
        tp_sum = np.cumsum(tps, axis=1).astype(float)
        fp_sum = np.cumsum(fps, axis=1).astype(float)
        for ti in range(T):
            tp, fp = tp_sum[ti], fp_sum[ti]
            rc = tp / npig
            pr = tp / (tp + fp + np.spacing(1))
            recall[ti] = rc[-1] if rc.size else 0.0
            # interpolated precision
            pr = pr.tolist()
            for i in range(len(pr) - 1, 0, -1):
                pr[i - 1] = max(pr[i - 1], pr[i])
            inds = np.searchsorted(rc, RECALL_THRESHOLDS, side="left")
            q = np.zeros(len(RECALL_THRESHOLDS))
            for ri, pi in enumerate(inds):
                if pi < len(pr):
                    q[ri] = pr[pi]
            precision[ti] = q
        return precision, recall

    # -- lightweight greedy fallback (ref utils/metrics.py:208-272) ------

    def simple_ap(self, threshold: float = 0.5) -> float:
        """Greedy one-threshold AP, the reference's manual fallback."""
        if self.gt is None:
            raise ValueError("needs GT dataset")
        gts_by_img = defaultdict(list)
        for ann in self.gt["annotations"]:
            if ann.get("num_keypoints", 0) > 0:
                gts_by_img[ann["image_id"]].append(ann)
        n_gt = sum(len(v) for v in gts_by_img.values())
        dets = sorted(self.predictions, key=lambda d: -d["score"])
        matched = defaultdict(set)
        tp = np.zeros(len(dets))
        for i, det in enumerate(dets):
            best, best_j = 0.0, -1
            for j, g in enumerate(gts_by_img.get(det["image_id"], [])):
                if j in matched[det["image_id"]]:
                    continue
                kpts = np.asarray(g["keypoints"], np.float64).reshape(-1, 3)
                oks = compute_oks(kpts, float(g.get("area", 1.0)),
                                  det["keypoints"][None], self.sigmas,
                                  np.asarray(g["bbox"], np.float64))[0]
                if oks > best:
                    best, best_j = oks, j
            if best >= threshold and best_j >= 0:
                tp[i] = 1
                matched[det["image_id"]].add(best_j)
        if n_gt == 0 or not len(dets):
            return 0.0
        tps = np.cumsum(tp)
        precision = tps / np.arange(1, len(dets) + 1)
        recall = tps / n_gt
        ap = 0.0
        for r in RECALL_THRESHOLDS:
            p = precision[recall >= r]
            ap += (p.max() if p.size else 0.0) / len(RECALL_THRESHOLDS)
        return float(ap)
