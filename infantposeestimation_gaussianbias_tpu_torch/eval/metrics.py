"""Training and evaluation metrics: meters, PCK, clinical movement metrics.

Port of infantposeestimation_gaussianbias_tpu/eval/metrics.py (numpy):
``AverageMeter`` and ``MetricLogger`` (the reference's meters, with its
``__getattr__`` fixed), ``pck_accuracy``, and the movement metrics that the
reference imports but never defines (amplitude, temporal consistency,
left/right asymmetry).
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Optional

import numpy as np


class AverageMeter:
    """Running average (ref utils/metrics.py:275-297)."""

    def __init__(self):
        self.reset()

    def reset(self):
        self.val = 0.0
        self.sum = 0.0
        self.count = 0
        self.avg = 0.0

    def update(self, val: float, n: int = 1):
        self.val = float(val)
        self.sum += float(val) * n
        self.count += n
        self.avg = self.sum / max(self.count, 1)


class MetricLogger:
    """Dict of AverageMeters with attribute access
    (ref utils/metrics.py:300-325; the reference's __getattr__ called
    super().__getattr__ which object lacks — fixed here)."""

    def __init__(self):
        self.meters: Dict[str, AverageMeter] = defaultdict(AverageMeter)

    def update(self, n: int = 1, **kwargs):
        for k, v in kwargs.items():
            self.meters[k].update(float(v), n)

    def __getattr__(self, name: str) -> AverageMeter:
        meters = self.__dict__.get("meters")
        if meters is not None and name in meters:
            return meters[name]
        raise AttributeError(name)

    def summary(self) -> Dict[str, float]:
        return {k: m.avg for k, m in self.meters.items()}

    def __str__(self) -> str:
        return "  ".join(f"{k}: {m.avg:.4f}" for k, m in self.meters.items())


def pck_accuracy(pred: np.ndarray, gt: np.ndarray, mask: np.ndarray,
                 norm: np.ndarray, threshold: float = 0.2) -> Dict[str, float]:
    """PCK@t: fraction of visible keypoints within t * norm of GT.

    pred/gt (B, K, 2); mask (B, K) visibility; norm (B,) normalization
    length (bbox diagonal or torso). Declared in the reference's EVAL
    config (configs/default.yaml PCK_THRESHOLD 0.2)."""
    dist = np.linalg.norm(pred - gt, axis=-1) / np.maximum(
        norm[:, None], 1e-8)
    ok = (dist <= threshold) & (mask > 0)
    per_kpt = ok.sum(0) / np.maximum((mask > 0).sum(0), 1)
    overall = ok.sum() / max((mask > 0).sum(), 1)
    return {"pck": float(overall),
            "per_keypoint": per_kpt.astype(float)}


def calculate_movement_amplitude(trajectory: np.ndarray,
                                 fps: float = 30.0) -> Dict[str, np.ndarray]:
    """Per-joint movement amplitude over a (T, K, 2) trajectory.

    amplitude = per-joint bounding range of motion; mean_velocity =
    average frame-to-frame displacement * fps (px/s).  Implements the
    capability declared (but missing) in the reference.
    """
    traj = np.asarray(trajectory, np.float64)
    rng = traj.max(0) - traj.min(0)  # (K, 2)
    amplitude = np.linalg.norm(rng, axis=-1)  # (K,)
    if traj.shape[0] > 1:
        vel = np.linalg.norm(np.diff(traj, axis=0), axis=-1)  # (T-1, K)
        mean_velocity = vel.mean(0) * fps
        peak_velocity = vel.max(0) * fps
    else:
        mean_velocity = np.zeros(traj.shape[1])
        peak_velocity = np.zeros(traj.shape[1])
    return {
        "amplitude": amplitude,
        "mean_velocity": mean_velocity,
        "peak_velocity": peak_velocity,
        "overall_amplitude": float(amplitude.mean()),
    }


def calculate_temporal_consistency(trajectory: np.ndarray) -> float:
    """Temporal smoothness score in (0, 1]: 1 / (1 + mean jerk), where
    jerk is the second difference of the (T, K, 2) trajectory.  Higher is
    smoother; matches the temporal-consistency metric named in the
    reference's EVAL config (configs/preemie_optimized.yaml)."""
    traj = np.asarray(trajectory, np.float64)
    if traj.shape[0] < 3:
        return 1.0
    acc = np.diff(traj, n=2, axis=0)
    jerk = np.linalg.norm(acc, axis=-1).mean()
    return float(1.0 / (1.0 + jerk))


def asymmetry_score(trajectory: np.ndarray, left_ids, right_ids) -> float:
    """Left/right movement asymmetry in [0, 1): |L - R| / (L + R) of mean
    per-side amplitudes (clinical assessment,
    ref examples/quick_start.py:208-269)."""
    amp = calculate_movement_amplitude(trajectory)["amplitude"]
    left = amp[list(left_ids)].mean()
    right = amp[list(right_ids)].mean()
    return float(abs(left - right) / (left + right + 1e-8))
