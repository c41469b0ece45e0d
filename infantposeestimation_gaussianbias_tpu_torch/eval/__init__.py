"""Evaluation: COCO OKS/AP, PCK, meters, clinical movement metrics."""

from .coco_eval import COCOEvaluator, compute_oks
from .metrics import (
    AverageMeter,
    MetricLogger,
    asymmetry_score,
    calculate_movement_amplitude,
    calculate_temporal_consistency,
    pck_accuracy,
)

__all__ = [
    "AverageMeter",
    "COCOEvaluator",
    "MetricLogger",
    "asymmetry_score",
    "calculate_movement_amplitude",
    "calculate_temporal_consistency",
    "compute_oks",
    "pck_accuracy",
]
