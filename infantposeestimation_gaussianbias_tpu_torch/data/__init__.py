"""Data layer: COCO index, augmentation transforms, the threaded loader,
device batches, synthetic data, and the serving pipeline's prefetch
stage."""

from .coco import CocoIndex, build_records
from .pipeline import (DataLoader, PoseDataset, build_dataloader,
                       device_batch, prefetch_to_device)
from .synthetic import dummy_image, dummy_keypoints, synthetic_coco_dataset

__all__ = [
    "CocoIndex",
    "DataLoader",
    "PoseDataset",
    "build_dataloader",
    "build_records",
    "device_batch",
    "dummy_image",
    "dummy_keypoints",
    "prefetch_to_device",
    "synthetic_coco_dataset",
]
