"""Whole-pipeline proof: train on a learnable synthetic task and measure AP.

Port of infantposeestimation_gaussianbias_tpu/tools/pipeline_proof.py.
Every keypoint of an image is a disk of its own hue on a dark noise
background, so a pose model can learn to find it.  The run goes through
the whole training path: the host loader with augmentation, the train
step, flip-test validation and COCO OKS-AP; a broken augmentation,
target, decode, back-projection or evaluator destroys the AP.

The JAX tool's default backbone, ``litehrnet``, is not in the port yet
(ROADMAP Queue 1 item 7), so this one defaults to ``hrnet_w32`` with the
heatmap head, the port's smallest model that trains at 128x128 with no
kernel of its own in the way; ``hrformer_base`` with the fusion head runs
too (``--backbone hrformer_base --head fusion``).

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.pipeline_proof
    ... --epochs 40 --device cpu       # a slow CPU run
"""

from __future__ import annotations

import colorsys
import tempfile
import time
from typing import Dict, Tuple

import numpy as np


def render_pose_image(rng: np.random.RandomState, num_kpts: int,
                      height: int, width: int
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Noise background and one hue-coded disk per keypoint."""
    img = rng.randint(0, 60, (height, width, 3)).astype(np.uint8)
    kpts = np.zeros((num_kpts, 3), np.float32)
    yy, xx = np.mgrid[0:height, 0:width]
    for k in range(num_kpts):
        x = rng.uniform(20, width - 20)
        y = rng.uniform(20, height - 20)
        rgb = np.array(colorsys.hsv_to_rgb(k / num_kpts, 1.0, 1.0)) * 255
        mask = (xx - x) ** 2 + (yy - y) ** 2 < 8.0**2
        img[mask] = rgb.astype(np.uint8)
        kpts[k] = (x, y, 2.0)
    return img, kpts


def build_synthetic_pose_dataset(n: int, num_kpts: int = 17,
                                 height: int = 192, width: int = 256,
                                 seed: int = 0
                                 ) -> Tuple[Dict, Dict[str, np.ndarray]]:
    """COCO dict and in-memory image cache of the rendered task."""
    from ..schemas import COCO17

    rng = np.random.RandomState(seed)
    images, annotations, cache = [], [], {}
    for i in range(n):
        img, kpts = render_pose_image(rng, num_kpts, height, width)
        name = f"proof_{i:05d}.jpg"
        cache[name] = img
        x1, y1 = kpts[:, 0].min() - 12, kpts[:, 1].min() - 12
        x2, y2 = kpts[:, 0].max() + 12, kpts[:, 1].max() + 12
        x1, y1 = max(0, x1), max(0, y1)
        x2, y2 = min(width - 1, x2), min(height - 1, y2)
        images.append({"id": i + 1, "file_name": name,
                       "width": width, "height": height})
        annotations.append({
            "id": i + 1, "image_id": i + 1, "category_id": 1,
            "keypoints": kpts.reshape(-1).tolist(),
            "num_keypoints": num_kpts,
            "bbox": [float(x1), float(y1), float(x2 - x1), float(y2 - y1)],
            "area": float((x2 - x1) * (y2 - y1)),
            "iscrowd": 0,
        })
    cat = {"id": 1, "name": "person", "supercategory": "person",
           "keypoints": list(COCO17.keypoint_names)[:num_kpts],
           "skeleton": [list(e) for e in COCO17.skeleton
                        if e[0] < num_kpts and e[1] < num_kpts]}
    return ({"images": images, "annotations": annotations,
             "categories": [cat]}, cache)


def run(train_images: int = 64, epochs: int = 400, ap_threshold: float = 0.5,
        backbone: str = "hrnet_w32", head_type: str = "heatmap",
        lr: float = 2e-3, device="cuda",
        hrnet_stage_modules: Tuple[int, ...] = (),
        verbose: bool = True) -> Dict[str, float]:
    """Train ``epochs`` epochs on ``train_images`` rendered images (batch
    16, 128x128, bf16; ``hrnet_stage_modules`` cuts an HRNet's depth),
    validate on the same images with the flip test and
    return the COCO metrics with the training and validation seconds
    (``train_s``, ``val_s``, host clock after a device sync); raises when
    AP is below ``ap_threshold``.  Logs go to a temporary directory."""
    import torch

    from ..config import Config
    from ..data import CocoIndex, DataLoader, PoseDataset, build_records
    from ..train.loop import train, validate

    cfg = Config()
    cfg.model.backbone = backbone
    cfg.model.head_type = head_type
    cfg.model.compute_dtype = "bfloat16"
    cfg.model.hrnet_stage_modules = tuple(hrnet_stage_modules)
    cfg.data.input_size = (128, 128)
    cfg.data.heatmap_size = (32, 32)
    cfg.data.rotation_factor = 15.0
    cfg.data.scale_factor = (0.8, 1.2)
    cfg.data.half_body_prob = 0.0
    cfg.train.global_batch_size = 16
    cfg.eval.batch_size = 16
    cfg.train.lr = lr
    cfg.train.warmup_epochs = 5
    cfg.train.lr_milestones = (int(epochs * 0.7), int(epochs * 0.9))
    cfg.train.val_interval = 10**9
    cfg.train.log_interval = 10**9  # the per-epoch lines suffice
    cfg.train.save_every = 0  # no checkpoints: the proof is the AP
    cfg.train.save_latest_interval = 0

    synth, cache = build_synthetic_pose_dataset(train_images)
    recs = build_records(CocoIndex(dataset=synth))
    train_loader = DataLoader(
        PoseDataset(cfg, recs, "", True, image_cache=cache),
        cfg.train.global_batch_size, shuffle=True, seed=0, drop_last=True)
    val_loader = DataLoader(
        PoseDataset(cfg, recs, "", False, image_cache=cache),
        cfg.eval.batch_size, shuffle=False)

    cuda = torch.device(device).type == "cuda"
    with tempfile.TemporaryDirectory() as tmp:
        cfg.train.checkpoint_dir = f"{tmp}/checkpoints"
        cfg.log_dir = f"{tmp}/logs"
        t0 = time.perf_counter()
        state = train(cfg, train_loader, max_epochs=epochs, device=device)
        if cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        results = validate(cfg, state, val_loader, synth, with_loss=False)
        t2 = time.perf_counter()
    results.update(train_s=t1 - t0, val_s=t2 - t1,
                   steps=float(state.step))
    if verbose:
        print({k: round(v, 4) for k, v in results.items()})
    if results["AP"] < ap_threshold:
        raise AssertionError(f"pipeline proof failed: AP {results['AP']:.3f}"
                             f" < {ap_threshold}")
    return results


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--backbone", default="hrnet_w32")
    p.add_argument("--head", default="heatmap")
    p.add_argument("--epochs", type=int, default=400)
    p.add_argument("--lr", type=float, default=2e-3)
    p.add_argument("--ap-threshold", type=float, default=0.5)
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    run(epochs=a.epochs, ap_threshold=a.ap_threshold, backbone=a.backbone,
        head_type=a.head, lr=a.lr, device=a.device)
