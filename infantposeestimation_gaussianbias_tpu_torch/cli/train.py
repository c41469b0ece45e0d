"""Training CLI.

Port of infantposeestimation_gaussianbias_tpu/cli/train.py.

    python -m infantposeestimation_gaussianbias_tpu_torch.cli.train \
        --variant hrformer_base --set data.data_root=/data/coco train.lr=5e-4
    ... --synthetic 8 --epochs 2 --device cpu   # a smoke run, no data

Checkpoints go to ``train.checkpoint_dir``; a run whose directory holds a
``latest`` checkpoint resumes from it ("resumed from epoch N").  Metrics go
to ``<log_dir>/metrics.jsonl``.
"""

from __future__ import annotations

import argparse
import json
import os

from ..data.pipeline import build_dataloader
from ..train.loop import MESH_TODO, setup_logging, train
from .common import add_config_args, resolve_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="Train a pose estimator")
    add_config_args(parser)
    parser.add_argument("--epochs", type=int, default=None,
                        help="override max epochs")
    parser.add_argument("--no-val", action="store_true")
    parser.add_argument("--synthetic", type=int, default=0, metavar="N",
                        help="train on N synthetic images (smoke test, "
                             "no COCO data needed)")
    parser.add_argument("--profile", nargs="?", const="10:13",
                        metavar="START:STOP",
                        help="write a torch.profiler trace of global steps "
                             "[START, STOP) into <log_dir>/profile "
                             "(default window 10:13)")
    parser.add_argument("--device", default="cuda",
                        help="torch device to train on (default cuda; "
                             "'cpu' runs the kernels' plain versions)")
    args = parser.parse_args(argv)
    profile_steps = None
    if args.profile:
        a, _, b = args.profile.partition(":")
        profile_steps = (int(a), int(b)) if b else (int(a), int(a) + 3)
        if not 0 <= profile_steps[0] < profile_steps[1]:
            parser.error(f"--profile window must satisfy 0 <= START < "
                         f"STOP, got {args.profile!r}")
    cfg = resolve_config(args)
    if cfg.parallel.multihost:
        raise NotImplementedError(MESH_TODO)

    os.makedirs(cfg.log_dir, exist_ok=True)
    setup_logging(os.path.join(cfg.log_dir, f"{cfg.exp_name}.log"))

    if args.synthetic:
        train_loader, val_loader, gt = _synthetic_loaders(cfg,
                                                          args.synthetic)
        if args.no_val:
            val_loader, gt = None, None
    else:
        train_loader = build_dataloader(cfg, is_train=True)
        val_loader, gt = None, None
        if not args.no_val:
            val_loader = build_dataloader(cfg, is_train=False)
            with open(os.path.join(cfg.data.data_root,
                                   cfg.data.val_ann)) as f:
                gt = json.load(f)
    train(cfg, train_loader, val_loader, gt, max_epochs=args.epochs,
          device=args.device, profile_steps=profile_steps)


def _synthetic_loaders(cfg, n):
    """Loaders over n synthetic annotations on seeded in-memory images."""
    import numpy as np

    from ..data import (CocoIndex, DataLoader, PoseDataset, build_records,
                        synthetic_coco_dataset)

    schema = cfg.data.keypoint_schema
    synth = synthetic_coco_dataset(
        num_images=n, num_keypoints=schema.num_keypoints,
        keypoint_names=schema.keypoint_names, skeleton=schema.skeleton)
    rng = np.random.RandomState(0)
    cache = {im["file_name"]: rng.randint(0, 255, (256, 320, 3))
             .astype(np.uint8) for im in synth["images"]}
    recs = build_records(CocoIndex(dataset=synth))
    bs = min(cfg.train.global_batch_size, n)
    train_loader = DataLoader(
        PoseDataset(cfg, recs, "", True, image_cache=cache), bs,
        shuffle=True, seed=cfg.train.seed)
    val_loader = DataLoader(
        PoseDataset(cfg, recs, "", False, image_cache=cache), bs,
        shuffle=False)
    return train_loader, val_loader, synth


if __name__ == "__main__":
    main()
