"""Validation CLI: COCO keypoint AP of a checkpoint on ``data.val_ann``.

Port of infantposeestimation_gaussianbias_tpu/cli/validate.py.

    python -m infantposeestimation_gaussianbias_tpu_torch.cli.validate \
        --variant hrformer_base --checkpoint checkpoints/best

``--checkpoint`` names a checkpoint of the port's trainer
(train/checkpoint.py); without it the model has seeded weights.  The
float model is served BN-folded where the architecture folds (as the
JAX CLI does); ``--no-fold`` serves eval-mode BatchNorm.  The loss runs
on the unfolded model either way.  ``--int8`` serves int8 PTQ, calibrated
on the first validation batch, and reports no loss (as the JAX CLI).
``--mesh`` evaluates data-parallel over a process grid launched by
torchrun (cli/common.py): every rank reads the whole set, predicts its
rows of each batch, and the predictions are gathered (train/loop.py
``validate(mesh=...)``); ``eval.batch_size`` must divide over the ranks,
as the JAX CLI requires of its devices.  Rank 0 prints.
"""

from __future__ import annotations

import argparse
import json
import os

from ..data.pipeline import build_dataloader
from ..data.pipeline import device_batch
from ..models import (build_model, fold_state_dict, quantize_model,
                      serving_mode_supported)
from ..parallel import shard_batch
from ..train.checkpoint import CheckpointManager
from ..train.loop import setup_logging, validate
from ..train.step import create_train_state
from .common import add_config_args, add_mesh_args, make_grid, resolve_config


def main(argv=None):
    parser = argparse.ArgumentParser(description="Evaluate on COCO val")
    add_config_args(parser)
    parser.add_argument("--checkpoint", default=None,
                        help="a checkpoint of the port's trainer, e.g. "
                             "checkpoints/best")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "kernels' plain versions)")
    parser.add_argument("--int8", action="store_true",
                        help="serve int8 PTQ (calibrated on the first "
                             "val batch); loss reporting is skipped")
    parser.add_argument("--no-fold", action="store_true",
                        help="serve eval-mode BatchNorm instead of the "
                             "BN-folded convs")
    add_mesh_args(parser, model_axis=False)
    args = parser.parse_args(argv)
    cfg = resolve_config(args)
    setup_logging()
    grid = make_grid(args)
    if args.mesh:
        ranks = 1 if grid is None else grid.size
        if cfg.eval.batch_size % ranks:
            raise SystemExit(
                f"--mesh needs eval.batch_size ({cfg.eval.batch_size}) "
                f"divisible by the device count ({ranks})")

    state = create_train_state(cfg, device=args.device, grid=grid)
    if args.checkpoint:
        mgr = CheckpointManager(os.path.dirname(args.checkpoint) or ".")
        state, meta = mgr.restore(state, os.path.basename(args.checkpoint))
        if meta is None:
            raise SystemExit(f"no checkpoint at {args.checkpoint}")

    loader = build_dataloader(cfg, is_train=False)
    with open(os.path.join(cfg.data.data_root, cfg.data.val_ann)) as f:
        gt = json.load(f)

    serve = None
    with_loss = True
    device = args.device if grid is None else grid.device
    if args.int8:
        first = next(iter(loader.epoch(0)))
        crops = device_batch(first, cfg.data.pixel_mean, cfg.data.pixel_std,
                             device)["image"]
        group = None
        if grid is not None:  # each rank calibrates on its rows
            crops, group = shard_batch(crops, grid), grid.data_group
        serve = build_model(cfg, device, grid, quant=True)
        serve.load_state_dict(quantize_model(
            cfg, state.model.state_dict(), [crops], device, group),
            strict=True)
        with_loss = False
    elif not args.no_fold and serving_mode_supported(
            cfg.model.backbone, cfg.model.head_type, cfg.model.norm,
            fold=True):
        serve = build_model(cfg, device, grid, fold=True)
        serve.load_state_dict(fold_state_dict(state.model.state_dict()),
                              strict=True)
    results = validate(cfg, state, loader, gt, with_loss=with_loss,
                       model=serve, mesh=grid)
    if grid is None or grid.rank == 0:
        for k, v in results.items():
            print(f"{k:>6}: {v:.4f}")


if __name__ == "__main__":
    main()
