"""Validation CLI: COCO keypoint AP of a checkpoint on ``data.val_ann``.

Port of infantposeestimation_gaussianbias_tpu/cli/validate.py.

    python -m infantposeestimation_gaussianbias_tpu_torch.cli.validate \
        --variant hrformer_base --checkpoint checkpoints/best

``--checkpoint`` names a checkpoint of the port's trainer
(train/checkpoint.py); without it the model has seeded weights.  The
float model is served BN-folded where the architecture folds (as the
JAX CLI does); ``--no-fold`` serves eval-mode BatchNorm.  The loss runs
on the unfolded model either way.
"""

from __future__ import annotations

import argparse
import json
import os

from ..data.pipeline import build_dataloader
from ..models import build_model, fold_state_dict, serving_mode_supported
from ..train.checkpoint import CheckpointManager
from ..train.loop import setup_logging, validate
from ..train.step import create_train_state
from .common import INT8_TODO, MESH_TODO, add_config_args, resolve_config


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
                        help="int8 PTQ serving (not ported: raises)")
    parser.add_argument("--no-fold", action="store_true",
                        help="serve eval-mode BatchNorm instead of the "
                             "BN-folded convs")
    parser.add_argument("--mesh", action="store_true",
                        help="evaluate over several cards (not ported: "
                             "raises)")
    args = parser.parse_args(argv)
    if args.int8:
        raise NotImplementedError(INT8_TODO)
    if args.mesh:
        raise NotImplementedError(MESH_TODO)
    cfg = resolve_config(args)
    setup_logging()

    state = create_train_state(cfg, device=args.device)
    if args.checkpoint:
        mgr = CheckpointManager(os.path.dirname(args.checkpoint) or ".")
        state, meta = mgr.restore(state, os.path.basename(args.checkpoint))
        if meta is None:
            raise SystemExit(f"no checkpoint at {args.checkpoint}")

    loader = build_dataloader(cfg, is_train=False)
    with open(os.path.join(cfg.data.data_root, cfg.data.val_ann)) as f:
        gt = json.load(f)

    serve = None
    if not args.no_fold and serving_mode_supported(
            cfg.model.backbone, cfg.model.head_type, cfg.model.norm,
            fold=True):
        serve = build_model(cfg, args.device, fold=True)
        serve.load_state_dict(fold_state_dict(state.model.state_dict()),
                              strict=True)
    results = validate(cfg, state, loader, gt, model=serve)
    for k, v in results.items():
        print(f"{k:>6}: {v:.4f}")


if __name__ == "__main__":
    main()
