"""Shared CLI plumbing: the config from a named variant, a YAML file and
dotted-path overrides, and the device and checkpoint options of the
serving CLIs."""

from __future__ import annotations

import argparse

from ..config import Config, apply_overrides, get_variant, load_yaml

MESH_TODO = ("--mesh (serving over several cards) is not ported yet: "
             "ROADMAP Queue 1 item 9")


def add_config_args(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--variant", default="default",
                        help="named config variant (default, hrnet_w32, "
                             "hrnet_w48, hrformer_base, hrformer_small, "
                             "lightweight, preemie)")
    parser.add_argument("--config", default=None,
                        help="YAML config file merged over the variant")
    parser.add_argument("--set", dest="overrides", nargs="*", default=[],
                        metavar="KEY=VALUE",
                        help="dotted-path overrides, e.g. train.lr=1e-3")


def add_serving_args(parser: argparse.ArgumentParser) -> None:
    """The options ``serve`` and ``infer`` share."""
    parser.add_argument("--checkpoint", default=None,
                        help="a torch.save'd state dict in the reference "
                             "checkpoint's naming (float or BN-folded); "
                             "seeded weights without it")
    parser.add_argument("--device", default="cuda",
                        help="torch device to serve on (default cuda; "
                             "'cpu' runs the kernels' plain versions)")
    parser.add_argument("--no-fold", action="store_true",
                        help="serve eval-mode BatchNorm instead of the "
                             "BN-folded convs")
    parser.add_argument("--int8", action="store_true",
                        help="serve in int8 PTQ (calibrated on the first "
                             "batch; hrnet conv-PTQ or hrformer Dense-PTQ)")
    parser.add_argument("--mesh", type=int, nargs="?", const=0, default=None,
                        metavar="MODEL_AXIS",
                        help="serve over several cards (not ported: raises)")


def resolve_config(args: argparse.Namespace) -> Config:
    cfg = get_variant(args.variant)
    if args.config:
        cfg = load_yaml(args.config, base=cfg)
    apply_overrides(cfg, args.overrides)
    return cfg


def make_inference(args: argparse.Namespace, cfg: Config,
                   calibration_crops=None):
    """``PoseInference`` from the serving options (``--int8``: int8 PTQ,
    calibrated on ``calibration_crops`` or else on the first batch);
    ``--mesh`` raises NotImplementedError."""
    if args.mesh is not None:
        raise NotImplementedError(MESH_TODO)
    import torch

    from ..inference import PoseInference

    state_dict = None
    if args.checkpoint:
        state_dict = torch.load(args.checkpoint, map_location="cpu",
                                weights_only=True)
    return PoseInference(cfg, state_dict=state_dict, device=args.device,
                         fold=False if args.no_fold else None,
                         quantize=args.int8,
                         calibration_crops=calibration_crops)
