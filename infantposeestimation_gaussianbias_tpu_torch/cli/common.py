"""Shared CLI plumbing: the config from a named variant, a YAML file and
dotted-path overrides, the device and checkpoint options of the serving
CLIs, and ``--mesh``.

``--mesh [MODEL_AXIS]`` runs a CLI over a process grid, one process per
rank, launched by torchrun (``python -m torch.distributed.run
--nproc-per-node N -m <cli> --mesh ...``): each rank initialises the
process group from torchrun's environment with the ``--backend`` it is
given (``nccl``, a card per rank, refused by ``check_backend`` for more
ranks than cards; ``gloo``, the CPU or several ranks on one card; by
default nccl on a card and gloo on the CPU, never switched after a
failure), then builds a (world / MODEL_AXIS) x MODEL_AXIS grid, as the
JAX CLIs mesh their devices.  MODEL_AXIS defaults to 1; above 1 the
weights are cut over the model axis (tensor parallelism), as JAX's
``tensor_parallel = model_axis > 1``.  A world below two ranks is the one
process (a 1 x 1 grid).
"""

from __future__ import annotations

import argparse
import os

from ..config import Config, apply_overrides, get_variant, load_yaml


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
    add_mesh_args(parser)


def add_mesh_args(parser: argparse.ArgumentParser,
                  model_axis: bool = True) -> None:
    """``--mesh`` (with an optional MODEL_AXIS, or a plain flag for a
    data-parallel CLI) and ``--backend``."""
    if model_axis:
        parser.add_argument("--mesh", type=int, nargs="?", const=1,
                            default=None, metavar="MODEL_AXIS",
                            help="run over a process grid launched by "
                                 "torchrun; MODEL_AXIS > 1 cuts the weights "
                                 "over the model axis (tensor parallelism)")
    else:
        parser.add_argument("--mesh", action="store_true",
                            help="evaluate over a process grid launched by "
                                 "torchrun (data-parallel)")
    parser.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                        help="process-group backend under --mesh (default: "
                             "nccl on a card, gloo on the CPU)")


def _model_axis(args: argparse.Namespace) -> int:
    return 1 if args.mesh is True else max(1, args.mesh)


def backend(args: argparse.Namespace) -> str:
    """``--backend``, or by default nccl on a card and gloo on the CPU."""
    return args.backend or ("gloo" if str(args.device).startswith("cpu")
                            else "nccl")


def init_process_group(args: argparse.Namespace) -> bool:
    """Under ``--mesh``, initialise the process group from torchrun's
    environment with the chosen backend, unless it is already; returns
    whether there is one of two or more ranks."""
    import torch.distributed as dist

    from ..parallel import initialize_multihost

    if args.mesh is None or args.mesh is False:
        return False
    if not dist.is_initialized():
        if int(os.environ.get("WORLD_SIZE", "1")) < 2:
            if _model_axis(args) > 1:
                raise ValueError(f"mesh 1x{_model_axis(args)} does not "
                                 f"cover 1 device")
            return False
        initialize_multihost(backend(args))
    return dist.get_world_size() > 1


def make_grid(args: argparse.Namespace):
    """The ProcessGrid ``--mesh`` asks for (see the module doc), or None
    for the one process: without ``--mesh``, or in a world below two
    ranks."""
    from ..parallel import create_mesh

    if not init_process_group(args):
        return None
    return create_mesh(0, _model_axis(args), args.device)


def resolve_config(args: argparse.Namespace) -> Config:
    cfg = get_variant(args.variant)
    if args.config:
        cfg = load_yaml(args.config, base=cfg)
    apply_overrides(cfg, args.overrides)
    return cfg


def make_inference(args: argparse.Namespace, cfg: Config,
                   calibration_crops=None, grid=None):
    """``PoseInference`` from the serving options (``--int8``: int8 PTQ,
    calibrated on ``calibration_crops`` or else on the first batch), over
    ``grid`` (``make_grid``) when one is given, tensor-parallel when its
    model axis is above one."""
    import torch

    from ..inference import PoseInference

    state_dict = None
    if args.checkpoint:
        state_dict = torch.load(args.checkpoint, map_location="cpu",
                                weights_only=True)
    return PoseInference(cfg, state_dict=state_dict, device=args.device,
                         fold=False if args.no_fold else None,
                         quantize=args.int8,
                         calibration_crops=calibration_crops, mesh=grid,
                         tensor_parallel=grid is not None and grid.model > 1)
