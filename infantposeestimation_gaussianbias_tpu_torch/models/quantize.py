"""Model-level int8 PTQ: calibrate -> convert -> serve.

Port of infantposeestimation_gaussianbias_tpu/models/quantize.py, over the
port's state dicts.  Serving flow:

    sd     = model.state_dict()                    # float, trained
    qsd    = quantize_model(cfg, sd, batches)      # int8 serving state
    qmodel = build_model(cfg, quant=True)
    qmodel.load_state_dict(qsd)                    # K9 / K10 forward

The calibration batches are normalised (N, H, W, 3) crops, augment-free,
so that the abs-max ranges match what is served; a few batches are enough,
each range being a running maximum.
"""

from __future__ import annotations

from typing import Dict, Iterable, Mapping

import torch
import torch.distributed as dist

from ..ops.quant import convert_tree
from .pose_estimator import build_model, resolve_device

_HEAD_FINALS = ("heatmap_branch.3.", "offset_branch.3.",
                "variance_branch.3.")
_FUSION_LOGITS = ("fusion_weight", "subpixel_refine.alpha")


@torch.no_grad()
def calibrate(cfg, state_dict: Mapping[str, torch.Tensor],
              batches: Iterable, device="cuda",
              group=None) -> Dict[str, torch.Tensor]:
    """Run the unfolded float model (eval mode, ``cfg.model.compute_dtype``)
    over ``batches`` and return the running abs-max of every calibration
    point, ``{name: () float32}`` (models/layers.py ``sow_absmax``).
    ``group``: a process group whose ranks calibrate on their own rows of
    one global batch (a grid's data group); each abs-max is then the
    maximum over the group, one all-reduce of all of them, so every rank
    gets the scales of one process calibrating on the global batch."""
    device = resolve_device(device)
    model = build_model(cfg, device, calibrate=True)
    model.load_state_dict(state_dict, strict=True)
    for batch in batches:
        model(torch.as_tensor(batch, dtype=torch.float32, device=device))
    values = dict(model.calibration.values)
    if not values:
        raise ValueError("calibration needs at least one batch")
    if group is not None:
        flat = torch.stack(list(values.values()))
        dist.all_reduce(flat, op=dist.ReduceOp.MAX, group=group)
        values = dict(zip(values, flat.unbind()))
    return values


def strip_float_params(state_dict: Mapping[str, torch.Tensor],
                       head_type: str) -> Dict[str, torch.Tensor]:
    """The float entries an int8 HRNet still reads: the fusion head's 1x1
    finals and decode logits, or the heatmap head's ``final_layer``; the
    backbone serves from its int8 buffers alone."""
    if head_type == "fusion":
        keep = tuple(f"head.{k}" for k in _HEAD_FINALS + _FUSION_LOGITS)
    elif head_type == "heatmap":
        keep = ("head.",)
    else:
        raise ValueError(f"unsupported head for PTQ: {head_type!r}")
    return {k: v for k, v in state_dict.items() if k.startswith(keep)}


def strip_quantized_dense(state_dict: Mapping[str, torch.Tensor],
                          qparams: Mapping[str, torch.Tensor]
                          ) -> Dict[str, torch.Tensor]:
    """The float state dict without the Linears whose QDense twins carry
    their int8 weights (HRFormer's Dense-only PTQ: convs, norms, narrow
    Linears and the head still serve from the float entries)."""
    quantized = {k[: -len(".in_scale")] for k in qparams
                 if k.endswith(".in_scale")}
    return {k: v for k, v in state_dict.items()
            if k.rpartition(".")[0] not in quantized}


def _prune_non_dense_qparams(qparams: Mapping[str, torch.Tensor]
                             ) -> Dict[str, torch.Tensor]:
    """Dense-only PTQ reads only the QDense buffers (modules with an
    ``in_scale``): drop what ``convert_tree`` made of the float conv
    trunk."""
    dense = {k.rpartition(".")[0] for k in qparams if k.endswith(".in_scale")}
    return {k: v for k, v in qparams.items()
            if k.rpartition(".")[0] in dense}


def quantize_model(cfg, state_dict: Mapping[str, torch.Tensor],
                   batches: Iterable, device="cuda", group=None
                   ) -> Dict[str, torch.Tensor]:
    """Float state dict (unfolded) + calibration batches -> the state dict
    of ``build_model(cfg, quant=True)``: the int8 buffers, plus the float
    entries the int8 forward still reads (an HRNet's head finals; an
    HRFormer's whole float model but its quantized Linears, BatchNorm
    statistics included, which its float conv trunk needs).  ``group``:
    see ``calibrate``."""
    if (cfg.model.backbone.startswith("hrnet")
            and cfg.model.norm != "batchnorm"):
        raise ValueError("quantization requires batchnorm ConvNorms")
    calib = calibrate(cfg, state_dict, batches, device, group)
    qparams = convert_tree(state_dict, calib)
    if cfg.model.backbone.startswith("hrformer"):
        qparams = _prune_non_dense_qparams(qparams)
        out = strip_quantized_dense(state_dict, qparams)
    else:
        out = strip_float_params(state_dict, cfg.model.head_type)
    out.update(qparams)
    return out
