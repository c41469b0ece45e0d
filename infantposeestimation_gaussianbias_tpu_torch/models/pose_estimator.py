"""PoseEstimator (backbone + head), its factory, decode and flip test.

Port of infantposeestimation_gaussianbias_tpu/models/pose_estimator.py:
every backbone of its ``BACKBONES`` (HRNet, HRFormer, LiteHRNet) and every
head type (heatmap, fusion, fused, simcc).  ``flip_inference`` keeps the
reference's flip-test contract: heatmaps are averaged with the mirrored
pass, while the fusion head's offsets and decode logits (and the fused
head's coords) come from the unflipped pass; the SimCC head has no
heatmaps to flip, and the flip test raises for it (the JAX function fails
on the missing key).

``build_model(cfg, device, grid, fold, quant, calibrate,
tensor_parallel)`` reads ``cfg.model.norm`` (BatchNorm or GroupNorm in
every ConvNorm, as the JAX package), under a process grid
(parallel/mesh.py) hands the grid to every WindowAttention and BatchNorm,
as the JAX ``build_model(cfg, mesh=...)`` threads its mesh, and with
``tensor_parallel`` cuts the weights the JAX rule shards over the grid's
model axis (parallel/tensor.py ``shard_params``, after the fold), with
``fold`` builds the BN-folded serving model
(models/fold.py), with ``quant`` the int8 PTQ serving model (its buffers
from models/quantize.py), and with ``calibrate`` the float model that
records its calibration points on every forward.
``validate_serving_mode`` is the one check of which architectures fold
and which quantize.
``multiscale_flip_inference`` is the JAX package's multi-scale + flip
test-time augmentation.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops import decode as decode_ops
from .fold import fold_state_dict
from .heads import FusedHead, FusionHead, HeatmapHead, SimCCHead
from .hrformer import WindowAttention, hrformer_base, hrformer_small
from .hrnet import hrnet_w32, hrnet_w48
from .litehrnet import litehrnet
from .layers import BatchNorm, Calibration, calibrating, resize_bilinear

BACKBONES: Dict[str, Callable[..., nn.Module]] = {
    "hrnet_w32": hrnet_w32,
    "hrnet_w48": hrnet_w48,
    "hrformer_base": hrformer_base,
    "hrformer_small": hrformer_small,
    "litehrnet": litehrnet,
}
HEAD_TYPES = ("heatmap", "fusion", "fused", "simcc")

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def validate_serving_mode(backbone_name: str, head_type: str, norm: str,
                          quant: bool = False, fold: bool = False) -> None:
    """Raise ValueError unless the architecture supports the requested
    int8 PTQ / BN-fold serving mode, by the JAX package's rules: int8 for
    the hrnet backbones (the conv pipeline) with the fusion or heatmap
    head, and for the hrformer backbones (their Dense layers); BN-fold for
    hrnet/hrformer backbones, fusion/heatmap heads, BatchNorm."""
    if quant:
        quant_conv = backbone_name.startswith("hrnet")
        quant_dense = backbone_name.startswith("hrformer")
        if not (quant_conv or quant_dense):
            raise ValueError(
                f"int8 PTQ supports the hrnet/hrformer backbones, not "
                f"{backbone_name!r}")
        if quant_conv and head_type not in ("fusion", "heatmap"):
            raise ValueError(
                f"int8 PTQ supports fusion/heatmap heads, not "
                f"{head_type!r}")
    if fold:
        if not backbone_name.startswith(("hrnet", "hrformer")):
            raise ValueError(
                f"BN-fold serving supports hrnet/hrformer backbones, "
                f"not {backbone_name!r}")
        if head_type not in ("fusion", "heatmap"):
            raise ValueError(
                f"BN-fold serving supports fusion/heatmap heads, not "
                f"{head_type!r}")
        if norm != "batchnorm":
            raise ValueError("BN-fold requires batchnorm ConvNorms")


def serving_mode_supported(backbone_name: str, head_type: str, norm: str,
                           quant: bool = False, fold: bool = False) -> bool:
    """Boolean form of validate_serving_mode."""
    try:
        validate_serving_mode(backbone_name, head_type, norm, quant=quant,
                              fold=fold)
        return True
    except ValueError:
        return False


class PoseEstimator(nn.Module):
    """Backbone + head.  NHWC images in, dict of NHWC maps out.

    A backbone whose name starts with ``hrnet`` takes ``stage_modules``;
    one whose name starts with ``litehrnet`` takes only the dtype and the
    norm; any other is an HRFormer and takes ``window_size`` and
    ``use_pallas``.  ``input_size`` (W, H) and ``simcc_split_ratio`` size
    the SimCC head's bins.  ``fold``: the BN-folded serving form;
    ``quant``: the int8 one (an HRNet's convs and head ConvNorms, an
    HRFormer's wide Dense layers); both checked by
    ``validate_serving_mode``.
    ``calibrate``: every forward records the running abs-max of each
    calibration point into ``self.calibration.values`` (HRNet: its
    ConvNorms, blocks, fused sums and input; HRFormer: its wide Dense
    inputs)."""

    def __init__(self, backbone_name: str = "hrnet_w32",
                 head_type: str = "heatmap", num_keypoints: int = 17,
                 hidden_dim: int = 256, window_size: int = 7,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, use_pallas: bool = False,
                 stage_modules: Optional[Tuple[int, ...]] = None,
                 norm: str = "batchnorm", fold: bool = False,
                 quant: bool = False, calibrate: bool = False,
                 input_size: Tuple[int, int] = (192, 256),
                 simcc_split_ratio: float = 2.0):
        super().__init__()
        validate_serving_mode(backbone_name, head_type, norm,
                              quant=quant or calibrate, fold=fold)
        if fold and (quant or calibrate):
            raise ValueError("BN-fold and int8 PTQ are separate serving "
                             "modes")
        if backbone_name not in BACKBONES:
            raise ValueError(f"Unknown backbone {backbone_name!r}; "
                             f"known: {sorted(BACKBONES)}")
        if head_type not in HEAD_TYPES:
            raise ValueError(f"the port has the {HEAD_TYPES} heads, not "
                             f"{head_type!r}")
        self.compute_dtype = compute_dtype
        self.head_type = head_type
        kw = dict(compute_dtype=compute_dtype, norm=norm)
        conv_net = backbone_name.startswith("hrnet")
        if conv_net:
            kw.update(stage_modules=stage_modules, remat=remat, fold=fold,
                      quant=quant)
        elif not backbone_name.startswith("litehrnet"):
            kw.update(window_size=window_size, use_pallas=use_pallas,
                      remat=remat, fold=fold, quant=quant)
        self.backbone = BACKBONES[backbone_name](**kw)
        width = self.backbone.channels[0]
        if head_type == "fusion":
            self.head = FusionHead(width, num_keypoints, hidden_dim,
                                   compute_dtype=compute_dtype, norm=norm,
                                   fold=fold, quant=quant and conv_net)
        elif head_type == "heatmap":
            self.head = HeatmapHead(width, num_keypoints,
                                    compute_dtype=compute_dtype)
        elif head_type == "fused":
            self.head = FusedHead(width, num_keypoints,
                                  compute_dtype=compute_dtype, norm=norm)
        else:
            self.head = SimCCHead(width, num_keypoints, input_size,
                                  simcc_split_ratio,
                                  compute_dtype=compute_dtype)
        self.calibration = (Calibration(self, convs=conv_net) if calibrate
                            else None)

    def forward(self, x: torch.Tensor,
                drop_masks: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``drop_masks``: the backbone's DropPath keep masks, for
        training (see HRFormer.forward; None for HRNet)."""
        with calibrating(self.calibration):
            return self.head(self.backbone(x.to(self.compute_dtype),
                                           drop_masks))


def resolve_device(device) -> torch.device:
    """The torch.device an entry point runs on.  Asking for CUDA where
    there is none raises: the port never carries on on the CPU unless the
    caller passes ``device="cpu"``."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(device)!r} asked for, but CUDA is not available; "
            f"pass device='cpu' to run on the CPU")
    return dev


def build_model(cfg, device="cuda", grid=None, fold: bool = False,
                quant: bool = False, calibrate: bool = False,
                tensor_parallel: bool = False) -> PoseEstimator:
    """PoseEstimator from a Config, with seeded weights (``cfg.train.seed``,
    see weights.init_weights), in eval mode on ``device``.  ``grid``: a
    parallel.ProcessGrid whose device is ``device``'s kind; the model is
    built on the grid's device, its W-MSA runs K3 over the grid and its
    train-mode BatchNorm statistics are global over the grid's data
    group.  ``fold``: the BN-folded serving model (models/fold.py), its
    weights the fold of the seeded float model's.  ``calibrate``: the
    seeded float model, recording its calibration points.  ``quant``: the
    int8 PTQ serving model, its buffers unset until the state dict of
    ``models.quantize.quantize_model`` is loaded into it (load it whole,
    then ``parallel.shard_params``).  ``tensor_parallel``: under ``grid``,
    the seeded (or folded) model is built whole and then cut by
    ``parallel.shard_params``, so every rank holds the one-process
    model's weights, its block of rows of each sharded one."""
    from ..parallel.tensor import shard_params
    from ..weights import init_weights

    device = resolve_device(device)
    if grid is not None:
        if grid.device.type != device.type:
            raise ValueError(f"the grid's ranks run on {grid.device}, not "
                             f"{device}")
        device = grid.device
    kw = dict(
        backbone_name=cfg.model.backbone,
        head_type=cfg.model.head_type,
        num_keypoints=cfg.data.num_keypoints,
        hidden_dim=cfg.model.hidden_dim,
        window_size=cfg.model.hrformer_window_size,
        compute_dtype=COMPUTE_DTYPES[cfg.model.compute_dtype],
        remat=cfg.model.remat,
        use_pallas=cfg.model.use_pallas,
        stage_modules=tuple(cfg.model.hrnet_stage_modules) or None,
        norm=cfg.model.norm,
        input_size=tuple(cfg.data.input_size),
        simcc_split_ratio=cfg.model.simcc_split_ratio)
    if quant:
        model = PoseEstimator(**kw, quant=True)
    else:
        model = init_weights(PoseEstimator(**kw, calibrate=calibrate),
                             cfg.train.seed)
        if fold:
            folded = PoseEstimator(**kw, fold=True)
            folded.load_state_dict(fold_state_dict(model.state_dict()),
                                   strict=True)
            model = folded
    if grid is not None:
        for m in model.modules():
            if isinstance(m, (BatchNorm, WindowAttention)):
                m.grid = grid
    model = model.to(device).eval()
    if not quant:  # an int8 model is cut once its buffers are loaded
        shard_params(model, grid, tensor_parallel)
    return model


def decode_outputs(outputs: Dict[str, torch.Tensor], head_type: str,
                   decode_method: str = "quarter",
                   softargmax_beta: float = 1.0, refine_radius: int = 2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Head outputs -> (coords (B, K, 2), scores (B, K)).  The SimCC head
    decodes by its softmax expectation (``SimCCHead.decode`` at its
    default split ratio, as the JAX function), to input pixels; the others
    to heatmap pixels: the fusion head by sub-pixel fusion, the heatmap and
    fused heads by ``decode_method``: "taylor", "softargmax", or else the
    quarter shift."""
    if head_type == "simcc":
        return SimCCHead.decode(outputs["simcc_x"], outputs["simcc_y"])
    if head_type == "fusion":
        return decode_ops.fusion_decode(
            outputs["heatmaps"], outputs["offsets"],
            outputs["subpixel_alpha_logit"], outputs["fusion_weight_logit"],
            beta=softargmax_beta, radius=refine_radius)
    if decode_method == "taylor":
        return decode_ops.taylor_decode(outputs["heatmaps"])
    if decode_method == "softargmax":
        return decode_ops.soft_argmax(outputs["heatmaps"], softargmax_beta)
    return decode_ops.quarter_shift_decode(outputs["heatmaps"])


def _need_heatmaps(head_type: str) -> None:
    if head_type == "simcc":
        raise ValueError("the simcc head outputs no heatmaps to flip or "
                         "rescale: serve it with flip=False at one scale")


def to_input_pixels(cfg) -> Tuple[float, float]:
    """The factors (x, y) that take ``decode_outputs``' coords to input
    pixels: the heatmap stride, (W / heatmap W, H / heatmap H), for the
    heads that decode heatmaps; 1 for the SimCC head, whose coords are in
    input pixels already (the JAX package scales them by the stride too,
    which puts its SimCC keypoints 4x off)."""
    if cfg.model.head_type == "simcc":
        return 1.0, 1.0
    W, H = cfg.data.input_size
    hm_w, hm_h = cfg.data.heatmap_size
    return W / hm_w, H / hm_h


def flip_inference(model: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                   images: torch.Tensor, flip_index: torch.Tensor,
                   head_type: str, decode_method: str = "quarter",
                   shift_heatmap: bool = False, flip: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on NHWC images and their mirror, un-mirror and average the
    heatmaps (the other outputs from the unflipped pass), then decode with
    ``decode_outputs``' defaults.  The flip test needs heatmaps: with the
    SimCC head it raises (pass ``flip=False``)."""
    outputs = model(images)
    if not flip:
        return decode_outputs(outputs, head_type, decode_method)
    _need_heatmaps(head_type)
    flipped = model(torch.flip(images, dims=[2]))
    hm_f = decode_ops.flip_heatmaps(flipped["heatmaps"], flip_index,
                                    shift=shift_heatmap)
    merged = dict(outputs)
    merged["heatmaps"] = (outputs["heatmaps"] + hm_f) * 0.5
    return decode_outputs(merged, head_type, decode_method)


def multiscale_flip_inference(
        model: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
        images: torch.Tensor, flip_index: torch.Tensor, head_type: str,
        scales: Tuple[float, ...] = (1.0,), decode_method: str = "quarter",
        shift_heatmap: bool = False, flip: bool = True
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-scale + flip test-time augmentation (the JAX package's
    ``multiscale_flip_inference``): the forward (and its mirror) at each
    scale, the image resized to sides snapped to multiples of 32; each
    scale's flip-averaged heatmaps resized back to the first scale's
    size; their mean decoded once, the other outputs from the first
    scale's unflipped pass."""
    _need_heatmaps(head_type)
    B, H, W, _ = images.shape
    base_outputs, base_hw, acc = None, None, None
    for s in scales:
        if s == 1.0:
            imgs_s = images
        else:
            hs = max(32, int(round(H * s / 32)) * 32)
            ws = max(32, int(round(W * s / 32)) * 32)
            imgs_s = resize_bilinear(images, hs, ws)
        outputs = model(imgs_s)
        hm = outputs["heatmaps"]
        if flip:
            flipped = model(torch.flip(imgs_s, dims=[2]))
            hm_f = decode_ops.flip_heatmaps(flipped["heatmaps"], flip_index,
                                            shift=shift_heatmap)
            hm = (hm + hm_f) * 0.5
        if base_outputs is None:
            base_outputs = dict(outputs)
            base_hw = hm.shape[1:3]
        if hm.shape[1:3] != base_hw:
            hm = resize_bilinear(hm, base_hw[0], base_hw[1])
        acc = hm if acc is None else acc + hm
    base_outputs["heatmaps"] = acc / float(len(scales))
    return decode_outputs(base_outputs, head_type, decode_method)
