"""PoseEstimator (backbone + head), its factory, decode and flip test.

Port of infantposeestimation_gaussianbias_tpu/models/pose_estimator.py for
the HRFormer backbones and the fusion head.  ``flip_inference`` keeps the
reference's flip-test contract: heatmaps are averaged with the mirrored
pass, while offsets and the decode logits come from the unflipped pass.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn as nn

from ..ops import decode as decode_ops
from .heads import FusionHead
from .hrformer import hrformer_base, hrformer_small

BACKBONES: Dict[str, Callable[..., nn.Module]] = {
    "hrformer_base": hrformer_base,
    "hrformer_small": hrformer_small,
}

COMPUTE_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


class PoseEstimator(nn.Module):
    """Backbone + fusion head.  NHWC images in, dict of NHWC maps out."""

    def __init__(self, backbone_name: str = "hrformer_base",
                 num_keypoints: int = 17, hidden_dim: int = 256,
                 window_size: int = 7,
                 compute_dtype: torch.dtype = torch.float32,
                 remat: bool = False, use_pallas: bool = False):
        super().__init__()
        if backbone_name not in BACKBONES:
            raise ValueError(f"Unknown backbone {backbone_name!r}; "
                             f"known: {sorted(BACKBONES)}")
        self.compute_dtype = compute_dtype
        self.backbone = BACKBONES[backbone_name](
            compute_dtype=compute_dtype, window_size=window_size,
            remat=remat, use_pallas=use_pallas)
        self.head = FusionHead(self.backbone.channels[0], num_keypoints,
                               hidden_dim, compute_dtype=compute_dtype)

    def forward(self, x: torch.Tensor,
                drop_masks: Optional[torch.Tensor] = None
                ) -> Dict[str, torch.Tensor]:
        """``drop_masks``: the backbone's DropPath keep masks, for
        training (see HRFormer.forward)."""
        return self.head(self.backbone(x.to(self.compute_dtype), drop_masks))


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


def build_model(cfg, device="cuda") -> PoseEstimator:
    """PoseEstimator from a Config, with seeded weights (``cfg.train.seed``,
    see weights.init_weights), in eval mode on ``device``."""
    from ..weights import init_weights

    device = resolve_device(device)
    if cfg.model.head_type != "fusion":
        raise ValueError(f"the port has the fusion head only, not "
                         f"{cfg.model.head_type!r}")
    model = PoseEstimator(
        backbone_name=cfg.model.backbone,
        num_keypoints=cfg.data.num_keypoints,
        hidden_dim=cfg.model.hidden_dim,
        window_size=cfg.model.hrformer_window_size,
        compute_dtype=COMPUTE_DTYPES[cfg.model.compute_dtype],
        remat=cfg.model.remat,
        use_pallas=cfg.model.use_pallas)
    init_weights(model, cfg.train.seed)
    return model.to(device).eval()


def decode_outputs(outputs: Dict[str, torch.Tensor],
                   softargmax_beta: float = 1.0, refine_radius: int = 2
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Fusion-head outputs -> (coords (B, K, 2) in heatmap pixels,
    scores (B, K))."""
    return decode_ops.fusion_decode(
        outputs["heatmaps"], outputs["offsets"],
        outputs["subpixel_alpha_logit"], outputs["fusion_weight_logit"],
        beta=softargmax_beta, radius=refine_radius)


def flip_inference(model: Callable[[torch.Tensor], Dict[str, torch.Tensor]],
                   images: torch.Tensor, flip_index: torch.Tensor,
                   shift_heatmap: bool = False, flip: bool = True
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward on NHWC images and their mirror, un-mirror and average the
    heatmaps, then decode with ``decode_outputs``' defaults."""
    outputs = model(images)
    if not flip:
        return decode_outputs(outputs)
    flipped = model(torch.flip(images, dims=[2]))
    hm_f = decode_ops.flip_heatmaps(flipped["heatmaps"], flip_index,
                                    shift=shift_heatmap)
    merged = dict(outputs)
    merged["heatmaps"] = (outputs["heatmaps"] + hm_f) * 0.5
    return decode_outputs(merged)
