"""Models: HRNet and HRFormer backbones, the heatmap and fusion heads and
their assembly."""

from .heads import FusionHead, HeatmapHead
from .hrformer import HRFormer, hrformer_base, hrformer_small
from .hrnet import HRNet, hrnet_w32, hrnet_w48
from .pose_estimator import (BACKBONES, PoseEstimator, build_model,
                             decode_outputs, flip_inference, resolve_device)

__all__ = ["BACKBONES", "FusionHead", "HRFormer", "HRNet", "HeatmapHead",
           "PoseEstimator", "build_model", "decode_outputs", "flip_inference",
           "hrformer_base", "hrformer_small", "hrnet_w32", "hrnet_w48",
           "resolve_device"]
