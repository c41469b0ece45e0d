"""Models: HRNet and HRFormer backbones, the heatmap and fusion heads,
their assembly, the BN-fold serving transform and int8 PTQ."""

from .heads import FusionHead, HeatmapHead
from .hrformer import HRFormer, hrformer_base, hrformer_small
from .hrnet import HRNet, hrnet_w32, hrnet_w48
from .fold import fold_state_dict
from .pose_estimator import (BACKBONES, PoseEstimator, build_model,
                             decode_outputs, flip_inference,
                             multiscale_flip_inference, resolve_device,
                             serving_mode_supported, validate_serving_mode)
from .quantize import calibrate, quantize_model

__all__ = ["BACKBONES", "FusionHead", "HRFormer", "HRNet", "HeatmapHead",
           "PoseEstimator", "build_model", "calibrate", "decode_outputs",
           "flip_inference", "fold_state_dict", "hrformer_base",
           "hrformer_small", "hrnet_w32", "hrnet_w48",
           "multiscale_flip_inference", "quantize_model", "resolve_device",
           "serving_mode_supported", "validate_serving_mode"]
