"""Models: the HRNet, HRFormer and LiteHRNet backbones, the heatmap,
fusion, fused and SimCC heads, their assembly, the attention add-ons
(CBAM, the transformer neck), the BN-fold serving transform and int8
PTQ."""

from .attention import CBAM, TransformerNeck
from .heads import FusedHead, FusionHead, HeatmapHead, SimCCHead
from .hrformer import HRFormer, hrformer_base, hrformer_small
from .hrnet import HRNet, hrnet_w32, hrnet_w48
from .litehrnet import LiteHRNet
from .fold import fold_state_dict
from .pose_estimator import (BACKBONES, PoseEstimator, build_model,
                             decode_outputs, flip_inference,
                             multiscale_flip_inference, resolve_device,
                             serving_mode_supported, to_input_pixels,
                             validate_serving_mode)
from .quantize import calibrate, quantize_model

__all__ = ["BACKBONES", "CBAM", "FusedHead", "FusionHead", "HRFormer",
           "HRNet", "HeatmapHead", "LiteHRNet", "PoseEstimator",
           "SimCCHead", "TransformerNeck", "build_model", "calibrate",
           "decode_outputs", "flip_inference", "fold_state_dict",
           "hrformer_base", "hrformer_small", "hrnet_w32", "hrnet_w48",
           "multiscale_flip_inference", "quantize_model",
           "resolve_device", "serving_mode_supported", "to_input_pixels",
           "validate_serving_mode"]
