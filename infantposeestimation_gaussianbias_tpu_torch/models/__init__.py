"""Models: HRFormer backbones, the fusion head and their assembly."""

from .heads import FusionHead
from .hrformer import HRFormer, hrformer_base, hrformer_small
from .pose_estimator import (BACKBONES, PoseEstimator, build_model,
                             decode_outputs, flip_inference, resolve_device)

__all__ = ["BACKBONES", "FusionHead", "HRFormer", "PoseEstimator",
           "build_model", "decode_outputs", "flip_inference",
           "hrformer_base", "hrformer_small", "resolve_device"]
