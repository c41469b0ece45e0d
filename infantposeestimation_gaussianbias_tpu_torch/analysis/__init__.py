"""Measurement and analysis: the benchmark harness (``benchmark``), model
introspection (``introspection``), extended keypoint schemas
(``extension``) and the plots (``plots``, matplotlib imported when a
figure is drawn)."""

from .benchmark import (benchmark_model, benchmark_pipeline,
                        measure_inference_time, profile_trace)
from .extension import (TEMPLATES, COCOKeypointExtender,
                        detect_keypoint_groups, split_group_targets)
from .introspection import (activation_statistics, capture_activations,
                            confidence_calibration, count_parameters,
                            error_distribution, grad_cam,
                            gradient_statistics, mc_droppath_uncertainty,
                            occlusion_sensitivity, parameter_summary,
                            per_layer_parameters, saliency_map,
                            weight_statistics)

__all__ = ["TEMPLATES", "COCOKeypointExtender", "activation_statistics",
           "benchmark_model", "benchmark_pipeline", "capture_activations",
           "confidence_calibration", "count_parameters",
           "detect_keypoint_groups", "error_distribution", "grad_cam",
           "gradient_statistics", "mc_droppath_uncertainty",
           "measure_inference_time", "occlusion_sensitivity",
           "parameter_summary", "per_layer_parameters", "profile_trace",
           "saliency_map", "split_group_targets", "weight_statistics"]
