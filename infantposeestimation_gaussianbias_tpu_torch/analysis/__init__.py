"""Measurement and analysis: the benchmark harness (``benchmark``) and
model introspection (``introspection``)."""

from .benchmark import (benchmark_model, benchmark_pipeline,
                        measure_inference_time, profile_trace)
from .introspection import (activation_statistics, capture_activations,
                            confidence_calibration, count_parameters,
                            error_distribution, grad_cam,
                            gradient_statistics, mc_droppath_uncertainty,
                            occlusion_sensitivity, parameter_summary,
                            per_layer_parameters, saliency_map,
                            weight_statistics)

__all__ = ["activation_statistics", "benchmark_model", "benchmark_pipeline",
           "capture_activations", "confidence_calibration",
           "count_parameters", "error_distribution", "grad_cam",
           "gradient_statistics", "mc_droppath_uncertainty",
           "measure_inference_time", "occlusion_sensitivity",
           "parameter_summary", "per_layer_parameters", "profile_trace",
           "saliency_map", "weight_statistics"]
