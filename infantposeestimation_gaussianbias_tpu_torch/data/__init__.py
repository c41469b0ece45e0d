"""Data pipeline pieces of the port: for now the device-transfer prefetch
stage that ``PoseInference.predict_stream`` uses."""

from .pipeline import prefetch_to_device

__all__ = ["prefetch_to_device"]
