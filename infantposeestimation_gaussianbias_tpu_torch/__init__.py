"""PyTorch + CUDA port of the pose estimation framework, for NVIDIA Hopper.

The serving path of HRFormer + fusion head: ``PoseInference.predict_batch``
crops, runs the flip-tested forward and decodes on one CUDA device, with
the window attention core in a hand-written CUDA kernel
(``kernels/window_msa.py``, ``csrc/window_msa.cu``).  On the CPU every
kernel wrapper takes its plain PyTorch version.

The package imports torch and numpy, never jax.  It reuses the JAX
package's framework-neutral ``config`` (dataclasses) and ``schemas``.
"""

from infantposeestimation_gaussianbias_tpu.config import (Config, get_config,
                                                          get_variant)

from .inference import PoseInference

__all__ = ["Config", "PoseInference", "get_config", "get_variant"]
