"""PyTorch + CUDA port of the pose estimation framework, for NVIDIA Hopper.

HRFormer + fusion head, on one CUDA device:
* serving: ``PoseInference.predict_batch`` crops, runs the flip-tested
  forward and decodes;
* training: ``make_train_step(cfg)`` on ``create_train_state(cfg)``
  generates Gaussian targets, runs the forward, the six-term loss, the
  backward and the AdamW update.
The window attention core is a pair of hand-written CUDA kernels
(``kernels/window_msa.py``: K1 forward in ``csrc/window_msa.cu``, K2
backward in ``csrc/window_msa_bwd.cu``).  With ``IPE_FUSED_BLOCK=1`` (or
``auto``) in the environment, the transformer blocks instead run as the
fused half-block kernels (``kernels/fused_block.py``: K4 attention half in
``csrc/fused_attn.cu``, K5 MLP half in ``csrc/fused_mlp.cu``, forward and
backward).  Entry points run on the card unless the caller passes
``device="cpu"``; on the CPU every kernel wrapper takes its plain PyTorch
version.

The package imports torch and numpy, never jax, and nothing of the JAX
package: ``config`` and ``schemas`` are its own copies.
"""

from .config import Config, get_config, get_variant
from .inference import PoseInference
from .train import create_train_state, make_train_step

__all__ = ["Config", "PoseInference", "create_train_state", "get_config",
           "get_variant", "make_train_step"]
