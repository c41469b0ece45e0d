"""The port's twin of the repository root's ``__graft_entry__.entry()``:
the flagship model's end-to-end forward, for a compile-and-run check.

The flagship model is HRNet-W32 + the fusion head at 256x192 input
(W, H) = (192, 256) and (48, 64) heatmaps, in the config's compute dtype
(bf16 by default), with the seeded weights of ``build_model``
(``cfg.train.seed``) unless a state dict is given.  Its function maps
(B, 256, 192, 3) float32 normalised images to sub-pixel fusion-decoded
coords (B, 17, 2) in heatmap pixels and scores (B, 17); the example
arguments are four zero images, as the JAX entry's.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Tuple

import torch

from .config import Config
from .models import build_model, decode_outputs


def flagship_cfg(compute_dtype: Optional[str] = None) -> Config:
    """``__graft_entry__._flagship_cfg()``; ``compute_dtype`` ("float32"
    or "bfloat16") overrides the config's."""
    cfg = Config()
    cfg.model.backbone = "hrnet_w32"
    cfg.model.head_type = "fusion"
    cfg.data.input_size = (192, 256)
    cfg.data.heatmap_size = (48, 64)
    if compute_dtype is not None:
        cfg.model.compute_dtype = compute_dtype
    return cfg


def entry(device="cuda",
          state_dict: Optional[Mapping[str, torch.Tensor]] = None,
          compute_dtype: Optional[str] = None
          ) -> Tuple[Callable, Tuple[torch.Tensor]]:
    """(fn, example_args): the flagship forward then ``decode_outputs``,
    on ``device`` (the card unless the caller asks for "cpu")."""
    cfg = flagship_cfg(compute_dtype)
    model = build_model(cfg, device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    W, H = cfg.data.input_size
    images = torch.zeros((4, H, W, 3), dtype=torch.float32,
                         device=next(model.parameters()).device)

    @torch.inference_mode()
    def forward(imgs: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return decode_outputs(model(imgs), cfg.model.head_type)

    return forward, (images,)
