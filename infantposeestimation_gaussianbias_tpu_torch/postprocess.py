"""Post-processing: confidence filter, streaming smoother, pose NMS and the
whole Stack-B pipeline.

Port of infantposeestimation_gaussianbias_tpu/postprocess.py.  The batched
functions run on the tensors' device in float32; ``StreamingSmoother`` is
host-side numpy (K x 2 values a frame).
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from .ops import decode as decode_ops


def filter_low_confidence(preds: torch.Tensor, maxvals: torch.Tensor,
                          threshold: float = 0.3
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Zero the coordinates whose confidence is <= threshold; preds
    (B, K, 2), maxvals (B, K).  Returns (preds, float mask)."""
    mask = (maxvals > threshold).float()
    return preds * mask[..., None], mask


class StreamingSmoother:
    """Per-frame One-Euro smoother for a live pose stream: carries the
    filter's state across calls and reproduces
    ``ops.decode.one_euro_smooth`` when fed a trajectory frame by frame.

    >>> smoother = StreamingSmoother(fps=30.0)
    >>> for coords, scores in infer.predict_stream(batches):
    ...     smoothed = smoother(coords[0])
    """

    def __init__(self, fps: float = 30.0, min_cutoff: float = 1.0,
                 beta: float = 0.007, d_cutoff: float = 1.0):
        self.dt = 1.0 / fps
        self.min_cutoff = min_cutoff
        self.beta = beta
        self.d_cutoff = d_cutoff
        self._x = None
        self._dx = None

    def _alpha(self, cutoff):
        tau = 1.0 / (2.0 * np.pi * cutoff)
        return 1.0 / (1.0 + tau / self.dt)

    def __call__(self, coords) -> np.ndarray:
        """One frame (K, 2) in, smoothed (K, 2) out (float32 numpy)."""
        x = np.asarray(coords, np.float32)
        if self._x is None:
            self._x = x
            self._dx = np.zeros_like(x)
            return x
        dx = (x - self._x) / self.dt
        a_d = self._alpha(self.d_cutoff)
        dx_hat = a_d * dx + (1 - a_d) * self._dx
        a = self._alpha(self.min_cutoff + self.beta * np.abs(dx_hat))
        x_hat = a * x + (1 - a) * self._x
        self._x, self._dx = x_hat, dx_hat
        return x_hat

    def reset(self) -> None:
        self._x = self._dx = None


def nms_pose(preds: torch.Tensor, maxvals: torch.Tensor,
             distance_threshold: float = 5.0
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy within-pose keypoint NMS: keypoint by keypoint, one still
    kept suppresses every keypoint within the distance threshold but the
    most confident of that neighbourhood (the first on a tie).  Returns
    (preds with the suppressed zeroed, keep (B, K) bool)."""
    B, K, _ = preds.shape
    d = ((preds[:, :, None, :] - preds[:, None, :, :]) ** 2).sum(-1).sqrt()
    idx = torch.arange(K, device=preds.device)
    keep = torch.ones(B, K, dtype=torch.bool, device=preds.device)
    for k in range(K):
        nearby = d[:, k] < distance_threshold  # includes k itself
        best = torch.where(nearby, maxvals, -torch.inf).argmax(dim=-1)
        new_keep = keep & ~(nearby & (idx != best[:, None]))
        keep = torch.where(keep[:, k:k + 1], new_keep, keep)
    return preds * keep[..., None].to(preds.dtype), keep


def postprocess_predictions(outputs: Dict[str, torch.Tensor],
                            batch_meta: Dict[str, torch.Tensor],
                            fusion_alpha: float = 0.5,
                            conf_threshold: float = 0.3,
                            image_size: float = 256.0,
                            refine_window: int = 5
                            ) -> Dict[str, torch.Tensor]:
    """Stack-B pipeline: Taylor decode -> window-centroid refinement (in
    heatmap pixels) -> scale to ``image_size`` -> adaptive blend with the
    normalised regression ``coords`` where given -> confidence filter ->
    back-projection with ``center``/``scale`` where given.

    outputs: heatmaps (B, H, W, K) [+ coords (B, K, 2)]; batch_meta:
    center (B, 2), scale (B, 2), optional."""
    heatmaps = outputs["heatmaps"]
    B, H, W, K = heatmaps.shape
    reg = outputs.get("coords")
    hm_coords, maxvals = decode_ops.taylor_decode(heatmaps)
    hm_coords = decode_ops.window_centroid_refine(heatmaps, hm_coords,
                                                  refine_window)
    scale_to_img = torch.tensor([image_size / W, image_size / H],
                                dtype=torch.float32, device=heatmaps.device)
    preds = hm_coords * scale_to_img
    if reg is not None:
        a = (maxvals / (maxvals + 0.1))[..., None]  # adaptive alpha
        preds = a * preds + (1.0 - a) * reg * image_size
    preds, mask = filter_low_confidence(preds, maxvals, conf_threshold)
    if "center" in batch_meta and "scale" in batch_meta:
        preds = decode_ops.transform_preds(
            preds, batch_meta["center"], batch_meta["scale"],
            (image_size, image_size))
    return {"preds": preds, "maxvals": maxvals, "mask": mask}
