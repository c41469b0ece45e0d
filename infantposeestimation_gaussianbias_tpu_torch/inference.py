"""High-level inference API: batches of frames with boxes, or one image.

Port of ``PoseInference`` in infantposeestimation_gaussianbias_tpu/
inference.py: crop + normalise -> flip-tested forward -> decode (fusion
decode for the fusion head; ``cfg.eval.decode`` for the heatmap head) ->
back-projection, all on ``device`` for a whole batch of crops.  Serving
runs eval-mode BatchNorm: the JAX package's BN-fold is the same maths
with other roundings and is not ported.  Frames
cross to the device as uint8, and every batch is padded to a power-of-two
bucket by repeating its last row, with results trimmed back.

``mesh`` (a parallel.ProcessGrid) serves over a process grid, as the JAX
``PoseInference(mesh=...)`` does over a device mesh: every rank is handed
the same full request; the rows, padded to their bucket and then to a
multiple of the 'data' axis (the last row repeated, JAX's order), are
split over the data ranks; each data rank crops, runs the model (its
W-MSA is K3 over the grid) and decodes its rows; the keypoints and scores
are gathered, so every rank returns the whole trimmed result.
"""

from __future__ import annotations

from typing import Mapping, Optional, Sequence, Tuple

import numpy as np
import torch

from .models import build_model, flip_inference, resolve_device
from .ops import affine
from .ops import decode as decode_ops
from .parallel.mesh import TENSOR_PARALLEL_TODO, gather_data_rows, shard_batch


def detect_persons(image: np.ndarray) -> list:
    """Full-image bbox placeholder detector."""
    h, w = image.shape[:2]
    return [np.array([0, 0, w, h], np.float32)]


class PoseInference:
    """Pose predictor on ``device`` (the CUDA card unless the caller asks
    for ``"cpu"``).  Weights come from ``state_dict`` (the reference
    checkpoint's naming) or, when it is None, from the seeded
    initialisation of ``build_model`` (``cfg.train.seed``).  ``mesh``: a
    ProcessGrid to serve over (see the module doc); the model then runs on
    the grid's device.  ``tensor_parallel`` is not ported and raises."""

    def __init__(self, cfg,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device="cuda", mesh=None, tensor_parallel: bool = False):
        if tensor_parallel:
            raise NotImplementedError(TENSOR_PARALLEL_TODO)
        self.cfg = cfg
        self.schema = cfg.data.keypoint_schema
        self.mesh = mesh
        self.model = build_model(cfg, resolve_device(device), mesh)
        self.device = next(self.model.parameters()).device
        if state_dict is not None:
            self.model.load_state_dict(state_dict, strict=True)
        self._flip_index = torch.as_tensor(self.schema.flip_index(),
                                           device=self.device)

    @torch.inference_mode()
    def _pipeline(self, frames: torch.Tensor, centers: torch.Tensor,
                  scales: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        W, H = cfg.data.input_size
        hm_w, hm_h = cfg.data.heatmap_size
        crops = affine.crop_and_normalize(
            frames, centers, scales, (W, H),
            mean=cfg.data.pixel_mean, std=cfg.data.pixel_std)
        coords, scores = flip_inference(
            self.model, crops, self._flip_index, cfg.model.head_type,
            cfg.eval.decode, shift_heatmap=cfg.eval.shift_heatmap,
            flip=cfg.eval.flip_test)
        coords = coords * torch.tensor([W / hm_w, H / hm_h],
                                       dtype=torch.float32, device=self.device)
        coords = decode_ops.transform_preds(coords, centers, scales, (W, H))
        return coords, scores

    @staticmethod
    def _bucket_rows(n: int) -> int:
        """Next power-of-two batch bucket."""
        return 1 << max(0, int(n - 1).bit_length())

    def predict_batch(self, frames: np.ndarray, bboxes: np.ndarray
                      ) -> Tuple[np.ndarray, np.ndarray]:
        """frames (B, H, W, 3) RGB uint8 of one size; bboxes (B, 4) xyxy.

        Returns keypoints (B, K, 2) in frame coordinates and scores (B, K).
        """
        bboxes = np.asarray(bboxes, np.float32)
        n = bboxes.shape[0]
        centers = (bboxes[:, :2] + bboxes[:, 2:]) / 2.0
        scales = (bboxes[:, 2:] - bboxes[:, :2]) * self.cfg.data.bbox_padding
        frames = np.asarray(frames)
        pad = self._bucket_rows(n) - n
        if pad:
            frames = np.concatenate([frames, np.repeat(frames[-1:], pad, 0)])
            centers = np.concatenate(
                [centers, np.repeat(centers[-1:], pad, 0)])
            scales = np.concatenate([scales, np.repeat(scales[-1:], pad, 0)])
        if self.mesh is not None:
            pad = -frames.shape[0] % self.mesh.data
            frames, centers, scales = (
                np.concatenate([x, np.repeat(x[-1:], pad, 0)])
                for x in (frames, centers, scales))
            frames, centers, scales = (shard_batch(x, self.mesh)
                                       for x in (frames, centers, scales))

        def put(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        coords, scores = self._pipeline(put(frames), put(centers), put(scales))
        coords, scores = coords.cpu().numpy(), scores.cpu().numpy()
        if self.mesh is not None:
            coords, scores = gather_data_rows((coords, scores), self.mesh)
        return coords[:n], scores[:n]

    def predict(self, image: np.ndarray, bbox: Optional[Sequence] = None
                ) -> Tuple[np.ndarray, np.ndarray]:
        """Single RGB image + optional xyxy bbox (defaults to full image)."""
        if bbox is None:
            bbox = detect_persons(image)[0]
        kpts, scores = self.predict_batch(image[None],
                                          np.asarray(bbox, np.float32)[None])
        return kpts[0], scores[0]
