"""High-level inference API: batches of frames with boxes, one image, a
stream of crop batches, a directory of images, a video.

Port of ``PoseInference`` in infantposeestimation_gaussianbias_tpu/
inference.py: crop + normalise -> flip-tested forward -> decode (fusion
decode for the fusion head; ``cfg.eval.decode`` for the heatmap and fused
heads; the SimCC head's expectation, served with ``cfg.eval.flip_test``
off) -> back-projection, all on ``device`` for a whole batch of crops.
Every backbone and head of ``models.BACKBONES`` serves; LiteHRNet and the
fused and SimCC heads unfolded (``validate_serving_mode``).  The SimCC
head's coords are input pixels already and skip the heatmap stride
(``models.to_input_pixels``), where the JAX package scales them too.

Float serving folds BatchNorm into the convs by default wherever the
architecture allows it (models/fold.py: hrnet/hrformer backbones, fusion
or heatmap head, BatchNorm), as the JAX package does; ``fold=False``
serves eval-mode BatchNorm.  The fold leaves the transformer blocks, and
so the W-MSA kernels (K1, or K4/K5 under ``IPE_FUSED_BLOCK``), as they
are.

``quantize=True`` serves int8 PTQ (ops/quant.py, models/quantize.py), as
the JAX ``PoseInference(quantize=True)``: the float model is calibrated on
``calibration_crops`` (normalised (N, H, W, 3) crops) at construction, or
else on the first predicted batch's crops, with a warning below
``MIN_SELF_CALIB_CROPS``; from then on every forward is the int8 model
(HRNet: K9 for every ConvNorm; HRFormer: K10 for its wide Dense layers and
K1 unfused).  int8 takes precedence over BN-fold.  The quantized model is
installed once, under a lock: concurrent first batches (the server's
dispatch threads) calibrate once.

``predict_batch`` takes uint8 frames, which cross to the device as uint8;
every batch is padded to a power-of-two bucket by repeating its last row,
with results trimmed back, for the reason the JAX package pads: the
micro-batcher (cli/serve.py) and the directory loop form batches of any
size, and the kernels' launch plans are cached per batch size, so
buckets bound their number.
``predict_stream`` overlaps the host, the host-to-device copy
(data/pipeline.py ``prefetch_to_device``) and the device on batches of
uint8 crops.  ``predict_directory`` and ``predict_video`` are host loops
over ``predict_batch`` that decode with the native loader (native/) or
cv2.

``mesh`` (a parallel.ProcessGrid) serves over a process grid, as the JAX
``PoseInference(mesh=...)`` does over a device mesh: every rank is handed
the same full request; the rows, padded to their bucket and then to a
multiple of the 'data' axis (the last row repeated, JAX's order), are
split over the data ranks; each data rank crops, runs the model (its
W-MSA is K3 over the grid) and decodes its rows; the keypoints and scores
are gathered, so every rank returns the whole trimmed result.  With
``tensor_parallel`` the weights JAX's rule shards are cut over the model
axis after the fold (parallel/tensor.py): each model rank computes its
block of those layers' output features and assembles the rest over the
model group.  int8 over a grid calibrates each data rank on its rows and
takes the maximum of every abs-max over the data group, so the scales are
those of one process calibrating on the global batch; the int8 model is
then built whole and cut by the same rule (which leaves the int8 buffers
replicated, as JAX's rule leaves its ``w_int8`` leaves).
``predict_stream`` over a grid pads each batch to a multiple of the
'data' axis, stages the rank's rows, and gathers each result in order,
every collective on the consumer's thread.
"""

from __future__ import annotations

import collections
import os
import threading
import warnings
from typing import (Dict, Iterable, Iterator, Mapping, Optional, Sequence,
                    Tuple)

import numpy as np
import torch

from .models import (build_model, flip_inference, fold_state_dict,
                     quantize_model, resolve_device, serving_mode_supported,
                     to_input_pixels, validate_serving_mode)
from .ops import affine
from .ops import decode as decode_ops
from .parallel.mesh import gather_data_rows, shard_batch
from .parallel.tensor import full_state_dict, shard_params


def detect_persons(image: np.ndarray) -> list:
    """Full-image bbox placeholder detector."""
    h, w = image.shape[:2]
    return [np.array([0, 0, w, h], np.float32)]


def forward_decode(model, cfg, flip_index: torch.Tensor, crops: torch.Tensor,
                   centers: torch.Tensor, scales: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Normalised crops -> flip-tested forward -> decode ->
    back-projection to the source frames: the served pipeline after the
    crop (``PoseInference``'s, and the exported program's of
    tools/export_model.py)."""
    coords, scores = flip_inference(
        model, crops, flip_index, cfg.model.head_type, cfg.eval.decode,
        shift_heatmap=cfg.eval.shift_heatmap, flip=cfg.eval.flip_test)
    coords = coords * torch.tensor(to_input_pixels(cfg), dtype=torch.float32,
                                   device=crops.device)
    coords = decode_ops.transform_preds(coords, centers, scales,
                                        cfg.data.input_size)
    return coords, scores


class PoseInference:
    """Pose predictor on ``device`` (the CUDA card unless the caller asks
    for ``"cpu"``).  Weights come from ``state_dict`` (the reference
    checkpoint's naming, float or already folded) or, when it is None,
    from the seeded initialisation of ``build_model`` (``cfg.train.seed``).
    ``fold``: None folds where ``serving_mode_supported`` says the
    architecture can, True folds (or raises, as ``validate_serving_mode``),
    False never does.  ``mesh``: a ProcessGrid to serve over (see the
    module doc); the model then runs on the grid's device.
    ``tensor_parallel``: under ``mesh``, cut the weights over its model
    axis (a no-op without one, as in JAX).  ``quantize``,
    ``calibration_crops``: int8 PTQ serving (see the module doc; under a
    grid every rank passes the same global crops)."""

    # PTQ abs-max ranges freeze after the first calibration; below this
    # many crops a single unrepresentative batch (one dark frame, say)
    # would degrade every later prediction.
    MIN_SELF_CALIB_CROPS = 32

    def __init__(self, cfg,
                 state_dict: Optional[Mapping[str, torch.Tensor]] = None,
                 device="cuda", mesh=None, tensor_parallel: bool = False,
                 fold: Optional[bool] = None, quantize: bool = False,
                 calibration_crops=None):
        if quantize:
            # fail fast on an architecture that does not quantize
            validate_serving_mode(cfg.model.backbone, cfg.model.head_type,
                                  cfg.model.norm, quant=True)
            fold = False  # int8 takes precedence over BN-fold
        elif fold is None:
            fold = serving_mode_supported(cfg.model.backbone,
                                          cfg.model.head_type,
                                          cfg.model.norm, fold=True)
        self.cfg = cfg
        self.fold = fold
        self.quantize = quantize
        self.schema = cfg.data.keypoint_schema
        self.mesh = mesh
        self.tensor_parallel = tensor_parallel
        self.model = build_model(cfg, resolve_device(device), mesh,
                                 fold=fold)
        self.device = next(self.model.parameters()).device
        if state_dict is not None:
            self.model.load_state_dict(
                fold_state_dict(state_dict) if fold else state_dict,
                strict=True)
        shard_params(self.model, mesh, tensor_parallel)
        self._flip_index = torch.as_tensor(self.schema.flip_index(),
                                           device=self.device)
        self._quant_lock = threading.Lock()
        self._quant_installed = False
        if quantize and calibration_crops is not None:
            crops = torch.as_tensor(calibration_crops)
            if mesh is not None:  # this data rank's rows of the global crops
                (rows,) = self._data_rows(crops.cpu().numpy())
                crops = torch.from_numpy(rows)
            self._install_quant(crops)

    # -- int8 serving -------------------------------------------------------

    def install_quantized(self, state_dict: Mapping[str, torch.Tensor]
                          ) -> None:
        """Serve the int8 model of ``state_dict`` (``models.quantize_model``'s
        output, made here or elsewhere: on the card, say, for a CPU
        replica; whole, under a grid too) from now on, without
        calibrating."""
        if not self.quantize:
            raise ValueError("install_quantized needs quantize=True")
        with torch.inference_mode(False):  # ordinary tensors in the model
            qmodel = build_model(self.cfg, self.device, self.mesh,
                                 quant=True)
            qmodel.load_state_dict(state_dict, strict=True)
            shard_params(qmodel, self.mesh, self.tensor_parallel)
        self.model = qmodel
        self._quant_installed = True

    def _install_quant(self, crops: torch.Tensor) -> None:
        """Calibrate the float model on ``crops`` (this data rank's rows
        under a grid, the abs-max taken over the data group), then serve
        its int8 model."""
        group = None if self.mesh is None else self.mesh.data_group
        with torch.inference_mode(False):
            qsd = quantize_model(self.cfg, full_state_dict(self.model),
                                 [crops], self.device, group=group)
        self.install_quantized(qsd)

    def _maybe_calibrate(self, crops: torch.Tensor) -> None:
        """Self-calibration on the first predicted batch's normalised crops
        (``quantize`` without ``calibration_crops``), once."""
        if not self.quantize or self._quant_installed:
            return
        with self._quant_lock:
            if self._quant_installed:
                return
            n = crops.shape[0] * (1 if self.mesh is None else self.mesh.data)
            if n < self.MIN_SELF_CALIB_CROPS:
                warnings.warn(
                    f"int8 PTQ self-calibrating on the first predicted batch "
                    f"of only {n} crop(s); activation ranges freeze here "
                    f"permanently. Pass calibration_crops (>= "
                    f"{self.MIN_SELF_CALIB_CROPS} representative crops) to "
                    f"PoseInference for stable quantization.", stacklevel=5)
            self._install_quant(crops)

    def _forward_decode(self, crops: torch.Tensor, centers: torch.Tensor,
                        scales: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
        return forward_decode(self.model, self.cfg, self._flip_index, crops,
                              centers, scales)

    @torch.inference_mode()
    def _pipeline(self, frames: torch.Tensor, centers: torch.Tensor,
                  scales: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        crops = affine.crop_and_normalize(
            frames, centers, scales, cfg.data.input_size,
            mean=cfg.data.pixel_mean, std=cfg.data.pixel_std)
        self._maybe_calibrate(crops)
        return self._forward_decode(crops, centers, scales)

    @torch.inference_mode()
    def crops_pipeline(self, crops_u8: torch.Tensor, centers: torch.Tensor,
                       scales: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
        """The served pipeline on (B, H, W, 3) uint8 crops already at the
        input size (``predict_stream``'s per-batch step): (x - mean * 255)
        / (std * 255), then ``_forward_decode``.  Device tensors out."""
        cfg = self.cfg
        mean = torch.tensor(cfg.data.pixel_mean, dtype=torch.float32,
                            device=self.device) * 255.0
        std = torch.tensor(cfg.data.pixel_std, dtype=torch.float32,
                           device=self.device) * 255.0
        crops = (crops_u8.float() - mean) / std
        self._maybe_calibrate(crops)
        return self._forward_decode(crops, centers.float(), scales.float())

    @staticmethod
    def _bucket_rows(n: int) -> int:
        """Next power-of-two batch bucket (see the module doc)."""
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
            frames, centers, scales = self._data_rows(frames, centers,
                                                      scales)

        def put(x: np.ndarray) -> torch.Tensor:
            return torch.from_numpy(np.ascontiguousarray(x)).to(self.device)

        return self._host(*self._pipeline(put(frames), put(centers),
                                          put(scales)), n)

    def _data_rows(self, *arrays: np.ndarray) -> tuple:
        """Each array padded to a multiple of the 'data' axis (its last row
        repeated) and cut to this data rank's rows."""
        pad = -arrays[0].shape[0] % self.mesh.data
        return tuple(shard_batch(np.concatenate([x, np.repeat(x[-1:], pad,
                                                              0)]),
                                 self.mesh) for x in arrays)

    def _host(self, coords: torch.Tensor, scores: torch.Tensor, n: int
              ) -> Tuple[np.ndarray, np.ndarray]:
        """A batch's results on the host, gathered over the grid, first
        ``n`` rows."""
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

    def predict_stream(self, batches: Iterable[Mapping],
                       max_in_flight: int = 2
                       ) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        """Overlapped serving of a stream of crop batches: dicts with
        ``image_u8`` (B, H, W, 3) uint8 crops at the input size and
        ``center``/``scale`` (B, 2) (the eval loader's contract).  A
        thread copies up to ``max_in_flight`` batches ahead to the device
        (``prefetch_to_device``); each batch's pipeline is queued on the
        device at once and its results read ``max_in_flight`` batches
        behind the front.  Yields (coords (B, K, 2) in source
        coordinates, scores (B, K)) numpy arrays per batch, in order.
        Under a grid every rank is handed the same batches and yields the
        whole results (see the module doc)."""
        from .data.pipeline import prefetch_to_device

        keys = ("image_u8", "center", "scale")

        def rows(it):
            for b in it:
                b = dict(b)
                b["_n"] = len(b["image_u8"])
                if self.mesh is not None:
                    b.update(zip(keys, self._data_rows(
                        *(np.asarray(b[k]) for k in keys))))
                yield b

        pending: collections.deque = collections.deque()
        staged = prefetch_to_device(rows(batches), size=max_in_flight,
                                    keys=keys, device=self.device)
        for batch in staged:
            out = self.crops_pipeline(batch["image_u8"], batch["center"],
                                      batch["scale"])
            pending.append((out, batch["_n"]))
            if len(pending) > max_in_flight:
                (c, s), n = pending.popleft()
                yield self._host(c, s, n)
        while pending:
            (c, s), n = pending.popleft()
            yield self._host(c, s, n)

    def predict_directory(self, directory: str,
                          exts=(".jpg", ".jpeg", ".png"),
                          batch_size: int = 32) -> Dict[str, Dict]:
        """Every image in a directory, full-frame boxes; images of one
        shape batch together up to ``batch_size``.  JPEG (and PNG, where
        the native build has libpng) decode natively, the rest with cv2.
        Returns {name: {"keypoints", "scores"}} in name order."""
        import cv2

        from . import native

        use_native = native.available()
        groups: Dict[tuple, list] = {}
        for name in sorted(os.listdir(directory)):
            lower = name.lower()
            if not lower.endswith(exts):
                continue
            path = os.path.join(directory, name)
            img = None
            if use_native and (lower.endswith((".jpg", ".jpeg"))
                               or (lower.endswith(".png")
                                   and native.has_png())):
                try:  # one pass straight to RGB
                    with open(path, "rb") as f:
                        img = native.decode_rgb(f.read())
                except (ValueError, OSError):
                    img = None  # a mislabelled format: cv2 below
            if img is None:
                img = cv2.imread(path)
                if img is None:
                    continue
                img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            groups.setdefault(img.shape, []).append((name, img))
        results = {}
        for shape, items in groups.items():
            h, w = shape[:2]
            bbox = np.array([0, 0, w, h], np.float32)
            for i in range(0, len(items), batch_size):
                chunk = items[i:i + batch_size]
                kpts, scores = self.predict_batch(
                    np.stack([im for _, im in chunk]),
                    np.tile(bbox, (len(chunk), 1)))
                for (name, _), k, s in zip(chunk, kpts, scores):
                    results[name] = {"keypoints": k, "scores": s}
        return {name: results[name] for name in sorted(results)}

    def predict_video(self, video_path: str,
                      temporal_smooth: Optional[bool] = None,
                      max_frames: Optional[int] = None
                      ) -> Tuple[np.ndarray, np.ndarray, float]:
        """Per-frame full-image pose over a video (cv2), in batches of 32
        frames, then ``cfg.temporal`` smoothing (on unless
        ``temporal_smooth`` says otherwise) when the clip holds a window.
        Returns (trajectory (T, K, 2), scores (T, K), fps)."""
        import cv2

        cap = cv2.VideoCapture(video_path)
        fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
            if max_frames and len(frames) >= max_frames:
                break
        cap.release()
        K = self.schema.num_keypoints
        if not frames:
            return np.zeros((0, K, 2)), np.zeros((0, K)), fps
        arr = np.stack(frames)
        h, w = arr.shape[1:3]
        bboxes = np.tile(np.array([0, 0, w, h], np.float32), (len(arr), 1))
        kpts, scores = [], []
        for i in range(0, len(arr), 32):
            k, s = self.predict_batch(arr[i:i + 32], bboxes[i:i + 32])
            kpts.append(k)
            scores.append(s)
        traj, scores = np.concatenate(kpts), np.concatenate(scores)
        tcfg = self.cfg.temporal
        smooth = tcfg.enabled if temporal_smooth is None else temporal_smooth
        if smooth and len(traj) >= tcfg.window_size:
            traj = decode_ops.temporal_smooth(
                torch.from_numpy(traj), tcfg.window_size, tcfg.method,
                fps=fps).numpy()
        return traj, scores, fps
