"""Export the whole serving pipeline as one saved ``torch.export`` program.

Port of infantposeestimation_gaussianbias_tpu/tools/export_model.py.  The
complete crop -> flip-tested forward -> decode -> back-projection pipeline,
weights included (BN-folded, or int8 PTQ with its frozen activation
scales), is traced by ``torch.export`` at a fixed batch and saved with
``torch.export.save`` into one blob; ``load_pipeline`` gives it back with
a ``.call(frames, centers, scales)``.

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.export_model \\
        --variant hrnet_w32 --checkpoint checkpoints/best --batch 64 \\
        --output model.pt2

The served kernels (K1, K4/K5 forward, K9, K10) are registered operators
(kernels/ops.py): the models call them while ``torch.export`` traces, so
the program holds one ``torch.ops.ipe.*`` node per kernel call and runs the
hand-written kernel when loaded and called on the card (each launch
counted, as in eager serving).  The loaded program needs this package
importable, for those operators.

A program is made for the device it was exported on, as a JAX artifact is
for its platform: export on the device you serve on.  ``.call`` raises for
inputs on another device; it never moves the program.
"""

from __future__ import annotations

import io
import os
import warnings
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn as nn

from ..inference import PoseInference, forward_decode
from ..ops import affine


class ServingPipeline(nn.Module):
    """(frames uint8 (B, H, W, 3), centers (B, 2), scales (B, 2)) ->
    (keypoints (B, K, 2) in frame coordinates, scores (B, K)): the
    arithmetic of ``PoseInference._pipeline`` on ``infer``'s served model
    (folded, int8 or float, as ``infer`` serves).  ``frame_hw``: the frame
    size the export traces at."""

    def __init__(self, infer: PoseInference,
                 frame_hw: Tuple[int, int] = (512, 512)):
        super().__init__()
        if infer.quantize and not infer._quant_installed:
            raise ValueError("the int8 model is not calibrated yet: pass "
                             "calibration crops to PoseInference")
        self.cfg = infer.cfg
        self.frame_hw = tuple(frame_hw)
        self.model = infer.model
        self.register_buffer("flip_index", infer._flip_index)
        self.requires_grad_(False)

    def forward(self, frames: torch.Tensor, centers: torch.Tensor,
                scales: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        cfg = self.cfg
        crops = affine.crop_and_normalize(
            frames, centers, scales, cfg.data.input_size,
            mean=cfg.data.pixel_mean, std=cfg.data.pixel_std)
        return forward_decode(self.model, cfg, self.flip_index, crops,
                              centers, scales)


def build_serving_fn(cfg, state_dict=None,
                     frame_hw: Tuple[int, int] = (512, 512),
                     fold: Optional[bool] = None, quantize: bool = False,
                     calib_crops=None, device="cuda") -> ServingPipeline:
    """The serving pipeline of ``cfg`` with ``state_dict``'s weights (the
    seeded ones when None) on ``device``.  ``fold``: None folds BatchNorm
    wherever the architecture allows it, as ``PoseInference``.
    ``quantize``: the int8 PTQ pipeline instead, calibrated on
    ``calib_crops`` (normalised (N, H, W, 3) crops); int8 takes
    precedence over BN-fold."""
    if quantize and calib_crops is None:
        raise ValueError("int8 export needs calib_crops")
    infer = PoseInference(cfg, state_dict=state_dict, device=device,
                          fold=fold, quantize=quantize,
                          calibration_crops=calib_crops)
    return ServingPipeline(infer, frame_hw).eval()


def export_serving(serve: ServingPipeline, batch: int) -> bytes:
    """``serve`` traced by ``torch.export`` at ``batch`` frames of its
    frame size on its device, saved by ``torch.export.save``."""
    fh, fw = serve.frame_hw
    dev = serve.flip_index.device
    args = (torch.zeros((batch, fh, fw, 3), dtype=torch.uint8, device=dev),
            torch.tensor([[fw / 2, fh / 2]] * batch, device=dev),
            torch.tensor([[float(fw), float(fh)]] * batch, device=dev))
    with torch.no_grad():
        program = torch.export.export(serve, args, strict=False)
    buf = io.BytesIO()
    torch.export.save(program, buf)
    return buf.getvalue()


def export_pipeline(cfg, state_dict, batch: int, frame_hw=(512, 512),
                    quantize: bool = False, calib_crops=None,
                    device="cuda") -> bytes:
    """``build_serving_fn``'s pipeline exported at ``batch`` frames of
    ``frame_hw``: the saved program's bytes."""
    return export_serving(build_serving_fn(
        cfg, state_dict, frame_hw, quantize=quantize,
        calib_crops=calib_crops, device=device), batch)


class LoadedPipeline:
    """A loaded program: ``.call(frames, centers, scales)`` on tensors on
    the device it was exported on."""

    def __init__(self, program):
        self.program = program
        self.module = program.module()
        users = set(program.graph_signature.user_inputs)
        self.device = next(n.meta["val"].device for n in program.graph.nodes
                           if n.op == "placeholder" and n.name in users)

    def call(self, frames: torch.Tensor, centers: torch.Tensor,
             scales: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        for name, x in (("frames", frames), ("centers", centers),
                        ("scales", scales)):
            if x.device != self.device:
                raise ValueError(
                    f"{name} lie on {x.device}, but the program was exported "
                    f"for {self.device}: export it on the device it serves "
                    f"on")
        with torch.no_grad():
            return self.module(frames, centers, scales)


def load_pipeline(blob: bytes) -> LoadedPipeline:
    """Deserialize ``export_pipeline``'s bytes (its kernels' operators
    registered first)."""
    from ..kernels import ops  # noqa: F401  (registers torch.ops.ipe.*)

    return LoadedPipeline(torch.export.load(io.BytesIO(blob)))


def main(argv=None):
    import argparse

    from ..cli.common import add_config_args, resolve_config
    from ..train.checkpoint import model_state_dict

    p = argparse.ArgumentParser(description="Export serving pipeline")
    add_config_args(p)
    p.add_argument("--checkpoint", default=None,
                   help="a checkpoint of the port's trainer, e.g. "
                        "checkpoints/best; seeded weights without it")
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--frame-size", type=int, nargs=2, default=(512, 512),
                   metavar=("H", "W"))
    p.add_argument("--output", required=True)
    p.add_argument("--device", default="cuda",
                   help="the device the program serves on (default cuda)")
    p.add_argument("--int8", action="store_true",
                   help="export the int8 PTQ serving path; calibrates "
                        "on the first val batch when data.data_root holds "
                        "data.val_ann, else on random crops (warned)")
    args = p.parse_args(argv)
    cfg = resolve_config(args)
    state_dict = (model_state_dict(args.checkpoint) if args.checkpoint
                  else None)

    calib = None
    if args.int8:
        W, H = cfg.data.input_size
        if os.path.exists(os.path.join(cfg.data.data_root,
                                       cfg.data.val_ann)):
            from ..data.pipeline import build_dataloader, device_batch

            first = next(iter(build_dataloader(cfg, is_train=False).epoch(0)))
            calib = device_batch(first, cfg.data.pixel_mean,
                                 cfg.data.pixel_std, args.device)["image"]
        else:
            warnings.warn(
                f"no val annotations under data.data_root "
                f"({cfg.data.data_root!r}) for int8 calibration; "
                f"calibrating on RANDOM crops — activation scales will not "
                f"match real images. Configure data.data_root for a "
                f"faithful export.")
            calib = np.random.RandomState(0).randn(64, H, W, 3).astype(
                np.float32)

    blob = export_pipeline(cfg, state_dict, args.batch,
                           tuple(args.frame_size), quantize=args.int8,
                           calib_crops=calib, device=args.device)
    with open(args.output, "wb") as f:
        f.write(blob)
    print(f"exported {len(blob) / 1e6:.1f} MB -> {args.output}")


if __name__ == "__main__":
    main()
