"""One-command parity validation of a reference PyTorch checkpoint.

Port of infantposeestimation_gaussianbias_tpu/tools/
validate_reference_checkpoint.py.  The moment real COCO(-style) data is
available, this produces the AP comparison table against the reference's
published numbers (the reference's README.md:224-229) without retraining:

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.\\
validate_reference_checkpoint \\
        --checkpoint pose_hrnet_w32_256x192.pth \\
        --data-root /data/coco --val-ann annotations/person_keypoints_val2017.json \\
        --img-dir val2017

The port's state dict already uses the reference checkpoint's names for
HRNet, HRFormer and the heatmap and fusion heads (weights.py), so a
reference ``.pth`` (a ``model_state_dict`` wrapper or a bare state dict,
``backbone.``/``head.`` keys) loads strictly, with no conversion.  It runs
the flip-test validation loop (train/loop.py ``validate``, the
reference validate.py:143-203 protocol) and prints our AP next to the
reference's claimed AP for the matching row; ``--int8`` also calibrates
int8 PTQ serving on validation images (``PoseInference(quantize=True)``)
and prints the float-vs-int8 AP delta.

``--dry-run`` exercises the whole path on synthetic fixtures: the port's
own seeded model (weights.init_weights) written out in the reference
checkpoint's layout, and a 4-image generated COCO val set, so that the
command is known-good before data exists.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile

import torch

# Reference claims (the reference's README.md:224-229).
REFERENCE_CLAIMS = {
    ("hrnet_w32", (192, 256)): {"AP": 0.744, "AP50": 0.905, "AP75": 0.819},
    ("hrnet_w48", (288, 384)): {"AP": 0.763, "AP50": 0.908, "AP75": 0.829},
    ("hrformer_base", (192, 256)): {"AP": 0.756, "AP50": 0.908, "AP75": 0.828},
    ("hrformer_base", (288, 384)): {"AP": 0.772, "AP50": 0.910, "AP75": 0.836},
}


def load_reference_state_dict(path: str) -> dict:
    """A reference ``.pth``: its ``model_state_dict``, or the file itself
    when it is a bare state dict."""
    raw = torch.load(path, map_location="cpu", weights_only=True)
    return raw.get("model_state_dict", raw)


def build_state(cfg, checkpoint: str, device="cuda"):
    """The train state of ``cfg`` with the reference checkpoint's weights
    (loaded strictly) on ``device``."""
    from ..train.step import create_train_state

    state = create_train_state(cfg, device=device)
    state.model.load_state_dict(load_reference_state_dict(checkpoint),
                                strict=True)
    return state


def run_validation(cfg, state, int8: bool = False, calib_batches: int = 4):
    """Float flip-test validation; with ``int8`` also PTQ-calibrate on the
    first ``calib_batches`` val-image batches (real activation
    distributions, not synthetic noise) and validate the int8 serving
    model, returning both result dicts."""
    from ..data.pipeline import build_dataloader, device_batch
    from ..inference import PoseInference
    from ..train.loop import validate

    loader = build_dataloader(cfg, is_train=False)
    with open(os.path.join(cfg.data.data_root, cfg.data.val_ann)) as f:
        gt = json.load(f)
    results = validate(cfg, state, loader, gt)
    if not int8:
        return results

    device = next(state.model.parameters()).device
    calib = []
    for i, batch in enumerate(loader.epoch(0)):
        if i >= calib_batches:
            break
        calib.append(device_batch(batch, cfg.data.pixel_mean,
                                  cfg.data.pixel_std, device)["image"])
    serve = PoseInference(cfg, state_dict=state.model.state_dict(),
                          device=device, quantize=True,
                          calibration_crops=torch.cat(calib))
    results_int8 = validate(cfg, state, loader, gt, with_loss=False,
                            model=serve.model)
    return results, results_int8


def int8_delta_table(results, results_int8):
    lines = [f"{'metric':>6} | {'float':>8} | {'int8':>8} | {'delta':>8}"]
    lines.append("-" * 40)
    for k in ("AP", "AP50", "AP75", "AP_M", "AP_L", "AR"):
        if k in results and k in results_int8:
            lines.append(f"{k:>6} | {results[k]:8.4f} | "
                         f"{results_int8[k]:8.4f} | "
                         f"{results_int8[k] - results[k]:+8.4f}")
    return "\n".join(lines)


def comparison_table(results, backbone, input_size):
    claims = REFERENCE_CLAIMS.get((backbone, tuple(input_size)))
    lines = [f"{'metric':>6} | {'ours':>8} | {'reference':>9} | {'delta':>8}"]
    lines.append("-" * 42)
    for k in ("AP", "AP50", "AP75", "AP_M", "AP_L", "AR"):
        if k not in results:
            continue
        ours = results[k]
        if claims and k in claims:
            ref = claims[k]
            lines.append(f"{k:>6} | {ours:8.4f} | {ref:9.4f} | "
                         f"{ours - ref:+8.4f}")
        else:
            lines.append(f"{k:>6} | {ours:8.4f} | {'—':>9} | {'—':>8}")
    return "\n".join(lines)


def _make_dry_run_fixtures(tmp, cfg):
    """A reference-layout checkpoint of the port's seeded model (its state
    dict, keys ``backbone.``/``head.`` as the reference's, in a
    ``model_state_dict`` wrapper) and a 4-image COCO val set."""
    from ..data import synthetic_coco_dataset
    from ..models import build_model
    from ..schemas import COCO17

    sd = build_model(cfg, device="cpu").state_dict()
    ckpt = os.path.join(tmp, "reference.pth")
    torch.save({"model_state_dict": sd, "epoch": 0}, ckpt)

    data_root = os.path.join(tmp, "coco")
    img_dir = os.path.join(data_root, "images")
    ann_dir = os.path.join(data_root, "annotations")
    os.makedirs(img_dir)
    os.makedirs(ann_dir)
    W, H = cfg.data.input_size
    synth = synthetic_coco_dataset(
        num_images=4, num_keypoints=cfg.data.num_keypoints,
        image_dir=img_dir, seed=3, height=H, width=W,
        keypoint_names=COCO17.keypoint_names, skeleton=COCO17.skeleton)
    with open(os.path.join(ann_dir, "val.json"), "w") as f:
        json.dump(synth, f)
    return ckpt, data_root


def _report(out, cfg, int8: bool):
    results = out[0] if int8 else out
    print(comparison_table(results, cfg.model.backbone, cfg.data.input_size))
    if int8:
        print(int8_delta_table(results, out[1]))


def main(argv=None):
    from ..config import Config, apply_overrides

    parser = argparse.ArgumentParser(
        description="Validate a reference .pth and compare AP to its claims")
    parser.add_argument("--checkpoint", help="reference .pth path")
    parser.add_argument("--data-root", help="COCO-style dataset root")
    parser.add_argument("--val-ann",
                        default="annotations/person_keypoints_val2017.json")
    parser.add_argument("--img-dir", default="val2017")
    parser.add_argument("--backbone", default="hrnet_w32",
                        choices=["hrnet_w32", "hrnet_w48",
                                 "hrformer_base", "hrformer_small"])
    parser.add_argument("--head", default="fusion",
                        choices=["fusion", "heatmap"])
    parser.add_argument("--input-size", type=int, nargs=2,
                        default=[192, 256], metavar=("W", "H"))
    parser.add_argument("--batch-size", type=int, default=64)
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "kernels' plain versions)")
    parser.add_argument("--set", dest="overrides", nargs="*", default=[],
                        metavar="KEY=VALUE",
                        help="dotted-path config overrides applied last")
    parser.add_argument("--dry-run", action="store_true",
                        help="run the full path on synthetic fixtures")
    parser.add_argument("--int8", action="store_true",
                        help="also PTQ-calibrate on the provided val "
                             "images and report the float-vs-int8 AP "
                             "delta (the int8 re-guard for real data)")
    args = parser.parse_args(argv)

    cfg = Config()
    cfg.model.backbone = args.backbone
    cfg.model.head_type = args.head
    cfg.model.compute_dtype = "bfloat16"
    cfg.data.input_size = tuple(args.input_size)
    cfg.data.heatmap_size = (args.input_size[0] // 4, args.input_size[1] // 4)
    cfg.eval.flip_test = True
    cfg.eval.batch_size = args.batch_size
    apply_overrides(cfg, args.overrides)

    if args.dry_run:
        with tempfile.TemporaryDirectory() as tmp:
            ckpt, data_root = _make_dry_run_fixtures(tmp, cfg)
            cfg.data.data_root = data_root
            cfg.data.val_ann = "annotations/val.json"
            cfg.data.val_img_prefix = "images/"
            cfg.eval.batch_size = 2
            state = build_state(cfg, ckpt, args.device)
            out = run_validation(cfg, state, int8=args.int8,
                                 calib_batches=2)
            _report(out, cfg, args.int8)
            print("dry-run OK: load -> flip-test validate -> COCOeval "
                  + ("-> int8 PTQ re-validate " if args.int8 else "")
                  + "all ran end to end")
            return out

    if not args.checkpoint or not args.data_root:
        parser.error("--checkpoint and --data-root are required "
                     "(or use --dry-run)")
    cfg.data.data_root = args.data_root
    cfg.data.val_ann = args.val_ann
    cfg.data.val_img_prefix = args.img_dir.rstrip("/") + "/"
    state = build_state(cfg, args.checkpoint, args.device)
    out = run_validation(cfg, state, int8=args.int8)
    _report(out, cfg, args.int8)
    return out


if __name__ == "__main__":
    main()
