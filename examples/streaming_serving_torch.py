"""Streaming serving on the PyTorch port: loader -> host-to-device
prefetch -> device compute.

The port's twin of examples/streaming_serving.py:
1. a threaded host loader decoding JPEGs ahead of the consumer
2. a copy thread staging batches on the card ahead of compute
   (``prefetch_to_device``: pinned memory, a side stream)
3. bounded-in-flight dispatch (``PoseInference.predict_stream``)
4. optional data-parallel serving over a process grid (``--mesh``,
   launched by torchrun: every rank reads the whole set, serves its rows
   of each batch, and rank 0 prints; without torchrun, one process)
5. optional int8 PTQ serving (``--int8``)

Run:  python examples/streaming_serving_torch.py [--int8] [--device cpu]
      python -m torch.distributed.run --nproc-per-node 2 \
          examples/streaming_serving_torch.py --mesh --device cpu
(a tiny demo config; for production use hrnet_w32/fusion + real data.)
"""

import argparse
import json
import os
import sys
import tempfile
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mesh", action="store_true",
                    help="serve over a process grid launched by torchrun "
                         "(data-parallel)")
    ap.add_argument("--backend", choices=("gloo", "nccl"), default=None,
                    help="process-group backend under --mesh (default: "
                         "nccl on a card, gloo on the CPU)")
    ap.add_argument("--int8", action="store_true",
                    help="serve the int8 PTQ path (hrnet backbones)")
    ap.add_argument("--images", type=int, default=32)
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    args = ap.parse_args()

    from infantposeestimation_gaussianbias_tpu_torch.cli.common import (
        make_grid)
    from infantposeestimation_gaussianbias_tpu_torch.config import Config
    from infantposeestimation_gaussianbias_tpu_torch.data import (
        synthetic_coco_dataset)
    from infantposeestimation_gaussianbias_tpu_torch.data.pipeline import (
        build_dataloader)
    from infantposeestimation_gaussianbias_tpu_torch.inference import (
        PoseInference)
    from infantposeestimation_gaussianbias_tpu_torch.schemas import COCO17

    grid = make_grid(args)
    say = print if grid is None or grid.rank == 0 else (lambda *a: None)

    cfg = Config()
    # tiny demo config — for production use hrnet_w32 + fusion at 256x192
    cfg.model.backbone = "hrnet_w32" if args.int8 else "litehrnet"
    cfg.model.head_type = "fusion"
    cfg.model.compute_dtype = "float32"
    cfg.data.input_size = (64, 64)
    cfg.data.heatmap_size = (16, 16)
    cfg.eval.batch_size = 8
    cfg.eval.flip_test = False

    with tempfile.TemporaryDirectory() as tmp:
        img_dir = os.path.join(tmp, "images")
        ann_dir = os.path.join(tmp, "annotations")
        os.makedirs(img_dir)
        os.makedirs(ann_dir)
        synth = synthetic_coco_dataset(
            num_images=args.images, num_keypoints=17, image_dir=img_dir,
            seed=0, height=128, width=160,
            keypoint_names=COCO17.keypoint_names, skeleton=COCO17.skeleton)
        with open(os.path.join(ann_dir, "val.json"), "w") as f:
            json.dump(synth, f)
        cfg.data.data_root = tmp
        cfg.data.val_ann = "annotations/val.json"
        cfg.data.val_img_prefix = "images/"

        loader = build_dataloader(cfg, is_train=False)
        infer = PoseInference(cfg, device=args.device, quantize=args.int8,
                              mesh=grid)

        t0 = time.perf_counter()
        n = 0
        for coords, scores in infer.predict_stream(loader.epoch(0),
                                                   max_in_flight=2):
            n += coords.shape[0]
            say(f"  batch of {coords.shape[0]}: "
                  f"mean score {float(scores.mean()):.3f}")
        dt = time.perf_counter() - t0
        say(f"streamed {n} crops in {dt:.2f}s "
              f"({n / dt:,.0f} crops/s incl. host decode; "
              f"precision={'int8' if args.int8 else 'float'}; "
              f"{infer.device})")


if __name__ == "__main__":
    main()
