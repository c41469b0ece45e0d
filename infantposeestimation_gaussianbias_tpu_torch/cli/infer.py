"""Inference CLI: one image, a directory of images, or a video.

Port of infantposeestimation_gaussianbias_tpu/cli/infer.py.

    python -m infantposeestimation_gaussianbias_tpu_torch.cli.infer \
        --variant hrnet_w32 --input img.jpg --output out.jpg
    ... --input frames_dir/
    ... --input video.mp4 --max-frames 64

Images and videos are read with cv2.  ``--output`` on an image draws the
skeleton (viz/skeleton.py); on a video it writes the video with the
skeleton and wrist trails drawn (viz/clinical.create_video_with_pose, cv2)
and ``--clinical-report`` the four-panel clinical figure (matplotlib).

``--mesh [MODEL_AXIS]`` (cli/common.py) serves over a process grid under
torchrun: every rank reads the same input and predicts it together; rank
0 alone prints and writes the outputs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from .common import (add_config_args, add_serving_args, make_grid,
                     make_inference, resolve_config)

def main(argv=None):
    parser = argparse.ArgumentParser(description="Pose inference")
    add_config_args(parser)
    add_serving_args(parser)
    parser.add_argument("--input", required=True,
                        help="image file, directory, or video")
    parser.add_argument("--output", default=None)
    parser.add_argument("--bbox", type=float, nargs=4, default=None,
                        metavar=("X1", "Y1", "X2", "Y2"))
    parser.add_argument("--video", action="store_true")
    parser.add_argument("--max-frames", type=int, default=None)
    parser.add_argument("--clinical-report", default=None,
                        help="write a clinical analysis figure (video mode)")
    args = parser.parse_args(argv)
    cfg = resolve_config(args)
    video = args.video or args.input.lower().endswith((".mp4", ".avi",
                                                       ".mov"))
    grid = make_grid(args)
    infer = make_inference(args, cfg, grid=grid)
    schema = cfg.data.keypoint_schema
    lead = grid is None or grid.rank == 0  # the rank that prints and writes
    say = print if lead else (lambda *a, **k: None)

    if video:
        traj, scores, fps = infer.predict_video(args.input,
                                                max_frames=args.max_frames)
        say(f"processed {len(traj)} frames @ {fps:.1f} fps")
        if args.output and lead:
            from ..viz.clinical import create_video_with_pose

            create_video_with_pose(args.input, traj, scores, args.output,
                                   schema, fps=fps,
                                   max_frames=args.max_frames)
            print(f"wrote {args.output}")
        if args.clinical_report and lead:
            from ..viz.clinical import create_clinical_report_figure

            create_clinical_report_figure(
                traj, scores, schema, args.clinical_report,
                fps=fps, cfg_clinical=cfg.clinical)
            print(f"wrote {args.clinical_report}")
        return

    if os.path.isdir(args.input):
        for name, r in infer.predict_directory(args.input).items():
            say(f"{name}: mean score {float(np.mean(r['scores'])):.3f}")
        return

    import cv2

    img = cv2.imread(args.input)
    if img is None:
        raise SystemExit(f"cannot read {args.input}")
    kpts, scores = infer.predict(cv2.cvtColor(img, cv2.COLOR_BGR2RGB),
                                 args.bbox)
    for name, (x, y), s in zip(schema.keypoint_names, kpts, scores):
        say(f"{name:>16}: ({x:7.1f}, {y:7.1f})  score {s:.3f}")
    if args.output and lead:
        from ..viz.skeleton import draw_skeleton

        cv2.imwrite(args.output, draw_skeleton(img, kpts, scores, schema))
        print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
