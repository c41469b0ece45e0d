"""Model analysis CLI: parameter/activation/benchmark report + figures.

Port of infantposeestimation_gaussianbias_tpu/cli/analyze.py (the
reference's analysis/analysis_example.py): loads a model (seeded, or a
checkpoint of the port's trainer), prints a parameter summary and
activation statistics, optionally runs the inference-latency harness, and
writes saliency / Grad-CAM / occlusion figures.

    python -m infantposeestimation_gaussianbias_tpu_torch.cli.analyze \\
        --variant hrnet_w32 --out-dir analysis_out [--checkpoint ckpt/best]

The work is split in two: ``analyze_model`` computes the summary, the
activation statistics and the three maps on the model's device and writes
``parameters.txt`` and ``activations.json`` (no matplotlib: the machine
with the card has none), and ``write_figures`` draws the maps.
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, Optional

import numpy as np

from ..analysis import (activation_statistics, benchmark_model,
                        capture_activations, grad_cam, occlusion_sensitivity,
                        parameter_summary, saliency_map)
from ..models import build_model
from .common import add_config_args, resolve_config

MAPS = ("saliency", "gradcam", "occlusion")


def analyze_model(cfg, out_dir: str, state_dict=None, keypoint: int = 0,
                  device="cuda") -> Dict:
    """The analysis of ``cfg``'s model (``state_dict``'s weights, or the
    seeded ones) on ``device``, on one seeded (H, W, 3) input: writes
    ``parameters.txt`` (the 100 largest parameters) and
    ``activations.json`` (each captured activation's statistics) into
    ``out_dir``; returns the 20-line parameter summary, the number of
    captured activations, the layers with > 20% dead channels and the
    saliency, Grad-CAM and occlusion maps of ``keypoint``."""
    os.makedirs(out_dir, exist_ok=True)
    model = build_model(cfg, device)
    if state_dict is not None:
        model.load_state_dict(state_dict, strict=True)
    with open(os.path.join(out_dir, "parameters.txt"), "w") as f:
        f.write(parameter_summary(model, top=100))

    W, H = cfg.data.input_size
    x = np.random.RandomState(0).randn(1, H, W, 3).astype(np.float32)
    acts = capture_activations(model, x)
    stats = activation_statistics(acts)
    dead = {k: v["dead_channel_fraction"] for k, v in stats.items()
            if v.get("dead_channel_fraction", 0) > 0.2}
    with open(os.path.join(out_dir, "activations.json"), "w") as f:
        json.dump({k: {kk: vv for kk, vv in v.items() if kk != "shape"}
                   for k, v in stats.items()}, f, indent=1)

    patch = max(H // 8, 8)
    maps = {"saliency": saliency_map(model, x[0], keypoint),
            "gradcam": grad_cam(model, x[0], keypoint),
            "occlusion": occlusion_sensitivity(model, x[0], keypoint,
                                               patch=patch, stride=patch)}
    return {"summary": parameter_summary(model), "activations": len(acts),
            "dead_layers": dead, "maps": maps}


def write_figures(maps: Dict[str, np.ndarray], out_dir: str,
                  keypoint: int = 0) -> None:
    """``{name}.png`` in ``out_dir`` for each of ``analyze_model``'s maps
    (matplotlib, Agg)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    for name in MAPS:
        fig, ax = plt.subplots()
        im = ax.imshow(maps[name], cmap="inferno")
        fig.colorbar(im, ax=ax)
        ax.set_title(f"{name} (keypoint {keypoint})")
        fig.savefig(os.path.join(out_dir, f"{name}.png"), dpi=120)
        plt.close(fig)


def main(argv=None) -> Optional[Dict]:
    parser = argparse.ArgumentParser(description="Analyze a pose model")
    add_config_args(parser)
    parser.add_argument("--checkpoint", default=None,
                        help="a checkpoint of the port's trainer, e.g. "
                             "checkpoints/best; seeded weights without it")
    parser.add_argument("--out-dir", default="analysis_out")
    parser.add_argument("--device", default="cuda",
                        help="torch device (default cuda; 'cpu' runs the "
                             "kernels' plain versions)")
    parser.add_argument("--benchmark", action="store_true",
                        help="run the latency harness")
    parser.add_argument("--keypoint", type=int, default=0,
                        help="keypoint index for sensitivity figures")
    args = parser.parse_args(argv)
    cfg = resolve_config(args)

    state_dict = None
    if args.checkpoint:
        from ..train.checkpoint import model_state_dict

        state_dict = model_state_dict(args.checkpoint)
    out = analyze_model(cfg, args.out_dir, state_dict, args.keypoint,
                        args.device)
    print(out["summary"])
    print(f"captured {out['activations']} activations; "
          f"{len(out['dead_layers'])} layers with >20% dead channels")
    write_figures(out["maps"], args.out_dir, args.keypoint)
    print(f"figures written to {args.out_dir}")

    if args.benchmark:
        stats = benchmark_model(cfg, batch_size=64, device=args.device)
        print(json.dumps(stats))
        with open(os.path.join(args.out_dir, "latency.json"), "w") as f:
            json.dump(stats, f, indent=1)
    return out


if __name__ == "__main__":
    main()
