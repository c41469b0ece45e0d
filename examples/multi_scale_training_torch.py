"""Multi-scale training on the PyTorch port (the reference's
data/examples.py:435-472).

The port's twin of examples/multi_scale_training.py: a fixed scale set,
one loader and one train step per scale, cycled per epoch; the backbone
and heads are fully convolutional, so one model trains at (128, 192),
(192, 256) and (256, 320), as the reference example intends.

Run: python examples/multi_scale_training_torch.py [--steps-per-scale N]
[--device cpu]
"""

from __future__ import annotations

import argparse
import copy
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from infantposeestimation_gaussianbias_tpu_torch.config import Config
from infantposeestimation_gaussianbias_tpu_torch.data import (
    CocoIndex,
    DataLoader,
    PoseDataset,
    build_records,
    device_batch,
    synthetic_coco_dataset,
)
from infantposeestimation_gaussianbias_tpu_torch.train import (
    create_train_state,
    make_train_step,
)

# (W, H) like the reference example's small / medium / large
SCALES = ((128, 192), (192, 256), (256, 320))


def scale_cfg(base: Config, input_size) -> Config:
    cfg = copy.deepcopy(base)
    cfg.data.input_size = tuple(input_size)
    cfg.data.heatmap_size = (input_size[0] // 4, input_size[1] // 4)
    return cfg


def run(epochs: int = 3, steps_per_scale: int = 4, batch_size: int = 4,
        backbone: str = "litehrnet", scales=SCALES, seed: int = 0,
        verbose: bool = True, device: str = "cuda"):
    base = Config()
    base.model.backbone = backbone
    base.model.head_type = "heatmap"
    base.model.compute_dtype = "float32"
    base.train.global_batch_size = batch_size

    # one loader + one step per scale; ONE shared model/state
    synth = synthetic_coco_dataset(num_images=batch_size * 2, height=320,
                                   width=320, seed=seed)
    recs = build_records(CocoIndex(dataset=synth))
    cfgs = [scale_cfg(base, s) for s in scales]
    loaders = [DataLoader(PoseDataset(c, recs, "", True,
                                      image_cache=_cache_from(synth, seed)),
                          batch_size, shuffle=True, seed=seed,
                          drop_last=True) for c in cfgs]
    steps = [make_train_step(c) for c in cfgs]

    state = create_train_state(cfgs[0], device=device)
    dev = next(state.model.parameters()).device
    generator = torch.Generator(device=dev).manual_seed(seed + 1)

    history = []
    for epoch in range(epochs):
        i = epoch % len(scales)  # cycle scales per epoch
        cfg = cfgs[i]
        n = 0
        for batch in loaders[i].epoch(epoch):
            db = device_batch(batch, cfg.data.pixel_mean, cfg.data.pixel_std,
                              dev)
            state, metrics = steps[i](state, db, generator)
            n += 1
            if n >= steps_per_scale:
                break
        loss = float(metrics["total_loss"])
        history.append((scales[i], loss))
        if verbose:
            print(f"epoch {epoch}: scale {scales[i]} "
                  f"loss {loss:.4f}", flush=True)
    return state, history


def _cache_from(synth, seed):
    """The in-memory image cache for the synthetic dataset: deterministic
    noise images (synthetic_coco_dataset without an image_dir keeps pixel
    arrays out of the dict)."""
    rng = np.random.RandomState(seed)
    cache = {}
    for im in synth["images"]:
        cache[im["file_name"]] = rng.randint(
            0, 255, (im["height"], im["width"], 3)).astype(np.uint8)
    return cache


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--epochs", type=int, default=3)
    p.add_argument("--steps-per-scale", type=int, default=4)
    p.add_argument("--batch-size", type=int, default=4)
    p.add_argument("--backbone", default="litehrnet")
    p.add_argument("--device", default="cuda",
                   help="torch device (default cuda; 'cpu' runs the "
                        "kernels' plain versions)")
    a = p.parse_args()
    _, history = run(epochs=a.epochs, steps_per_scale=a.steps_per_scale,
                     batch_size=a.batch_size, backbone=a.backbone,
                     device=a.device)
    print("trained one model across scales:",
          sorted({s for s, _ in history}))
