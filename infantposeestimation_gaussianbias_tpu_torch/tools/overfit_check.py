"""Training sanity: overfit a tiny fixed batch end to end.

Port of infantposeestimation_gaussianbias_tpu/tools/overfit_check.py.
Trains the fusion model (the six-term Gaussian-constraint loss) on
``batch`` fixed random crops with keypoints inside them and checks that
the fusion decode of the trained model recovers the keypoints: the mean
keypoint error after training must be under 0.3 of the error before.
The strongest single check that the train step, the loss and the decode
learn together on the card.

    python -m infantposeestimation_gaussianbias_tpu_torch.tools.overfit_check
    ... --steps 300 --device cpu       # a slow CPU run
"""

from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np


def run(steps: int = 2000, batch: int = 16, lr: float = 1e-3,
        backbone: str = "litehrnet", device="cuda",
        input_size: Optional[Tuple[int, int]] = None,
        compute_dtype: str = "bfloat16",
        verbose: bool = True) -> Dict[str, float]:
    """Train ``steps`` steps of ``backbone`` + fusion head (hidden 64) at
    ``lr`` on ``batch`` seeded crops (``input_size`` (W, H), the Config's
    256 x 192 by default; heatmaps at a quarter of it) and return the mean
    keypoint error in input pixels before (``e0``) and after (``e1``), the
    last step's loss and the training seconds (host clock after a device
    sync).  Raises when e1 is not below 0.3 e0."""
    import torch

    from ..config import Config
    from ..models import decode_outputs
    from ..train import create_train_state, make_train_step

    cfg = Config()
    cfg.model.backbone = backbone
    cfg.model.head_type = "fusion"
    cfg.model.hidden_dim = 64
    cfg.model.compute_dtype = compute_dtype
    cfg.train.lr = lr
    cfg.train.warmup_epochs = 0
    cfg.train.steps_per_epoch = 100
    if input_size is not None:
        cfg.data.input_size = tuple(input_size)
        cfg.data.heatmap_size = (input_size[0] // 4, input_size[1] // 4)

    state = create_train_state(cfg, device=device)
    step = make_train_step(cfg)
    dev = next(state.model.parameters()).device

    rng = np.random.RandomState(0)
    K = cfg.data.num_keypoints
    W, H = cfg.data.input_size
    data = {
        "image": torch.from_numpy(
            rng.randn(batch, H, W, 3).astype(np.float32)).to(dev),
        "keypoints": torch.from_numpy(
            rng.uniform(20, min(W, H) - 20, (batch, K, 2))
            .astype(np.float32)).to(dev),
        "visible": torch.ones((batch, K), dtype=torch.float32, device=dev),
    }
    stride = W / cfg.data.heatmap_size[0]
    gen = torch.Generator(device=dev).manual_seed(1)

    def eval_err() -> float:
        model = state.model
        model.eval()
        with torch.no_grad():
            coords, _ = decode_outputs(model(data["image"]), "fusion")
        model.train()
        return float(torch.linalg.norm(coords * stride - data["keypoints"],
                                       dim=-1).mean())

    e0 = eval_err()
    t0 = time.perf_counter()
    for _ in range(steps):
        _, metrics = step(state, data, gen)
    loss = float(metrics["total_loss"])  # syncs with the device
    train_s = time.perf_counter() - t0
    e1 = eval_err()
    if verbose:
        print(f"keypoint error: {e0:.2f} px -> {e1:.2f} px "
              f"(final loss {loss:.3f}, {steps} steps, {train_s:.1f} s)")
    assert e1 < e0 * 0.3, f"did not overfit: {e0:.1f} -> {e1:.1f} px"
    return {"e0": e0, "e1": e1, "loss": loss, "steps": float(steps),
            "train_s": train_s}


if __name__ == "__main__":
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--batch", type=int, default=16)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--backbone", default="litehrnet")
    p.add_argument("--device", default="cuda")
    a = p.parse_args()
    run(steps=a.steps, batch=a.batch, lr=a.lr, backbone=a.backbone,
        device=a.device)
