"""Quick-start examples on the PyTorch port: single image, simulated
video, batch, clinical.

The port's twin of examples/quick_start.py (the reference's
examples/quick_start.py):
1. single-image inference with the preemie config
2. simulated infant video analysis + temporal smoothing
3. batched inference (one batch through the model, not a loop)
4. clinical asymmetry / activity assessment

Run:  python examples/quick_start_torch.py [--device cpu]
(the card by default; the seeded weights of a small LiteHRNet).
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np
import torch

from infantposeestimation_gaussianbias_tpu_torch.config import (
    get_preemie_config)
from infantposeestimation_gaussianbias_tpu_torch.eval import (
    asymmetry_score,
    calculate_movement_amplitude,
    calculate_temporal_consistency,
)
from infantposeestimation_gaussianbias_tpu_torch.inference import (
    PoseInference)
from infantposeestimation_gaussianbias_tpu_torch.ops import (
    decode as decode_ops)
from infantposeestimation_gaussianbias_tpu_torch.schemas import INFANT13


def example_single_image_inference(infer: PoseInference):
    print("\n=== 1. Single-image inference (13-joint infant schema) ===")
    rng = np.random.RandomState(0)
    image = rng.randint(40, 200, (480, 640, 3)).astype(np.uint8)
    kpts, scores = infer.predict(image)
    for name, (x, y), s in zip(INFANT13.keypoint_names, kpts, scores):
        print(f"  {name:>16}: ({x:6.1f}, {y:6.1f})  conf {s:.3f}")
    return kpts, scores


def simulate_infant_trajectory(T=60, K=13, seed=1):
    """Simulated infant movement: gentle limb oscillation + noise (the
    reference's synthetic-video pattern, quick_start.py:102-168)."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(100, 380, (K, 2))
    t = np.linspace(0, 4 * np.pi, T)
    traj = np.tile(base, (T, 1, 1))
    for k in (7, 8, 9, 10):  # elbows + wrists move the most
        traj[:, k, 0] += 25 * np.sin(t + k)
        traj[:, k, 1] += 15 * np.cos(t * 0.7 + k)
    traj += rng.randn(T, K, 2) * 2.0
    scores = rng.uniform(0.5, 1.0, (T, K))
    return traj.astype(np.float32), scores.astype(np.float32)


def example_video_analysis():
    print("\n=== 2. Simulated video analysis + temporal smoothing ===")
    traj, scores = simulate_infant_trajectory()
    smoothed = decode_ops.temporal_smooth(
        torch.from_numpy(traj), window_size=5, method="gaussian").numpy()
    before = calculate_temporal_consistency(traj)
    after = calculate_temporal_consistency(smoothed)
    print(f"  temporal consistency: raw {before:.3f} -> smoothed {after:.3f}")
    return smoothed, scores


def example_batch_inference(infer: PoseInference):
    print("\n=== 3. Batched inference (one batch through the model) ===")
    rng = np.random.RandomState(2)
    frames = rng.randint(40, 200, (8, 480, 640, 3)).astype(np.uint8)
    bboxes = np.tile([100, 80, 540, 400], (8, 1)).astype(np.float32)
    kpts, scores = infer.predict_batch(frames, bboxes)
    print(f"  processed {len(frames)} crops -> keypoints {kpts.shape}, "
          f"mean conf {scores.mean():.3f}")
    return kpts


def example_clinical_analysis(traj, scores):
    print("\n=== 4. Clinical assessment ===")
    stats = calculate_movement_amplitude(traj, fps=30.0)
    left = [i for i, n in enumerate(INFANT13.keypoint_names)
            if n.startswith("left")]
    right = [i for i, n in enumerate(INFANT13.keypoint_names)
             if n.startswith("right")]
    asym = asymmetry_score(traj, left, right)
    print(f"  overall movement amplitude: "
          f"{stats['overall_amplitude']:.1f} px")
    print(f"  mean wrist velocity: "
          f"{stats['mean_velocity'][9]:.1f} px/s (left), "
          f"{stats['mean_velocity'][10]:.1f} px/s (right)")
    print(f"  left/right asymmetry: {asym:.3f} "
          f"({'FLAG' if asym > 0.3 else 'ok'})")
    print(f"  activity level: "
          f"{'LOW' if stats['overall_amplitude'] < 5 else 'normal'}")


def main(device: str = "cuda"):
    cfg = get_preemie_config()
    cfg.model.backbone = "litehrnet"  # small model for the demo
    cfg.model.compute_dtype = "float32"
    infer = PoseInference(cfg, device=device)

    example_single_image_inference(infer)
    traj, scores = example_video_analysis()
    example_batch_inference(infer)
    example_clinical_analysis(traj, scores)
    print("\nAll examples completed.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    main(ap.parse_args().device)
