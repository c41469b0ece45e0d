"""Infant clinical visualization: trajectories, report figure, video overlay.

Port of infantposeestimation_gaussianbias_tpu/viz/clinical.py (the
reference's visualization.py:184-464): movement trajectories, per-joint
confidence over time, movement-amplitude bars, velocity panels (the
four-panel clinical report figure), pseudo-3D pose, per-joint position
density, and the video overlay with wrist motion trails, on the movement
metrics of eval/metrics.py.  Host-side numpy: the figures import
matplotlib when they are drawn; ``create_video_with_pose`` needs only cv2,
so it runs on the machine with the card too.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np

from ..eval.metrics import (
    asymmetry_score,
    calculate_movement_amplitude,
    calculate_temporal_consistency,
)
from ..schemas import INFANT13, KeypointSchema
from .skeleton import draw_skeleton, keypoint_color


def plot_movement_trajectory(trajectory: np.ndarray,
                             schema: KeypointSchema = INFANT13,
                             joint_ids: Optional[Sequence[int]] = None,
                             out_path: Optional[str] = None):
    """2-D trajectory plot per joint (ref visualization.py:184-227)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    joint_ids = list(joint_ids) if joint_ids is not None else \
        list(range(schema.num_keypoints))
    fig, ax = plt.subplots(figsize=(8, 6))
    for k in joint_ids:
        ax.plot(trajectory[:, k, 0], trajectory[:, k, 1],
                label=schema.keypoint_names[k], alpha=0.7)
    ax.invert_yaxis()
    ax.set_xlabel("x (px)")
    ax.set_ylabel("y (px)")
    ax.legend(fontsize=7, ncol=2)
    ax.set_title("Movement trajectories")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def create_clinical_report_figure(trajectory: np.ndarray,
                                  scores: np.ndarray,
                                  schema: KeypointSchema = INFANT13,
                                  out_path: Optional[str] = None,
                                  fps: float = 30.0,
                                  cfg_clinical=None):
    """Four-panel clinical report (ref visualization.py:407-464):
    trajectories / confidence over time / per-joint amplitude / velocity,
    plus asymmetry + activity assessment text."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    stats = calculate_movement_amplitude(trajectory, fps=fps)
    consistency = calculate_temporal_consistency(trajectory)
    left = [i for i, n in enumerate(schema.keypoint_names)
            if n.startswith("left")]
    right = [i for i, n in enumerate(schema.keypoint_names)
             if n.startswith("right")]
    asym = asymmetry_score(trajectory, left, right) if left and right else 0.0

    fig, axes = plt.subplots(2, 2, figsize=(14, 10))

    ax = axes[0, 0]
    for k in range(schema.num_keypoints):
        ax.plot(trajectory[:, k, 0], trajectory[:, k, 1], alpha=0.6)
    ax.invert_yaxis()
    ax.set_title("Joint trajectories")

    ax = axes[0, 1]
    t = np.arange(len(scores)) / fps
    for k in range(scores.shape[1]):
        ax.plot(t, scores[:, k], alpha=0.5)
    ax.set_title("Confidence over time")
    ax.set_xlabel("time (s)")

    ax = axes[1, 0]
    names = [n.replace("_", "\n") for n in schema.keypoint_names]
    ax.bar(range(len(names)), stats["amplitude"])
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, fontsize=6)
    ax.set_title("Movement amplitude (px)")

    ax = axes[1, 1]
    ax.bar(range(len(names)), stats["mean_velocity"])
    ax.set_xticks(range(len(names)))
    ax.set_xticklabels(names, fontsize=6)
    ax.set_title("Mean velocity (px/s)")

    asym_thr = getattr(cfg_clinical, "asymmetry_threshold", 0.3)
    act_thr = getattr(cfg_clinical, "low_activity_threshold", 5.0)
    flags = []
    if asym > asym_thr:
        flags.append(f"ASYMMETRY {asym:.2f} > {asym_thr}")
    if stats["overall_amplitude"] < act_thr:
        flags.append(f"LOW ACTIVITY {stats['overall_amplitude']:.1f} px")
    fig.suptitle(
        f"Clinical report — amplitude {stats['overall_amplitude']:.1f} px, "
        f"asymmetry {asym:.3f}, temporal consistency {consistency:.3f}"
        + (f"  [{' | '.join(flags)}]" if flags else ""))
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_pseudo_3d_pose(keypoints: np.ndarray,
                        scores: Optional[np.ndarray] = None,
                        schema: KeypointSchema = INFANT13,
                        out_path: Optional[str] = None):
    """Pseudo-3D pose plot: confidence as the z axis
    (ref visualization.py pseudo-3D plot)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    z = scores if scores is not None else np.ones(len(keypoints))
    fig = plt.figure(figsize=(7, 6))
    ax = fig.add_subplot(projection="3d")
    ax.scatter(keypoints[:, 0], keypoints[:, 1], z, c=z, cmap="viridis")
    for (i, j) in schema.skeleton:
        ax.plot([keypoints[i, 0], keypoints[j, 0]],
                [keypoints[i, 1], keypoints[j, 1]],
                [z[i], z[j]], alpha=0.6)
    ax.invert_yaxis()
    ax.set_zlabel("confidence")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_joint_position_heatmaps(trajectory: np.ndarray,
                                 schema: KeypointSchema = INFANT13,
                                 bins: int = 24,
                                 out_path: Optional[str] = None):
    """Per-joint 2D position-density heatmaps over a trajectory
    (ref visualization.py per-joint position heatmaps)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    K = schema.num_keypoints
    cols = 5
    rows = -(-K // cols)
    fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 2.6 * rows))
    for k in range(K):
        ax = axes.flat[k]
        ax.hist2d(trajectory[:, k, 0], trajectory[:, k, 1], bins=bins)
        ax.invert_yaxis()
        ax.set_title(schema.keypoint_names[k], fontsize=8)
    for k in range(K, rows * cols):
        axes.flat[k].axis("off")
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def plot_confidence_over_time(scores: np.ndarray, fps: float = 30.0,
                              schema: KeypointSchema = INFANT13,
                              out_path: Optional[str] = None):
    """Per-joint confidence timelines (ref visualization.py)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    fig, ax = plt.subplots(figsize=(9, 4))
    t = np.arange(len(scores)) / fps
    for k in range(scores.shape[1]):
        ax.plot(t, scores[:, k], label=schema.keypoint_names[k], alpha=0.6)
    ax.set_xlabel("time (s)")
    ax.set_ylabel("confidence")
    ax.legend(fontsize=6, ncol=3)
    if out_path:
        fig.savefig(out_path, dpi=120, bbox_inches="tight")
        plt.close(fig)
    return fig


def create_video_with_pose(video_path: str, trajectory: np.ndarray,
                           scores: np.ndarray, out_path: str,
                           schema: KeypointSchema = INFANT13,
                           fps: float = 30.0, trail_len: int = 20,
                           max_frames: Optional[int] = None) -> None:
    """Overlay skeleton + wrist motion trails onto a video
    (ref visualization.py:292-347)."""
    import cv2

    wrists = [i for i, n in enumerate(schema.keypoint_names)
              if "wrist" in n]
    cap = cv2.VideoCapture(video_path)
    w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(out_path, cv2.VideoWriter_fourcc(*"mp4v"),
                             fps, (w, h))
    t = 0
    while t < len(trajectory):
        ok, frame = cap.read()
        if not ok or (max_frames and t >= max_frames):
            break
        frame = draw_skeleton(frame, trajectory[t], scores[t], schema)
        for k in wrists:
            start = max(0, t - trail_len)
            pts = np.round(trajectory[start:t + 1, k]).astype(int)
            for a, b in zip(pts[:-1], pts[1:]):
                cv2.line(frame, tuple(a), tuple(b), keypoint_color(k), 2)
        writer.write(frame)
        t += 1
    writer.release()
    cap.release()
