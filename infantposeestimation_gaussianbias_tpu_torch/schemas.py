"""Keypoint schemas: COCO-17 person and 13-joint preterm-infant skeletons.

The port's own copy of the schemas in
infantposeestimation_gaussianbias_tpu/schemas.py (the same names, flip
pairs, skeleton edges and OKS sigmas; tests/test_torch_config.py holds the
two equal), so that the port imports nothing of the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class KeypointSchema:
    """Declarative description of one keypoint convention."""

    name: str
    keypoint_names: Tuple[str, ...]
    # Index pairs swapped under horizontal flip (left/right symmetric joints).
    flip_pairs: Tuple[Tuple[int, int], ...]
    # Skeleton edges for the spatial-overlap loss term and visualization.
    skeleton: Tuple[Tuple[int, int], ...]
    # Per-keypoint OKS falloff constants (COCO convention).
    oks_sigmas: Tuple[float, ...]
    # Keypoint indices making up the "upper body" for half-body augmentation.
    upper_body: Tuple[int, ...]
    lower_body: Tuple[int, ...]

    @property
    def num_keypoints(self) -> int:
        return len(self.keypoint_names)

    def flip_index(self) -> np.ndarray:
        """Permutation that maps keypoint k to its mirror joint."""
        idx = np.arange(self.num_keypoints)
        for a, b in self.flip_pairs:
            idx[a], idx[b] = b, a
        return idx

    def oks_sigma_array(self) -> np.ndarray:
        return np.asarray(self.oks_sigmas, dtype=np.float32)

    def skeleton_array(self) -> np.ndarray:
        return np.asarray(self.skeleton, dtype=np.int32)


# COCO-17 person keypoints, as the reference's configs/config.py:33-43
# (names, flip pairs), models/fusion_head.py:389-394 (skeleton) and
# utils/metrics.py:20-38 (OKS sigmas).
COCO17 = KeypointSchema(
    name="coco17",
    keypoint_names=(
        "nose", "left_eye", "right_eye", "left_ear", "right_ear",
        "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
        "left_wrist", "right_wrist", "left_hip", "right_hip",
        "left_knee", "right_knee", "left_ankle", "right_ankle",
    ),
    flip_pairs=((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12),
                (13, 14), (15, 16)),
    skeleton=(
        (0, 1), (0, 2), (1, 3), (2, 4),                  # head
        (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),         # arms
        (5, 11), (6, 12), (11, 12),                       # torso
        (11, 13), (13, 15), (12, 14), (14, 16),           # legs
    ),
    oks_sigmas=(0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072,
                0.072, 0.062, 0.062, 0.107, 0.107, 0.087, 0.087, 0.089,
                0.089),
    upper_body=(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
    lower_body=(11, 12, 13, 14, 15, 16),
)


# 13-joint preterm-infant skeleton (COCO-17 minus knees and ankles), as the
# reference's visualization.py:12-30.  OKS sigmas reuse the COCO values.
INFANT13 = KeypointSchema(
    name="infant13",
    keypoint_names=(
        "nose", "left_eye", "right_eye", "left_ear", "right_ear",
        "left_shoulder", "right_shoulder", "left_elbow", "right_elbow",
        "left_wrist", "right_wrist", "left_hip", "right_hip",
    ),
    flip_pairs=((1, 2), (3, 4), (5, 6), (7, 8), (9, 10), (11, 12)),
    skeleton=(
        (0, 1), (0, 2), (1, 3), (2, 4),
        (5, 6), (5, 7), (7, 9), (6, 8), (8, 10),
        (5, 11), (6, 12), (11, 12),
    ),
    oks_sigmas=(0.026, 0.025, 0.025, 0.035, 0.035, 0.079, 0.079, 0.072,
                0.072, 0.062, 0.062, 0.107, 0.107),
    upper_body=(0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10),
    lower_body=(11, 12),
)


SCHEMAS: Dict[str, KeypointSchema] = {s.name: s for s in (COCO17, INFANT13)}


def get_schema(name: str) -> KeypointSchema:
    try:
        return SCHEMAS[name]
    except KeyError:
        raise KeyError(
            f"Unknown keypoint schema {name!r}; known: {sorted(SCHEMAS)}"
        ) from None


def schema_from_category(cat: dict, name: str | None = None,
                         default_sigma: float = 0.05) -> KeypointSchema:
    """Build a schema from a COCO category dict: the
    arbitrary-K capability of the reference's
    analysis/extended_dataset_loader.py:15-341.

    Flip pairs are inferred from left_/right_ name symmetry; upper/lower
    body from name heuristics; OKS sigmas default to ``default_sigma`` for
    keypoints without a COCO-known value.
    """
    names = tuple(cat["keypoints"])
    known = dict(zip(COCO17.keypoint_names, COCO17.oks_sigmas))
    sigmas = tuple(known.get(n, default_sigma) for n in names)

    idx = {n: i for i, n in enumerate(names)}
    pairs = []
    for n, i in idx.items():
        if n.startswith("left_"):
            mirror = "right_" + n[len("left_"):]
            if mirror in idx:
                pairs.append((i, idx[mirror]))
        elif n.startswith("left"):
            mirror = "right" + n[len("left"):]
            if mirror in idx:
                pairs.append((i, idx[mirror]))

    lower_words = ("hip", "knee", "ankle", "foot", "heel", "toe", "leg")
    lower = tuple(i for i, n in enumerate(names)
                  if any(w in n for w in lower_words))
    upper = tuple(i for i in range(len(names)) if i not in lower)

    skeleton = tuple(tuple(int(v) for v in e)
                     for e in cat.get("skeleton", []))
    return KeypointSchema(
        name=name or cat.get("name", f"custom{len(names)}"),
        keypoint_names=names,
        flip_pairs=tuple(pairs),
        skeleton=skeleton,
        oks_sigmas=sigmas,
        upper_body=upper,
        lower_body=lower,
    )
