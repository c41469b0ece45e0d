"""Checkpoints of a TrainState with the reference's latest / best /
periodic policy.

Port of infantposeestimation_gaussianbias_tpu/train/checkpoint.py, with
the JAX package's policy and file names: ``latest`` every
``latest_interval`` epochs, ``best`` when the monitored metric improves,
``epoch_N`` every ``save_every`` epochs, each beside a ``<name>.meta.json``
sidecar that holds the epoch, the running best (so a resumed run keeps
protecting ``best``) and the epoch's metrics.  A checkpoint is one
``torch.save`` of {model state dict, optimizer state dict, step}, written
to a temporary file and renamed over the old one, so a reader never sees
half a file.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .state import TrainState


class CheckpointManager:
    """latest / best / every-N checkpoints of a TrainState in
    ``directory``."""

    def __init__(self, directory: str, save_every: int = 10):
        self.directory = os.path.abspath(directory)
        self.save_every = save_every
        os.makedirs(self.directory, exist_ok=True)

    def _path(self, name: str) -> str:
        return os.path.join(self.directory, name)

    def _save(self, name: str, state: TrainState,
              metadata: Dict[str, Any]) -> None:
        path = self._path(name)
        tmp = f"{path}.tmp{os.getpid()}"
        torch.save({"model": state.model.state_dict(),
                    "optimizer": state.optimizer.state_dict(),
                    "step": int(state.step)}, tmp)
        os.replace(tmp, path)
        with open(tmp, "w") as f:
            json.dump({k: float(v) for k, v in metadata.items()}, f)
        os.replace(tmp, path + ".meta.json")

    def save(self, state: TrainState, epoch: int, metrics: Dict[str, float],
             best_metric: float, monitor: str = "AP",
             latest_interval: int = 1) -> Tuple[float, bool]:
        """Apply the latest / best / periodic policy after ``epoch``;
        returns (best, is_best)."""
        current = float(metrics.get(monitor, -np.inf))
        is_best = current > best_metric
        if is_best:
            best_metric = current
        # the running best, clamped: -inf is not valid JSON
        meta = {"epoch": epoch, "best": float(max(best_metric, -1e30)),
                **{k: float(v) for k, v in metrics.items()}}
        if latest_interval and (epoch + 1) % latest_interval == 0:
            self._save("latest", state, meta)
        if is_best:
            self._save("best", state, meta)
        if self.save_every and (epoch + 1) % self.save_every == 0:
            self._save(f"epoch_{epoch + 1}", state, meta)
        return best_metric, is_best

    def save_interrupt(self, state: TrainState, last_completed_epoch: int,
                       best_metric: float) -> None:
        """Preemption save (SIGTERM): ``latest`` stamped with the last
        COMPLETED epoch, so a resume replays the interrupted epoch from its
        start (the loader is deterministic in (seed, epoch, index)); the
        step count keeps the steps already taken in it."""
        self._save("latest", state,
                   {"epoch": last_completed_epoch,
                    "best": float(max(best_metric, -1e30)),
                    "preempted": 1.0})

    def restore(self, state: TrainState, name: str = "latest"
                ) -> Tuple[TrainState, Optional[Dict[str, float]]]:
        """Load checkpoint ``name`` into ``state`` (model, optimizer, step)
        in place; returns (state, metadata), or (state, None) when there
        is no such checkpoint."""
        path = self._path(name)
        if not os.path.exists(path):
            return state, None
        device = next(state.model.parameters()).device
        ckpt = torch.load(path, map_location=device, weights_only=True)
        state.model.load_state_dict(ckpt["model"], strict=True)
        state.optimizer.load_state_dict(ckpt["optimizer"])
        state.step = int(ckpt["step"])
        meta = None
        if os.path.exists(path + ".meta.json"):
            with open(path + ".meta.json") as f:
                meta = json.load(f)
        return state, meta
