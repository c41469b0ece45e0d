"""Scalar metrics writer: JSONL always, TensorBoard where importable.

Port of infantposeestimation_gaussianbias_tpu/train/logging.py: the
reference's scalar contract (total loss, lr, each loss term, validation
loss and AP) as one JSON line per write in ``<log_dir>/metrics.jsonl``,
and the same scalars to TensorBoard when ``torch.utils.tensorboard``
imports.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict


class MetricsWriter:
    def __init__(self, log_dir: str, filename: str = "metrics.jsonl"):
        os.makedirs(log_dir, exist_ok=True)
        self.path = os.path.join(log_dir, filename)
        self._file = open(self.path, "a")
        self._tb = None
        try:  # optional TensorBoard backend
            from torch.utils.tensorboard import SummaryWriter
        except ImportError:
            pass
        else:
            self._tb = SummaryWriter(log_dir)

    def write(self, step: int, scalars: Dict[str, float],
              prefix: str = "") -> None:
        record = {"step": int(step), "time": time.time()}
        for k, v in scalars.items():
            key = f"{prefix}{k}" if prefix else k
            record[key] = float(v)
            if self._tb is not None:
                self._tb.add_scalar(key, float(v), int(step))
        self._file.write(json.dumps(record) + "\n")
        self._file.flush()

    def close(self) -> None:
        self._file.close()
        if self._tb is not None:
            self._tb.close()
