"""Per-role scalar writers (the JAX package's ``utils/tensorboard_utils.py``):
JSONL scalar files in the layout of its tensorboard streams. The
tensorboardX writer is not ported."""

from __future__ import annotations

import json
import os
from typing import Any, Dict, Tuple


class _JsonlWriter:
    def __init__(self, path: str):
        os.makedirs(path, exist_ok=True)
        self._f = open(os.path.join(path, "scalars.jsonl"), "a")

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        self._f.write(json.dumps({"tag": tag, "value": float(value),
                                  "step": step}))
        self._f.write("\n")

    def close(self) -> None:
        self._f.close()


class TensorboardSummaryWriter:
    """One writer per metric_role stream, scalars tagged by metric name."""

    def __init__(self, output_path: str):
        self.output_path = output_path
        self.writers: Dict[str, Any] = {}

    def _ensure_writer_exists(self, name: str) -> None:
        if name not in self.writers:
            self.writers[name] = _JsonlWriter(
                os.path.join(self.output_path, name))

    def save_to_tensorboard(self, results: Dict[Tuple[str, str], float],
                            n_epoch: int) -> None:
        for (role, metric), value in results.items():
            metric_with_role = "_".join([metric, role])
            self._ensure_writer_exists(metric_with_role)
            self.writers[metric_with_role].add_scalar(metric, value, n_epoch)

    def close_all_writers(self) -> None:
        for writer in self.writers.values():
            writer.close()
