"""Experiment metric logging: the file leg of the JAX package's
``MetricLogger`` (``mmidet_tpu/utils/logger.py``).

``log_metrics(step, {...})`` appends one JSON line to
``<log_dir>/metrics.jsonl``, the record the trainer keeps beside its
``results.txt``.  The JAX package's TensorBoard and W&B legs are absent on
the card's machine and are not taken (W&B is ROADMAP A15).
"""

from __future__ import annotations

import json
import os
import time


class MetricLogger:
    def __init__(self, log_dir: str):
        os.makedirs(log_dir, exist_ok=True)
        self.log_dir = log_dir
        self._jsonl = open(os.path.join(log_dir, "metrics.jsonl"), "a")

    def log_metrics(self, step: int, metrics: dict) -> None:
        rec = {"step": int(step), "time": time.time(),
               **{k: float(v) for k, v in metrics.items()}}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()

    def close(self) -> None:
        self._jsonl.close()
