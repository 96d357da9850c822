"""Scalar metrics writer: TensorBoard if available, JSONL always.

The port's copy of ``pnode_tpu/utils/metrics.py``. The trainers log
Train/Loss, gradient norms and the like to TensorBoard where
``torch.utils.tensorboard`` imports, and every scalar is also appended to
``metrics.jsonl`` in the log directory, machine-readable for sweep
aggregation.
"""

from __future__ import annotations

import json
import os
import time


class MetricsWriter:
    def __init__(self, logdir: str, use_tensorboard: bool = True):
        os.makedirs(logdir, exist_ok=True)
        self._jsonl = open(os.path.join(logdir, "metrics.jsonl"), "a")
        self._tb = None
        if use_tensorboard:
            try:
                from torch.utils.tensorboard import SummaryWriter  # type: ignore

                self._tb = SummaryWriter(logdir)
            except Exception:
                self._tb = None

    def add_scalar(self, tag: str, value: float, step: int) -> None:
        rec = {"tag": tag, "value": float(value), "step": int(step), "ts": time.time()}
        self._jsonl.write(json.dumps(rec) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
