"""Trainer helpers: the port's own copies of the JAX package's
``RunningAverageMeter`` (``pnode_tpu/utils/meters.py``), ``makedirs``
(``pnode_tpu/utils/logging.py``) and ``MetricsWriter``
(``pnode_tpu/utils/metrics.py``, in ``metrics.py``)."""

from __future__ import annotations

import os

from .metrics import MetricsWriter


class RunningAverageMeter:
    """Tracks an exponential moving average of a scalar."""

    def __init__(self, momentum: float = 0.99):
        self.momentum = momentum
        self.reset()

    def reset(self):
        self.val = None
        self.avg = 0.0

    def update(self, val: float):
        if self.val is None:
            self.avg = float(val)
        else:
            self.avg = self.avg * self.momentum + float(val) * (1 - self.momentum)
        self.val = float(val)


def makedirs(dirname: str) -> None:
    os.makedirs(dirname, exist_ok=True)


__all__ = ["RunningAverageMeter", "makedirs", "MetricsWriter"]
